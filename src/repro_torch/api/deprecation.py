"""The one deprecation seam for the legacy entry points.

Every legacy training entry point of the port (`core.GLMTrainer`,
`core.StreamedGLMTrainer`, `core.fit_dataset`, `core.cocoa.epoch_sim*`)
funnels its warning through `warn_deprecated`, so tests can assert on
one warning class (`ReproDeprecationWarning`, exported from
`repro_torch.api`).

The class subclasses `DeprecationWarning`, so standard tooling
(`-W error::DeprecationWarning`, pytest `filterwarnings`) sees it, and
each (old, new) pair is warned at most once per process to keep shim
call sites (benchmark loops, epoch-per-call wrappers) quiet.
"""
from __future__ import annotations

import warnings

__all__ = ["ReproDeprecationWarning", "warn_deprecated",
           "reset_deprecation_registry"]


class ReproDeprecationWarning(DeprecationWarning):
    """A legacy training entry point was used."""


_seen: set[tuple[str, str]] = set()


def warn_deprecated(old: str, replacement: str, *,
                    stacklevel: int = 3) -> None:
    """Warn (once per process per pair) that `old` should become
    `replacement`."""
    key = (old, replacement)
    if key in _seen:
        return
    _seen.add(key)
    warnings.warn(
        f"{old} is deprecated; use {replacement} instead "
        "(see DESIGN.md S10 for the migration map)",
        ReproDeprecationWarning, stacklevel=stacklevel)


def reset_deprecation_registry() -> None:
    """Forget which warnings fired (tests use this to re-assert)."""
    _seen.clear()
