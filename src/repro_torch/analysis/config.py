"""Audit scope and the port's constants (stdlib only).

The quarantine list says which modules are inert scaffolding rather than
live solver code, by the reference's roles: the LM scaffolding, the
unused optimiser and the test-only oracle.  The lint layer skips them,
so findings are signal.  The reference's ruff exclude list
(pyproject.toml) names the reference's modules only; README says so.
"""
from __future__ import annotations

import pathlib

#: Repo root (…/src/repro_torch/analysis/config.py -> repo).
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

#: The package root the lint layer reads.
PACKAGE = "src/repro_torch"

#: Inert scaffolding, excluded from the audit.  `kernels/ref.py` is the
#: naive SDCA oracle of the tests (nothing in the port imports it);
#: `optim/lbfgs.py` is the Fig 6 baseline, as the reference's is.
QUARANTINE = (
    "src/repro_torch/models",
    "src/repro_torch/configs",
    "src/repro_torch/launch/serve.py",
    "src/repro_torch/launch/steps.py",
    "src/repro_torch/kernels/flash_attention.py",
    "src/repro_torch/kernels/rglru.py",
    "src/repro_torch/kernels/ref.py",
    "src/repro_torch/optim/lbfgs.py",
)

#: Where live python sources are discovered for the repo-wide lint
#: rules.  Tests, tools and examples are out of scope.
LINT_ROOTS = (PACKAGE,)

#: The only files allowed to call torch.distributed collectives
#: (LINT-RAW-COLLECTIVE), each call on a marked line.
COLLECTIVE_SCOPED_FILES = (
    "src/repro_torch/core/engine.py",
    "src/repro_torch/launch/mesh.py",
    "src/repro_torch/resilience/journal.py",
)

#: The marker a collective call line (or the line above it) carries,
#: with a short justification after it:
#:     dist.barrier()  # audit: collective-ok journal records are complete
ALLOWLIST_MARKER = "audit: collective-ok"

#: torch.distributed attribute names that count as collectives.
COLLECTIVE_CALL_NAMES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "reduce", "broadcast", "barrier", "gather", "scatter", "send",
    "recv", "isend", "irecv",
})

#: The names the torch.distributed module goes by in the port
#: (`import torch.distributed as dist`, or spelled out).
DIST_MODULE_NAMES = (("dist",), ("torch", "distributed"))

#: The marker an error-swallowing broad except handler carries
#: (LINT-BARE-EXCEPT), on the ``except`` line or the line above.
EXCEPT_MARKER = "audit: except-ok"

#: Files that each call raise_on_duplicate_nonzeros (LINT-CSR-ENTRY).
CSR_ENTRY_FILES = (
    "src/repro_torch/kernels/ops.py",
    "src/repro_torch/api/session.py",
)
CSR_CHECK_NAME = "raise_on_duplicate_nonzeros"

#: The kernel registry, its CUDA sources and the python files that load
#: them (LINT-KERNEL-CONTRACT).
CONTRACTS_FILE = "src/repro_torch/kernels/contracts.py"
KERNELS_DIR = "src/repro_torch/kernels"
CSRC_DIR = "src/repro_torch/kernels/csrc"
#: `sdca_bucket.c_entry(stem, argtypes, entry="")` loads ``entry`` (by
#: default ``<stem>_launch``) from ``csrc/<stem>.cu``.
C_ENTRY_HELPER = "c_entry"
#: Words the comment above a contract without a shared-memory model
#: must hold: its shared memory has a static size.
SMEM_STATIC_WORDS = ("static", "shared memory")

# --- trace-layer op sets ------------------------------------------------

#: Collectives whose ReduceOp.SUM on a floating tensor reorders sums
#: (TORCH-SUM-EXCHANGE under deterministic=True).
SUM_REDUCE_CALLS = frozenset({
    "all_reduce", "reduce", "reduce_scatter", "reduce_scatter_tensor",
})

#: aten ops that accumulate into indexed positions: atomics on the card
#: outside the deterministic mode, which refuses or replaces them
#: (TORCH-NONDET-OP on a floating tensor).  ``index_put`` counts only
#: with accumulate=True.
ACCUMULATE_OPS = frozenset({
    "index_add", "scatter_add", "scatter_reduce", "index_reduce", "put",
    "index_put", "_index_put_impl",
})


def is_quarantined(path) -> bool:
    """True when `path` (absolute or repo-relative) is scaffolding."""
    p = pathlib.Path(path)
    if p.is_absolute():
        try:
            p = p.relative_to(REPO_ROOT)
        except ValueError:
            return False
    s = str(p)
    return any(s == q or s.startswith(q + "/") for q in QUARANTINE)
