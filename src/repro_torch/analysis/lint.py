"""The lint layer: repo-specific AST rules that ruff cannot express.

Every checker works on ``(repo-relative path, source)`` pairs, so the
mutation self-tests feed synthesized sources through the production
code paths without touching the tree.  Stdlib only: the kernel
registry is read from `kernels/contracts.py`'s source with
`ast.literal_eval`, and only `resolve_contract_refs` (the import check
of its ``"module:attr"`` references) imports the port.

Rules (registry: `analysis.rules`):

* LINT-KERNEL-CONTRACT — every ``extern "C"`` entry of ``csrc/*.cu``
  and every entry `kernels/*.py` loads is registered, every registered
  source exists and exports its entry, and a contract without a
  shared-memory model says in its comment that the size is static.
* LINT-RAW-COLLECTIVE — torch.distributed collectives only in the
  scoped files, each on a ``# audit: collective-ok`` line.
* LINT-UNSEEDED-RNG — no global-state draw (numpy, stdlib ``random``,
  ``torch.manual_seed``, a torch sampler without ``generator=``).
* LINT-CSR-ENTRY — each CSR entry altitude still calls
  ``raise_on_duplicate_nonzeros``.
* LINT-BARE-EXCEPT — no bare ``except:`` and no error-swallowing
  ``except Exception`` without the ``# audit: except-ok`` marker.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable, Mapping, Optional

from . import config, rules
from .rules import Finding

__all__ = ["run_lint", "default_sources", "default_csrc",
           "load_contracts", "check_kernel_contracts",
           "check_collective_markers", "check_unseeded_rng",
           "check_csr_entries", "check_bare_except",
           "resolve_contract_refs"]

#: numpy.random attributes that are explicitly seeded constructors
#: (everything else on np.random is the legacy global-state API).
_SEEDED_RNG_OK = frozenset({
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
    "MT19937", "BitGenerator",
})
#: torch samplers that draw from the global generator unless given one.
_TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
})
_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
})
_GLOBAL_SEEDS = frozenset({"manual_seed", "manual_seed_all", "seed",
                           "seed_all"})
_EXTERN_C = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')


def default_sources() -> dict[str, str]:
    """The live sources: every .py under `config.LINT_ROOTS` that is not
    quarantined, as {repo-relative path: source}."""
    out: dict[str, str] = {}
    for root in config.LINT_ROOTS:
        for p in sorted((config.REPO_ROOT / root).rglob("*.py")):
            rel = str(p.relative_to(config.REPO_ROOT))
            if not config.is_quarantined(rel):
                out[rel] = p.read_text()
    return out


def default_csrc() -> dict[str, str]:
    """{file name: source} of every CUDA source in `config.CSRC_DIR`."""
    base = config.REPO_ROOT / config.CSRC_DIR
    return {p.name: p.read_text() for p in sorted(base.glob("*.cu"))}


def _parse(path: str, source: str) -> Optional[ast.Module]:
    try:
        return ast.parse(source, filename=path)
    except SyntaxError:
        return None


def _attr_chain(node: ast.AST) -> list[str]:
    """x.y.z -> ["x", "y", "z"] (empty when not a plain name chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _marked(lines: list[str], ln: int, marker: str) -> bool:
    """Whether line `ln` (1-based) or the line above carries `marker`."""
    return any(marker in s for s in lines[max(ln - 2, 0):ln])


def _const(node) -> Optional[str]:
    return node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else None


# --- LINT-KERNEL-CONTRACT -------------------------------------------------


def load_contracts(source: str) -> tuple[dict, dict[str, str]]:
    """(KERNEL_CONTRACTS, {key: the comment block above the key}) read
    from `kernels/contracts.py`'s source without importing it."""
    tree = ast.parse(source)
    lines = source.splitlines()
    for node in tree.body:
        target = getattr(node, "target", None) or (
            node.targets[0] if isinstance(node, ast.Assign) else None)
        if getattr(target, "id", None) != "KERNEL_CONTRACTS":
            continue
        contracts = ast.literal_eval(node.value)
        comments = {}
        for key in node.value.keys:
            block, ln = [], key.lineno - 2
            while ln >= 0 and lines[ln].strip().startswith("#"):
                block.insert(0, lines[ln].strip().lstrip("# "))
                ln -= 1
            comments[key.value] = " ".join(block)
        return contracts, comments
    raise ValueError("kernels/contracts.py defines no KERNEL_CONTRACTS")


def _loaded_entries(path: str, source: str) -> tuple[list, list[Finding]]:
    """[(stem, entry, line)] of one kernels/*.py file: every
    ``build.load("stem").entry`` and ``c_entry("stem", ..., entry)``."""
    tree = _parse(path, source)
    if tree is None:
        return [], []
    out, found = [], []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Call)
                and _attr_chain(node.value.func)[-1:] == ["load"]):
            stem = _const(node.value.args[0]) if node.value.args else None
            if stem is not None:
                out.append((stem, node.attr, node.lineno))
                continue
        elif (isinstance(node, ast.Call) and _attr_chain(node.func)[-1:]
              == [config.C_ENTRY_HELPER]):
            stem = _const(node.args[0]) if node.args else None
            entry = _const(node.args[2]) if len(node.args) > 2 else None
            for kw in node.keywords:
                if kw.arg == "entry":
                    entry = _const(kw.value)
            if stem is not None:
                out.append((stem, entry or f"{stem}_launch", node.lineno))
                continue
        else:
            continue
        found.append(Finding(
            rules.LINT_KERNEL_CONTRACT,
            "a kernel entry is loaded through a name that is not a "
            "string literal; the registry cannot be checked against it",
            where=f"{path}:{node.lineno}"))
    return out, found


def check_kernel_contracts(sources: Mapping[str, str],
                           csrc: Mapping[str, str],
                           contracts: Mapping[str, Mapping],
                           comments: Mapping[str, str]) -> list[Finding]:
    """LINT-KERNEL-CONTRACT over the CUDA sources `csrc` ({file name:
    text}) and the live kernels/*.py files among `sources`."""
    found: list[Finding] = []
    where_reg = f"{config.CONTRACTS_FILE}:1"
    registered = {}
    for key, c in contracts.items():
        src = pathlib.PurePosixPath(c.get("source", "")).name
        registered[(pathlib.PurePosixPath(src).stem, c.get("entry"))] = key
        if src not in csrc:
            found.append(Finding(
                rules.LINT_KERNEL_CONTRACT,
                f"KERNEL_CONTRACTS[{key!r}] names source "
                f"{c.get('source')!r}, which is not in {config.CSRC_DIR}",
                where=where_reg))
        elif c.get("entry") not in _EXTERN_C.findall(csrc[src]):
            found.append(Finding(
                rules.LINT_KERNEL_CONTRACT,
                f"KERNEL_CONTRACTS[{key!r}] names entry {c.get('entry')!r}"
                f", which {src} does not export as extern \"C\"",
                where=where_reg))
        if c.get("smem_estimate") is None and not all(
                w in comments.get(key, "").lower()
                for w in config.SMEM_STATIC_WORDS):
            found.append(Finding(
                rules.LINT_KERNEL_CONTRACT,
                f"KERNEL_CONTRACTS[{key!r}] has no shared-memory model "
                f"and its comment does not say that its shared memory has "
                f"a static size",
                where=where_reg))
    for name, text in csrc.items():
        stem = pathlib.PurePosixPath(name).stem
        for entry in _EXTERN_C.findall(text):
            if (stem, entry) not in registered:
                line = text[:text.find(entry)].count("\n") + 1
                found.append(Finding(
                    rules.LINT_KERNEL_CONTRACT,
                    f"extern \"C\" entry {entry!r} of {name} is not "
                    f"registered in kernels/contracts.py KERNEL_CONTRACTS",
                    where=f"{config.CSRC_DIR}/{name}:{line}"))
    for path, src in sources.items():
        if str(pathlib.PurePosixPath(path).parent) != config.KERNELS_DIR:
            continue
        loaded, bad = _loaded_entries(path, src)
        found += bad
        for stem, entry, ln in loaded:
            if (stem, entry) not in registered:
                found.append(Finding(
                    rules.LINT_KERNEL_CONTRACT,
                    f"{path} loads {entry!r} from csrc/{stem}.cu, which "
                    f"no contract in kernels/contracts.py registers",
                    where=f"{path}:{ln}"))
    return found


def resolve_contract_refs(contracts: Mapping[str, Mapping],
                          ) -> list[Finding]:
    """Import-check every ``"module:attr"`` reference of the registry
    (imports the port, and with it torch)."""
    import importlib
    found: list[Finding] = []
    for key, entry in contracts.items():
        for field in ("misfit", "smem_estimate"):
            ref = entry.get(field)
            if ref is None:
                continue
            mod, _, attr = ref.partition(":")
            try:
                fn = getattr(importlib.import_module(mod), attr)
                if not callable(fn):
                    raise TypeError(f"{ref} is not callable")
            # audit: except-ok a broken reference IS the reported finding
            except Exception as e:
                found.append(Finding(
                    rules.LINT_KERNEL_CONTRACT,
                    f"KERNEL_CONTRACTS[{key!r}].{field} = {ref!r} does "
                    f"not resolve: {type(e).__name__}: {e}",
                    where=f"{config.CONTRACTS_FILE}:1"))
    return found


# --- LINT-RAW-COLLECTIVE --------------------------------------------------


def _dist_names(tree: ast.Module) -> set[tuple[str, ...]]:
    """Name chains bound to torch.distributed in one module."""
    names = set(config.DIST_MODULE_NAMES)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    names.add((a.asname,))
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    names.add((a.asname or a.name,))
    return names


def check_collective_markers(path: str, source: str) -> list[Finding]:
    """LINT-RAW-COLLECTIVE over one file: a torch.distributed collective
    outside `config.COLLECTIVE_SCOPED_FILES` is a finding; inside them
    its call line (or the line above) carries the marker."""
    tree = _parse(path, source)
    if tree is None:
        return []
    scoped = path in config.COLLECTIVE_SCOPED_FILES
    dist_names = _dist_names(tree)
    lines = source.splitlines()
    found: list[Finding] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom)
                and node.module == "torch.distributed"):
            for a in node.names:
                if a.name in config.COLLECTIVE_CALL_NAMES:
                    found.append(Finding(
                        rules.LINT_RAW_COLLECTIVE,
                        f"collective {a.name} imported by name from "
                        f"torch.distributed; call dist.{a.name} at a "
                        f"marked site of a scoped file",
                        where=f"{path}:{node.lineno}"))
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if (len(chain) < 2 or chain[-1] not in config.COLLECTIVE_CALL_NAMES
                or tuple(chain[:-1]) not in dist_names):
            continue
        ln = node.func.lineno
        if not scoped:
            found.append(Finding(
                rules.LINT_RAW_COLLECTIVE,
                f"torch.distributed.{chain[-1]} outside the collective-"
                f"scoped files ({', '.join(config.COLLECTIVE_SCOPED_FILES)})",
                where=f"{path}:{ln}"))
        elif not _marked(lines, ln, config.ALLOWLIST_MARKER):
            found.append(Finding(
                rules.LINT_RAW_COLLECTIVE,
                f"raw collective dist.{chain[-1]} without a "
                f"'# {config.ALLOWLIST_MARKER}' marker on the call line "
                f"or the line above",
                where=f"{path}:{ln}"))
    return found


# --- LINT-UNSEEDED-RNG ----------------------------------------------------


def check_unseeded_rng(path: str, source: str) -> list[Finding]:
    """LINT-UNSEEDED-RNG over one live file."""
    tree = _parse(path, source)
    if tree is None:
        return []
    found: list[Finding] = []

    def emit(msg: str, node) -> None:
        found.append(Finding(rules.LINT_UNSEEDED_RNG, msg,
                             where=f"{path}:{node.lineno}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "random" for a in node.names):
                emit("stdlib `import random` in live solver code; use "
                     "np.random.default_rng(seed) or a seeded "
                     "torch.Generator", node)
        elif isinstance(node, ast.ImportFrom) and node.module == "random":
            emit("stdlib `from random import ...` in live solver code; "
                 "use np.random.default_rng(seed)", node)
        elif isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            if (len(chain) == 3 and chain[0] in ("np", "numpy")
                    and chain[1] == "random"
                    and chain[2] not in _SEEDED_RNG_OK):
                emit(f"global-state numpy RNG np.random.{chain[2]}; use "
                     f"np.random.default_rng(seed)", node)
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            seeded = any(kw.arg == "generator" for kw in node.keywords)
            if chain[:1] == ["torch"] and chain[-1] in _GLOBAL_SEEDS:
                emit(f"{'.'.join(chain)} seeds torch's global generator; "
                     f"pass a seeded torch.Generator as generator=", node)
            elif (chain[:1] == ["torch"] and len(chain) == 2
                  and chain[1] in _TORCH_SAMPLERS and not seeded):
                emit(f"torch.{chain[1]} draws from the global generator; "
                     f"pass generator=", node)
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_SAMPLERS and not seeded):
                emit(f".{node.func.attr}() draws from the global "
                     f"generator; pass generator=", node)
    return found


# --- LINT-BARE-EXCEPT -----------------------------------------------------

#: exception names in an `except` clause that count as "broad".
_BROAD_EXC = frozenset({"Exception", "BaseException"})


def _broad_names(node: ast.AST) -> list[str]:
    """Broad exception-class names in an except clause's type."""
    if node is None:
        return []
    if isinstance(node, ast.Tuple):
        return [n for elt in node.elts for n in _broad_names(elt)]
    chain = _attr_chain(node)
    return [chain[-1]] if chain and chain[-1] in _BROAD_EXC else []


def check_bare_except(path: str, source: str) -> list[Finding]:
    """LINT-BARE-EXCEPT over one live file.

    Bare ``except:`` is always a finding.  ``except Exception`` /
    ``except BaseException`` (alone or in a tuple) is a finding when the
    handler has no ``raise`` (it swallows the error), unless the except
    line or the line above carries the ``# audit: except-ok`` marker.
    """
    tree = _parse(path, source)
    if tree is None:
        return []
    lines = source.splitlines()
    found: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        ln = node.lineno
        if node.type is None:
            found.append(Finding(
                rules.LINT_BARE_EXCEPT,
                "bare `except:` catches SystemExit/KeyboardInterrupt and "
                "the SimulatedCrash fault sentinel; name the exceptions "
                f"(or `except Exception` with a '# {config.EXCEPT_MARKER}'"
                " marker)", where=f"{path}:{ln}"))
            continue
        broad = _broad_names(node.type)
        if not broad or any(isinstance(sub, ast.Raise)
                            for sub in ast.walk(node)):
            continue
        if _marked(lines, ln, config.EXCEPT_MARKER):
            continue
        found.append(Finding(
            rules.LINT_BARE_EXCEPT,
            f"`except {broad[0]}` swallows the error (no raise in the "
            f"handler) without a '# {config.EXCEPT_MARKER}' marker on the "
            f"except line or the line above",
            where=f"{path}:{ln}"))
    return found


# --- LINT-CSR-ENTRY -------------------------------------------------------


def check_csr_entries(sources: Mapping[str, str]) -> list[Finding]:
    """LINT-CSR-ENTRY: each configured altitude file calls
    `raise_on_duplicate_nonzeros` at least once."""
    found: list[Finding] = []
    for path in config.CSR_ENTRY_FILES:
        src = sources.get(path)
        if src is None:
            continue                      # partial source sets (tests)
        tree = _parse(path, src)
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and _attr_chain(n.func)[-1:] == [config.CSR_CHECK_NAME]
                 ] if tree else []
        if not calls:
            found.append(Finding(
                rules.LINT_CSR_ENTRY,
                f"CSR entry altitude no longer calls "
                f"{config.CSR_CHECK_NAME}; the no-duplicate-nonzero "
                f"invariant is unenforced at this boundary",
                where=f"{path}:1"))
    return found


def run_lint(sources: Optional[Mapping[str, str]] = None, *,
             only: Optional[Iterable[str]] = None) -> list[Finding]:
    """Run every lint rule over the live tree (or injected sources).

    ``sources`` maps repo-relative paths to source text (default: the
    live tree per `config`); the kernel contracts are checked against
    the tree's CUDA sources and registry, whose ``"module:attr"``
    references are import-checked; ``only`` restricts to a subset of
    rule IDs.
    """
    sources = default_sources() if sources is None else dict(sources)
    want = set(only) if only is not None else None

    def on(rule: str) -> bool:
        return want is None or rule in want

    found: list[Finding] = []
    if on(rules.LINT_KERNEL_CONTRACT):
        contracts, comments = load_contracts(
            (config.REPO_ROOT / config.CONTRACTS_FILE).read_text())
        found += check_kernel_contracts(sources, default_csrc(), contracts,
                                        comments)
        found += resolve_contract_refs(contracts)
    for path, src in sources.items():
        if on(rules.LINT_RAW_COLLECTIVE):
            found += check_collective_markers(path, src)
        if on(rules.LINT_UNSEEDED_RNG):
            found += check_unseeded_rng(path, src)
        if on(rules.LINT_BARE_EXCEPT):
            found += check_bare_except(path, src)
    if on(rules.LINT_CSR_ENTRY):
        found += check_csr_entries(sources)
    return found
