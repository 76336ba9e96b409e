"""Mutation self-tests: prove every detector fires.

Each check injects one synthetic bug — a probe program for the trace
layer, a synthesized source for the lint layer, a forged plan for the
budget layer — runs it through the production checker, and asserts the
expected rule ID; where it makes sense, the corrected twin must pass (a
detector that fires on everything is as blind as one that fires on
nothing).  ``tools/audit_torch.py --selftest`` runs the checks of the
layers it audits, so a refactor that silences a detector fails the
audit instead of shipping a green but blind auditor.
"""
from __future__ import annotations

import textwrap
from typing import Callable, Iterable, Optional

from . import budget, config, lint, rules, trace

__all__ = ["run_selftests", "SELFTESTS", "SelfTestError", "SUM_PROBES",
           "GATE_PROBES"]


class SelfTestError(AssertionError):
    """One mutation was not detected (or a clean twin was flagged)."""


def _expect(findings, rule: str, ctx: str) -> None:
    got = [f.rule for f in findings]
    if rule not in got:
        raise SelfTestError(
            f"{ctx}: expected {rule} to fire, got {got or 'nothing'}")


def _expect_clean(findings, ctx: str) -> None:
    if findings:
        raise SelfTestError(f"{ctx}: expected no findings, got "
                            f"{[str(f) for f in findings]}")


def _live(path: str) -> str:
    return (config.REPO_ROOT / path).read_text()


# --- trace layer ----------------------------------------------------------


#: the trace probes: a "deterministic" sum by all_reduce and its
#: all-gather + ordered-sum twin; an index_add_ and its ordered twin
SUM_PROBES = (trace.SumCase("probe", "all_reduce"),
              trace.SumCase("probe", "all_gather"))
GATE_PROBES = ("probe-index-add", "probe-ordered")


def check_sum_exchange(device, got=None) -> None:
    """The all_reduce probe on 2 gloo ranks -> TORCH-SUM-EXCHANGE; its
    twin passes.  ``got``: `trace.sum_exchange` results that already
    hold `SUM_PROBES` (a caller that spawns ranks anyway)."""
    bad, good = SUM_PROBES
    if got is None:
        got = trace.sum_exchange(SUM_PROBES, device=device, world=2)
    _expect(got[bad.name], rules.TORCH_SUM_EXCHANGE, "all_reduce probe")
    _expect_clean(got[good.name], "all-gather + ordered-sum twin")


def check_nondet_op(device, got=None) -> None:
    """An index_add_ on the device under the deterministic mode ->
    TORCH-NONDET-OP; its ordered twin (one add an index, in order)
    passes.  ``got``: `trace.nondet_gate` results that already hold
    `GATE_PROBES`."""
    if got is None:
        got = trace.nondet_gate(GATE_PROBES, device=device)
    bad, good = (f"{p}/-" for p in GATE_PROBES)
    _expect(got[bad], rules.TORCH_NONDET_OP, "index_add_ probe")
    _expect_clean(got[good], "ordered twin")


# --- budget layer ---------------------------------------------------------


def check_plan_budget(device) -> None:
    """Forged plans -> SMEM-PLAN-BUDGET: a replicated sparse plan whose
    rows (65,536 nonzeros) put the chain's row of products above the
    opt-in even in the kernel's global layout, and a "kernel-sharded"
    plan on a topology without model lanes; an honestly routed plan of
    the same workload family passes."""
    from repro_torch.core.planner import (SolverPlan, Topology,
                                          WorkloadSignature, static_plan)
    del device
    topo = Topology(backend="cuda")
    wide = WorkloadSignature(n=4096, d=1 << 20, nnz=65_536, sparse=True,
                             name="selftest-forged")
    forged = SolverPlan(solver="kernel", route="kernel", bucket=16,
                        chunks=1, nnz_multiple=0, feature_shard=False)
    _expect(budget.audit_plan(wide, topo, forged), rules.SMEM_PLAN_BUDGET,
            "forged over-budget plan")
    narrow = WorkloadSignature(n=4096, d=1 << 20, nnz=40, sparse=True)
    sharded = SolverPlan(solver="kernel", route="kernel-sharded",
                         bucket=16, chunks=1, nnz_multiple=0,
                         feature_shard=True)
    _expect(budget.audit_plan(narrow, topo, sharded),
            rules.SMEM_PLAN_BUDGET, "kernel-sharded plan without lanes")
    honest = static_plan(narrow, topo, bucket=16)
    _expect_clean(budget.audit_plan(narrow, topo, honest),
                  f"honestly routed plan ({honest.route})")


# --- lint layer -----------------------------------------------------------

_ROGUE_CU = textwrap.dedent("""\
    extern "C" int rogue_launch(const float* x, int n, void* stream) {
      return 0;
    }
    """)

_ROGUE_LOADER = textwrap.dedent("""\
    from . import build
    from .sdca_bucket import c_entry

    def rogue(x):
        return build.load("rogue").rogue_launch(x)

    def other(x):
        return c_entry("sdca_bucket", "p", "sdca_bucket_other")(x)
    """)

_UNMARKED_COLLECTIVE = textwrap.dedent("""\
    import torch.distributed as dist

    def exchange(t, g):
        dist.all_reduce(t, group=g)
        dist.all_gather([t], t, group=g)  # audit: collective-ok test
        return t
    """)

_UNSEEDED_RNG = textwrap.dedent("""\
    import torch

    def jitter(shape, gen):
        good = torch.randn(shape, generator=gen)
        return good + torch.randn(shape)
    """)

_SWALLOWED_EXCEPT = textwrap.dedent("""\
    def load(path):
        try:
            return open(path).read()
        except Exception:
            pass
    """)

_MARKED_EXCEPT = textwrap.dedent("""\
    def load(path):
        try:
            return open(path).read()
        # audit: except-ok missing file means empty payload, by design
        except Exception:
            return None

    def narrow(path):
        try:
            return open(path).read()
        except Exception as e:
            raise RuntimeError(path) from e
    """)


def check_kernel_contract(device) -> None:
    """A synthesized extern "C" entry that is not registered, a kernels/
    module loading unregistered entries, and a contract without a
    shared-memory model or a comment saying its size is static ->
    LINT-KERNEL-CONTRACT; the live registry and sources stay clean."""
    del device
    csrc = lint.default_csrc()
    contracts, comments = lint.load_contracts(_live(config.CONTRACTS_FILE))
    _expect(lint.check_kernel_contracts(
        {}, {**csrc, "rogue.cu": _ROGUE_CU}, contracts, comments),
        rules.LINT_KERNEL_CONTRACT, "unregistered extern \"C\" entry")
    loader = f"{config.KERNELS_DIR}/rogue.py"
    got = lint.check_kernel_contracts({loader: _ROGUE_LOADER}, csrc,
                                      contracts, comments)
    if len(got) != 2:
        raise SelfTestError(f"two unregistered loads must fire, got "
                            f"{[str(f) for f in got]}")
    key = "sdca_bucket.sdca_bucket_kernel"
    bare = {**contracts, key: {**contracts[key], "smem_estimate": None}}
    _expect(lint.check_kernel_contracts({}, csrc, bare, comments),
            rules.LINT_KERNEL_CONTRACT, "contract without a smem model")
    live = {p: src for p, src in lint.default_sources().items()
            if p.startswith(config.KERNELS_DIR + "/")}
    _expect_clean(lint.check_kernel_contracts(live, csrc, contracts,
                                              comments),
                  "the live registry")


def check_raw_collective(device) -> None:
    """An unmarked dist.all_reduce in a collective-scoped file, and a
    marked one outside them -> LINT-RAW-COLLECTIVE; the marked
    all_gather of the scoped file passes."""
    del device
    scoped = config.COLLECTIVE_SCOPED_FILES[0]
    got = lint.check_collective_markers(scoped, _UNMARKED_COLLECTIVE)
    _expect(got, rules.LINT_RAW_COLLECTIVE, "unmarked dist.all_reduce")
    if len(got) != 1:
        raise SelfTestError(f"the marked all_gather must not be flagged; "
                            f"got {[str(f) for f in got]}")
    marked = _UNMARKED_COLLECTIVE.replace(
        "dist.all_reduce(t, group=g)",
        "dist.all_reduce(t, group=g)  # audit: collective-ok test")
    _expect_clean(lint.check_collective_markers(scoped, marked),
                  "marked collectives in a scoped file")
    _expect(lint.check_collective_markers(
        f"{config.PACKAGE}/core/elsewhere.py", marked),
        rules.LINT_RAW_COLLECTIVE, "marked collective outside the scope")


def check_unseeded_rng(device) -> None:
    """torch.randn without a generator -> LINT-UNSEEDED-RNG; the seeded
    draw beside it passes."""
    del device
    got = lint.check_unseeded_rng(f"{config.PACKAGE}/x.py", _UNSEEDED_RNG)
    _expect(got, rules.LINT_UNSEEDED_RNG, "torch.randn")
    if len(got) != 1:
        raise SelfTestError(f"the seeded draw must not be flagged; got "
                            f"{[str(f) for f in got]}")


def check_csr_entry(device) -> None:
    """A CSR entry file stripped of raise_on_duplicate_nonzeros ->
    LINT-CSR-ENTRY; the live altitudes pass."""
    del device
    stripped = {p: "def nothing():\n    pass\n"
                for p in config.CSR_ENTRY_FILES}
    _expect(lint.check_csr_entries(stripped), rules.LINT_CSR_ENTRY,
            "stripped CSR check")
    live = {p: _live(p) for p in config.CSR_ENTRY_FILES}
    _expect_clean(lint.check_csr_entries(live), "live CSR altitudes")


def check_bare_except(device) -> None:
    """`except Exception: pass` -> LINT-BARE-EXCEPT; the marked twin and
    a re-raising handler pass, and a bare `except:` fires regardless."""
    del device
    path = f"{config.PACKAGE}/x.py"
    _expect(lint.check_bare_except(path, _SWALLOWED_EXCEPT),
            rules.LINT_BARE_EXCEPT, "swallowing except Exception")
    _expect_clean(lint.check_bare_except(path, _MARKED_EXCEPT),
                  "marked swallow + re-raising handler")
    bare = _SWALLOWED_EXCEPT.replace("except Exception:", "except:")
    _expect(lint.check_bare_except(path, bare), rules.LINT_BARE_EXCEPT,
            "bare except")


#: rule ID -> check, one per rule
SELFTESTS: dict[str, Callable] = {
    rules.TORCH_SUM_EXCHANGE: check_sum_exchange,
    rules.TORCH_NONDET_OP: check_nondet_op,
    rules.SMEM_PLAN_BUDGET: check_plan_budget,
    rules.LINT_KERNEL_CONTRACT: check_kernel_contract,
    rules.LINT_RAW_COLLECTIVE: check_raw_collective,
    rules.LINT_UNSEEDED_RNG: check_unseeded_rng,
    rules.LINT_CSR_ENTRY: check_csr_entry,
    rules.LINT_BARE_EXCEPT: check_bare_except,
}


def run_selftests(layers: Optional[Iterable[str]] = None, *, device="cuda",
                  log=None) -> list[str]:
    """Run the self-test of every rule of `layers` (default: all); the
    trace layer's probes run on `device` (the card unless the caller
    asks for the CPU).  -> failure messages (empty: every detector
    fired)."""
    want = set(layers) if layers is not None else None
    failures: list[str] = []
    for rule_id, check in SELFTESTS.items():
        if want is not None and rules.RULES[rule_id].layer not in want:
            continue
        try:
            check(device)
            if log:
                log(f"  selftest {rule_id}: detector fired")
        except SelfTestError as e:
            failures.append(f"{rule_id}: {e}")
            if log:
                log(f"  selftest {rule_id}: FAILED ({e})")
    return failures
