"""The rule registry: every machine-checked invariant of the port, with
its ID.

One `Rule` per invariant the auditor enforces; the registry is the one
source of the rule IDs (README's rule table is held to it by
tests/test_torch_analysis.py, and every mutation self-test in
`analysis.selftest` names the rule it proves fires).  The reference's
rule IDs keep their names where the invariant has a torch meaning:
VMEM-PLAN-BUDGET is the card's SMEM-PLAN-BUDGET, JAX-PSUM-EXCHANGE and
JAX-NONDET-PRIM are TORCH-SUM-EXCHANGE and TORCH-NONDET-OP.
JAX-LOOP-CLOSURE has no counterpart: the port has no shard_map, and a
rank's lane is explicit (`MeshCollectives.lane`).  Stdlib only, so docs
tooling reads the registry without torch.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "Rule", "Finding", "RULES",
    "TORCH_SUM_EXCHANGE", "TORCH_NONDET_OP",
    "LINT_KERNEL_CONTRACT", "LINT_RAW_COLLECTIVE", "LINT_UNSEEDED_RNG",
    "LINT_CSR_ENTRY", "LINT_BARE_EXCEPT", "SMEM_PLAN_BUDGET",
]

TORCH_SUM_EXCHANGE = "TORCH-SUM-EXCHANGE"
TORCH_NONDET_OP = "TORCH-NONDET-OP"
LINT_KERNEL_CONTRACT = "LINT-KERNEL-CONTRACT"
LINT_RAW_COLLECTIVE = "LINT-RAW-COLLECTIVE"
LINT_UNSEEDED_RNG = "LINT-UNSEEDED-RNG"
LINT_CSR_ENTRY = "LINT-CSR-ENTRY"
LINT_BARE_EXCEPT = "LINT-BARE-EXCEPT"
SMEM_PLAN_BUDGET = "SMEM-PLAN-BUDGET"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One machine-checked invariant.

    ``layer`` is where the checker lives ("trace" | "lint" | "budget");
    ``invariant`` states the contract being enforced; ``history`` names
    the bug (or bug class) it guards against.
    """
    id: str
    layer: str
    invariant: str
    history: str


RULES: dict[str, Rule] = {r.id: r for r in (
    Rule(
        TORCH_SUM_EXCHANGE, "trace",
        "Under deterministic=True no all_reduce, reduce or "
        "reduce_scatter with ReduceOp.SUM on a floating tensor may run "
        "in an epoch program on a process mesh: every exchange on the "
        "contract path is an all-gather and a sum in rank order (or "
        "pure data movement).  An integer MIN over cursors (the mesh "
        "journal's agreement) is not a sum and stays allowed.",
        "The process mesh is bitwise its stacked twin only because its "
        "lane sums, pod reduces and per-bucket model exchanges are "
        "ordered gather-sums (MeshCollectives); one "
        "all_reduce on that path reorders float sums by the backend's "
        "ring and silently breaks the contract."),
    Rule(
        TORCH_NONDET_OP, "trace",
        "The deterministic single-process paths (Session dense, sparse "
        "and sharded, the stacked mesh's make_dense_epoch / "
        "make_sparse_epoch with deterministic=True) run under "
        "torch.use_deterministic_algorithms(True) without an op the "
        "mode refuses, without a floating-point accumulate into "
        "indices (index_add_, scatter_add_, index_put_ with "
        "accumulate, put_: atomics on the card outside the mode), and "
        "with a state torch.equal across two runs.",
        "The port's bitwise contracts (kernel == plain version, "
        "streamed == resident, process mesh == stacked mesh) rest on "
        "ordered arithmetic; an atomic accumulate is exact on the CPU, "
        "where the tests run, and differs run to run on the card."),
    Rule(
        LINT_KERNEL_CONTRACT, "lint",
        "Every extern \"C\" entry of kernels/csrc/*.cu, and every entry "
        "that kernels/*.py reaches through build.load(...) or "
        "sdca_bucket.c_entry, is registered in kernels/contracts.py; "
        "every registered source exists, every 'module:attr' ref "
        "resolves, and a contract without a shared-memory model says in "
        "its comment that its shared memory has a static size.",
        "kernels.build compiles exactly the registered sources, and the "
        "planner and the budget sweep read the registered shared-memory "
        "models: an unregistered entry is built by nothing and budgeted "
        "by nothing."),
    Rule(
        LINT_RAW_COLLECTIVE, "lint",
        "A torch.distributed collective (all_reduce, all_gather, "
        "all_to_all*, reduce*, broadcast, barrier, gather, scatter, "
        "send/recv) is called only in core/engine.py, launch/mesh.py "
        "and resilience/journal.py, on a line that carries (or sits "
        "below) a '# audit: collective-ok <why>' marker: every "
        "cross-rank exchange is an enumerated, reviewed site.",
        "The determinism contract is a property of a closed set of "
        "exchange sites; an unmarked collective added in review is "
        "how an unordered reduction slips onto the contract path."),
    Rule(
        LINT_UNSEEDED_RNG, "lint",
        "No live module draws from numpy's global-state RNG, the "
        "stdlib random module, torch.manual_seed's global generator or "
        "a torch sampler (rand, randn, randint, randperm, normal, "
        "bernoulli, multinomial; uniform_, normal_, random_, "
        "bernoulli_, exponential_) without generator=: all randomness "
        "flows from explicit seeds (np.random.default_rng(seed), the "
        "threefry keys of core/prng.py, a seeded torch.Generator).",
        "Schedules, synthetic datasets, re-deals and LM weights replay "
        "from (seed, epoch); one draw from a global generator makes a "
        "run unreproducible and a cross-package comparison flaky."),
    Rule(
        LINT_CSR_ENTRY, "lint",
        "Each CSR entry altitude (kernels/ops.py, api/session.py) calls "
        "data.formats.raise_on_duplicate_nonzeros: rows with duplicate "
        "nonzero feature ids break the sparse kernels' bitwise "
        "contract with their plain versions.",
        "The reference added the check at both altitudes after "
        "duplicate synthetic rows broke the bitwise contract; losing "
        "either call reopens the hole for ad-hoc arrays."),
    Rule(
        LINT_BARE_EXCEPT, "lint",
        "No live module has a bare `except:`, or an `except "
        "Exception/BaseException` handler that swallows the error (no "
        "raise in it), without a '# audit: except-ok <why>' marker: "
        "every swallow site is an enumerated, reviewed recovery "
        "decision.",
        "The resilience runtime is built on typed errors and a "
        "BaseException crash sentinel; one anonymous `except "
        "Exception: pass` between a fault and the monitor turns a "
        "recoverable fault into silent state corruption, and on the "
        "card hides a kernel that failed behind its plain version."),
    Rule(
        SMEM_PLAN_BUDGET, "budget",
        "No plan the planner can emit (any candidate geometry over any "
        "registry workload x topology, the detected card's too) routes "
        "to a kernel whose own shared-memory model places more than "
        "contracts.SMEM_OPTIN_BYTES in a block, or that keeps v in "
        "shared memory when v exceeds the topology's v budget.",
        "A launch above the opt-in fails only on the card, as a CUDA "
        "error at the first epoch; the sweep fails the same geometry "
        "offline, before a card sees it."),
)}


@dataclasses.dataclass
class Finding:
    """One rule violation: rule ID, anchor and message.

    ``where`` is a file:line anchor when the checker has one;
    ``case`` labels the audit-matrix case or self-test that produced it
    (e.g. "webspam-sub/slices/kernel/resident/det").
    """
    rule: str
    message: str
    where: str = ""
    case: str = ""

    def to_json(self) -> dict:
        """JSON-safe dict for the machine-readable report."""
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        case = f" ({self.case})" if self.case else ""
        return f"{self.rule}{case}{loc}: {self.message}"
