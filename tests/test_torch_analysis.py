"""The port's static audit (`repro_torch.analysis`): the counterparts of
`tests/test_analysis.py` for the lint and budget layers, the rule
registry and the CLI (`tools/audit_torch.py`).  The trace layer's tests
are `tests/test_torch_audit_trace.py`'s.  About 12 s on the CPU (the two
CLI runs are subprocesses).
"""
import json
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import (budget, config, lint, rules,  # noqa: E402
                                  selftest)
from repro_torch.core.planner import (SolverPlan, Topology,  # noqa: E402
                                      WorkloadSignature, candidate_plans)
from repro_torch.kernels import contracts, ops, sdca_bucket  # noqa: E402
from repro_torch.kernels import sdca_sparse_bucket  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CLI = REPO / "tools" / "audit_torch.py"


def test_lint_clean_on_live_tree():
    """Every live module of the port passes every lint rule, the
    registry's references resolving: the raw collectives of
    core/engine.py and resilience/journal.py carry their markers, and
    every kernel contract has a shared-memory model or says that its
    shared memory has a static size."""
    found = lint.run_lint()
    assert found == [], [str(f) for f in found]


def test_lint_flags_unmarked_collective_outside_scoped_files():
    """An unmarked collective in a scoped file is flagged at its line; a
    marked one outside the scoped files is flagged too (the scope is
    the rule), and so is a collective imported by name."""
    src = ("import torch.distributed as dist\n\n"
           "def f(x, g):\n    return dist.all_reduce(x, group=g)\n")
    scoped = config.COLLECTIVE_SCOPED_FILES[0]
    got = lint.run_lint({scoped: src}, only=[rules.LINT_RAW_COLLECTIVE])
    assert [f.rule for f in got] == [rules.LINT_RAW_COLLECTIVE]
    assert got[0].where == f"{scoped}:4"
    marked = src.replace("group=g)", "group=g)  # audit: collective-ok x")
    assert lint.run_lint({scoped: marked},
                         only=[rules.LINT_RAW_COLLECTIVE]) == []
    elsewhere = "src/repro_torch/core/elsewhere.py"
    got = lint.run_lint({elsewhere: marked},
                        only=[rules.LINT_RAW_COLLECTIVE])
    assert [f.where for f in got] == [f"{elsewhere}:4"]
    spelled = ("import torch\n\ndef f(x):\n"
               "    torch.distributed.barrier()\n")
    assert len(lint.check_collective_markers(elsewhere, spelled)) == 1
    by_name = "from torch.distributed import all_gather\n"
    assert len(lint.check_collective_markers(scoped, by_name)) == 1


def test_lint_kernel_contract_and_rng_rules():
    contracts_src = (REPO / config.CONTRACTS_FILE).read_text()
    registry, comments = lint.load_contracts(contracts_src)
    assert registry == contracts.KERNEL_CONTRACTS
    csrc = lint.default_csrc()
    rogue = {"rogue.cu": 'extern "C" int rogue_launch(int n) { return n; }'}
    got = lint.check_kernel_contracts({}, {**csrc, **rogue}, registry,
                                      comments)
    assert [f.rule for f in got] == [rules.LINT_KERNEL_CONTRACT]
    assert got[0].where == f"{config.CSRC_DIR}/rogue.cu:1"
    # a registered source that is gone, and an entry it does not export
    missing = {k: v for k, v in csrc.items() if k != "rglru.cu"}
    got = lint.check_kernel_contracts({}, missing, registry, comments)
    assert len(got) == 1 and "rglru" in got[0].message

    for src in ("import numpy as np\nx = np.random.rand(3)\n",
                "import torch\nx = torch.randn(3)\n",
                "import torch\ntorch.manual_seed(0)\n",
                "import torch\nx = torch.empty(3).uniform_()\n",
                "import random\n"):
        got = lint.check_unseeded_rng("src/repro_torch/core/x.py", src)
        assert [f.rule for f in got] == [rules.LINT_UNSEEDED_RNG], src
    for src in ("import numpy as np\nr = np.random.default_rng(0)\n",
                "import torch\ng = torch.Generator().manual_seed(0)\n"
                "x = torch.randn(3, generator=g)\n"
                "y = torch.empty(3).normal_(generator=g)\n"):
        assert lint.check_unseeded_rng("src/repro_torch/core/x.py",
                                       src) == [], src


def test_tp_solve_contract_has_its_smem_model():
    """The TP pair's step (the solve and the next bucket's partials in
    one launch) registers the model of its dynamic shared memory: ten
    slots of staged rows, the warps' partials, a, y, q, the deltas and,
    up to B 64, the worker's [m0 | G]; above the 48 KiB a launch takes
    without opting in, within the opt-in at every B up to the
    recursion's cap, and the budget sweep finds it clean at its edges."""
    c = contracts.KERNEL_CONTRACTS["sdca_bucket.sdca_bucket_tp_step"]
    assert c["smem_estimate"].endswith(":tp_step_smem_bytes")
    assert sdca_bucket.tp_step_smem_bytes(16) == 183_328
    assert sdca_bucket.tp_step_smem_bytes(48) == 184_480
    assert sdca_bucket.tp_step_smem_bytes(16) > 48 << 10
    assert max(sdca_bucket.tp_step_smem_bytes(B) for B in range(
        1, sdca_bucket.MAX_BUCKET + 1)) <= contracts.SMEM_OPTIN_BYTES
    edges = budget.tp_step_edges()
    assert (sdca_bucket.MAX_BUCKET, 1) in edges and (16, 241) in edges
    assert [f for B, d in edges for f in budget.audit_tp_step(B, d)] == []


def test_rules_registry_complete_and_documented():
    """Every rule has its invariant and history, a layer, and a
    self-test; README's rule table lists exactly the registry's IDs,
    each with its layer."""
    assert set(rules.RULES) == {
        "TORCH-SUM-EXCHANGE", "TORCH-NONDET-OP", "LINT-KERNEL-CONTRACT",
        "LINT-RAW-COLLECTIVE", "LINT-UNSEEDED-RNG", "LINT-CSR-ENTRY",
        "LINT-BARE-EXCEPT", "SMEM-PLAN-BUDGET"}
    for rule in rules.RULES.values():
        assert rule.invariant and rule.history
        assert rule.layer in ("trace", "lint", "budget")
    assert set(selftest.SELFTESTS) == set(rules.RULES)
    readme = (REPO / "README.md").read_text()
    table = dict(re.findall(r"^\| `([A-Z0-9-]+)` \| (\w+) \|", readme, re.M))
    assert table == {r.id: r.layer for r in rules.RULES.values()}


def test_selftests_lint_and_budget_fire():
    assert selftest.run_selftests(["lint", "budget"]) == []


def test_budget_audit_clean_and_catches_forged_plan():
    found, n_plans = budget.run_budget_audit()
    assert found == [], [str(f) for f in found]
    assert n_plans > 1000          # the sweep actually swept
    detected = Topology.detect(device="cpu")
    found, more = budget.run_budget_audit(detected=detected)
    assert found == [] and more > n_plans

    sig = WorkloadSignature(n=4096, d=64, nnz=65_536, sparse=True)
    forged = SolverPlan(solver="kernel", route="kernel", bucket=16,
                        chunks=1, nnz_multiple=0, feature_shard=False)
    got = budget.audit_plan(sig, Topology(backend="cuda"), forged)
    assert got and all(f.rule == rules.SMEM_PLAN_BUDGET for f in got)
    dense = WorkloadSignature(n=4096, d=28)
    big = SolverPlan(solver="kernel", route="kernel", bucket=1024,
                     chunks=1, nnz_multiple=0, feature_shard=False)
    got = budget.audit_plan(dense, Topology(backend="cuda"), big)
    assert [f.rule for f in got] == [rules.SMEM_PLAN_BUDGET]
    torch_route = SolverPlan(solver="torch", route="torch", bucket=1024,
                             chunks=1, nnz_multiple=0, feature_shard=False)
    assert budget.audit_plan(dense, Topology(backend="cuda"),
                             torch_route) == []


@pytest.mark.parametrize("nnz,lanes,route", [
    (58_112, 1, "kernel"), (58_113, 1, "torch"),
    (58_113, 2, "kernel-sharded")])
def test_sparse_route_misfits_rows_wider_than_smem(nnz, lanes, route):
    """The replicated kernel keeps a row's products in shared memory in
    both layouts, so on one lane a row past 58,112 nonzeros misfits
    (SMEM_ROW) instead of reaching a launch that cannot get its shared
    memory; with model lanes it takes the sharded kernel.  Every plan
    the planner makes of that width passes the budget audit, and none
    on one lane is routed to "kernel"."""
    got, why = ops.sparse_solver_plan(16, nnz, 1 << 20, 16,
                                      model_lanes=lanes)
    assert got == route
    assert getattr(why, "code", None) == (
        ops.MisfitCode.SMEM_ROW if route == "torch" else None)
    sig = WorkloadSignature(n=4096, d=1 << 20, nnz=nnz, sparse=True)
    topo = Topology(backend="cuda", model_lanes=lanes)
    plans = candidate_plans(sig, topo)
    assert plans and all(budget.audit_plan(sig, topo, p) == []
                         for p in plans)
    if route == "torch":
        assert all(p.route != "kernel" for p in plans)


def test_budget_sweep_covers_row_width_edge(monkeypatch):
    """The sweep holds the real planner at the row-width edge: were the
    sparse route to stop misfitting wide rows, the plans of the
    58,113-nonzero signature would place more than the opt-in."""
    assert budget.ROW_EDGE == (58_112, 58_113)
    monkeypatch.setattr(sdca_sparse_bucket, "row_fits_smem",
                        lambda nnz: True)
    found, _ = budget.run_budget_audit()
    assert found and {f.rule for f in found} == {rules.SMEM_PLAN_BUDGET}
    assert all(f.case.startswith("row-edge-58113") for f in found)


def test_audit_cli_lint_layer_and_report(tmp_path):
    """The CLI's device-free layers end to end: exit 0 on the clean
    tree, the self-tests of those layers fire, a JSON report in the
    reference's schema."""
    report = tmp_path / "AUDIT.json"
    r = subprocess.run(
        [sys.executable, str(CLI), "--selftest", "--layers", "lint,budget",
         "--report", str(report), "--quiet"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    doc = json.loads(report.read_text())
    assert doc["ok"] is True and doc["findings"] == []
    assert doc["version"] == 1 and doc["plans_swept"] > 1000
    assert doc["layers"] == ["lint", "budget"] and doc["cases"] == []
    assert doc["selftest_failures"] == []
    assert set(doc["rules"]) == set(rules.RULES)


def test_audit_cli_rejects_unknown_layer():
    r = subprocess.run([sys.executable, str(CLI), "--layers", "nope"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "unknown audit layers" in (r.stderr + r.stdout)
