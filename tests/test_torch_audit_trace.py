"""The audit's trace layer (`repro_torch.analysis.trace`) on the CPU.

TORCH-SUM-EXCHANGE: one spawn of 4 gloo CPU ranks (the module's own
rank program, a file store under a temporary directory, a timeout on
the rendezvous, every collective and the join) runs the matrix of two
registry workloads (synthetic-dense: examples on (2, 2, 1), TP on
(1, 2, 2); synthetic-sparse: replicated and slices on (1, 2, 2)) x the
"torch" and "kernel" routes (plain versions here) x resident and
streamed x deterministic True and False, every case held to the
deterministic contract: the deterministic cases are clean and every
deterministic=False case fires, at the engine's one unordered site.
TORCH-NONDET-OP: the deterministic single-process paths, both routes,
pass under ``torch.use_deterministic_algorithms(True)``, equal across
two runs, and the mode is restored after; the gate's probes fire and
stay clean as they should.  About 25 s on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import rules, selftest, trace      # noqa: E402

WORKLOADS = ["synthetic-dense", "synthetic-sparse"]


@pytest.fixture(scope="module")
def matrix():
    cases = trace.build_cases(WORKLOADS)
    return cases, trace.sum_exchange(cases, device="cpu", world=4,
                                     strict=True, timeout=300)


def test_matrix_covers_every_role_route_and_mode(matrix):
    cases, got = matrix
    assert len(cases) == 2 * 2 * 2 * 2 * 2 and set(got) == {
        c.name for c in cases}
    assert {c.role for c in cases} == set(trace.ROLE_MESH)
    assert {(c.route, c.mode) for c in cases} == {
        (r, m) for r in trace.ROUTES for m in trace.MODES}


def test_sum_exchange_clean_under_deterministic(matrix):
    cases, got = matrix
    for c in cases:
        if c.deterministic:
            assert got[c.name] == [], [str(f) for f in got[c.name]]


def test_sum_exchange_fires_under_nondeterministic(matrix):
    """deterministic=False sums over all_reduce: held to the contract,
    each such case is flagged at `MeshCollectives._all_reduce`."""
    cases, got = matrix
    for c in cases:
        if not c.deterministic:
            found = got[c.name]
            assert found, c.name
            assert {f.rule for f in found} == {rules.TORCH_SUM_EXCHANGE}
            assert all(f.where.startswith("src/repro_torch/core/engine.py:")
                       for f in found), [f.where for f in found]


def test_nondet_gate_clean_on_cpu_paths():
    was = torch.are_deterministic_algorithms_enabled()
    got = trace.nondet_gate(device="cpu", routes=trace.ROUTES)
    assert set(got) == {f"{p}/{r}" for p in trace.GATE_PATHS
                        for r in trace.ROUTES}
    for name, found in got.items():
        assert found == [], (name, [str(f) for f in found])
    assert torch.are_deterministic_algorithms_enabled() == was


def test_trace_selftests_fire():
    assert selftest.run_selftests(["trace"], device="cpu") == []


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.nondet_gate(["probe-ordered"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.sum_exchange([trace.SumCase("probe", "all_gather")])
