"""The dense kernel's (B1) logistic delta as a tree walk.

`csrc/bisect_tree.cuh` (the chain warps of `csrc/sdca_bucket.cu`,
`csrc/sdca_sparse_bucket.cu` and `csrc/sdca_sparse_sharded_bucket.cu`)
evaluates the serial 40-step bisection of
`repro_torch.core.objectives` (`_log_delta`) in rounds of L = 5 levels:
in each round the 31 nodes of the next 5 levels of the bisection tree
are evaluated at once (one lane of the chain warp each, heap order), and
the ballot of their signs walks 5 levels; the round's new (lo, hi) is
the child interval of the path's deepest node, which that node's lane
computed (40 = 8 x 5).  Here the same walk is emulated with the plain
version's own tensor operations, node by node, and held BITWISE
(`torch.equal`) to the plain logistic delta over a seeded sweep of
(m, a, y, q) that includes y = 0 (padding), a at the ends of the
feasible interval and q near 1e-12.  Each node is evaluated on a tensor
of the sweep's shape, so an element meets the same elementwise code as
in the plain version.  The plain delta is itself held to the JAX
reference by tests/test_torch_objectives.py.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.kernels import sdca_bucket  # noqa: E402
from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES  # noqa: E402

CSRC = pathlib.Path(sdca_bucket.__file__).parent / "csrc"
SRC = (CSRC / "bisect_tree.cuh").read_text()
DENSE_SRC = (CSRC / "sdca_bucket.cu").read_text()
LEVELS = sdca_bucket.TREE_LEVELS


def _g_prime_negative(mid, m, b0, y, q):
    # the plain version's g'(d) and its sign test, operation for operation
    d = (mid - b0) * y
    gp = y * (torch.log(mid) - torch.log1p(-mid)) + m + q * d
    return (gp * y) < 0.0


def tree_walk_delta(m, a, y, q, levels_per_round):
    """Emulation of `logistic_delta_tree` in csrc/bisect_tree.cuh."""
    b0 = a * y
    lo = torch.full_like(b0, 1e-6)
    hi = torch.full_like(b0, 1.0 - 1e-6)
    L = levels_per_round
    for _ in range(tobj._BISECT_ITERS // L):
        up, nxt = {}, {}
        for node in range(1, 2 ** L):              # one thread each
            depth = node.bit_length() - 1
            l, h = lo, hi
            for lev in range(depth - 1, -1, -1):     # replay the node's path
                mid = 0.5 * (l + h)
                if (node >> lev) & 1:
                    l = mid
                else:
                    h = mid
            mid = 0.5 * (l + h)
            up[node] = _g_prime_negative(mid, m, b0, y, q)
            if depth == L - 1:                       # a deepest node
                nxt[node] = (torch.where(up[node], mid, l),
                             torch.where(up[node], h, mid))
        # the ballots: every thread walks to the same deepest node
        j = torch.ones_like(b0, dtype=torch.int64)
        for _ in range(L - 1):
            bit = torch.zeros_like(b0, dtype=torch.bool)
            for node, u in up.items():
                bit |= (j == node) & u
            j = 2 * j + bit.long()
        new_lo, new_hi = torch.zeros_like(lo), torch.zeros_like(hi)
        for node, (l, h) in nxt.items():
            new_lo = torch.where(j == node, l, new_lo)
            new_hi = torch.where(j == node, h, new_hi)
        lo, hi = new_lo, new_hi
    b = 0.5 * (lo + hi)
    return (b - b0) * y


def _sweep(seed, n=1024):
    rng = np.random.default_rng(seed)
    y = rng.choice([-1.0, 1.0, 0.0], size=n, p=[0.45, 0.45, 0.1])
    b = rng.uniform(0.0, 1.0, size=n)
    ends = rng.random(n)
    b[ends < 0.1] = 1e-6
    b[(ends >= 0.1) & (ends < 0.2)] = 1.0 - 1e-6
    b[(ends >= 0.2) & (ends < 0.25)] = 0.0
    b[(ends >= 0.25) & (ends < 0.3)] = 1.0
    a = b * np.where(y == 0.0, 1.0, y)
    m = rng.normal(scale=rng.choice([0.1, 3.0, 30.0], size=n))
    q = np.exp(rng.uniform(np.log(1e-6), np.log(1e3), size=n))
    tiny = rng.random(n) < 0.15
    q[tiny] = 1e-12 * rng.uniform(0.5, 2.0, size=tiny.sum())
    q[rng.random(n) < 0.05] = 0.0
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return f(m), f(a), f(y), f(q)


@pytest.mark.parametrize("seed", range(15))
def test_tree_walk_bitwise_equals_serial_bisection(seed):
    m, a, y, q = _sweep(seed)
    want = tobj.LOGISTIC.delta(m, a, y, q)
    got = tree_walk_delta(m, a, y, q, LEVELS)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want), (
        f"{int((got != want).sum())} of {got.numel()} deltas differ, max "
        f"{float((got - want).abs().max())}")


@pytest.mark.parametrize("q", [0.0, 1e-12, 0.3, 1e3])
def test_tree_walk_padding_rows_give_zero(q):
    """y = 0 marks a padded coordinate: its delta is exactly 0."""
    n = 64
    z = torch.zeros(n)
    m = torch.linspace(-5.0, 5.0, n)
    got = tree_walk_delta(m, z, z, torch.full((n,), q), LEVELS)
    assert torch.equal(got, torch.zeros(n))


def test_tree_nodes_cover_the_levels_once():
    """The kernel's lane -> node map (node n is lane n - 1, lane 31 holds
    none) gives every node of the 5 levels exactly one lane of the chain
    warp."""
    nodes = [t + 1 if t < 31 else 0 for t in range(32)]
    assert sorted(n for n in nodes if n) == list(range(1, 2 ** LEVELS))
    src = SRC[SRC.index("logistic_delta_tree"):]
    assert "const int node = lane < 31 ? lane + 1 : 0;" in src


def test_python_constants_match_the_kernel_source():
    """The wrapper's shared-memory model uses the kernel's tree depth and
    stage count."""
    lv = int(re.search(r"constexpr int kTreeLevels = (\d+);", SRC).group(1))
    st = int(re.search(r"constexpr int kStages = (\d+);",
                       DENSE_SRC).group(1))
    assert (sdca_bucket.TREE_LEVELS, sdca_bucket.STAGES) == (lv, st)
    assert tobj._BISECT_ITERS % lv == 0


@pytest.mark.parametrize("B,d", [(16, 28), (16, 1_000_000)])
def test_dense_staged_layout_fits_opt_in(B, d):
    """B1's two stages of tile, Gram, a, y and q (plus v and the deltas)
    fit the opt-in at HIGGS' d = 28 with bucket 16; at a width whose tiles
    do not fit, the layout keeps only what does."""
    x_in, g_in, nbytes = sdca_bucket.smem_layout(B, d)
    assert nbytes <= SMEM_OPTIN_BYTES
    assert g_in
    assert x_in == (d == 28)
