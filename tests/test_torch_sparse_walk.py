"""The replicated sparse kernel's (B2) walk, emulated on the CPU.

`csrc/sdca_sparse_bucket.cu` runs each worker's buckets on one chain
warp over links that its producer warps build in shared memory (in
global memory for a bucket too large for it, with the same code): the
bucket's distinct ids in an open-addressing hash table (slot = the id's
cell, S = the cells' values), each row's run lengths and row places
(rpos), and the working set S[cell] = v[id] read while the chain still
walks the bucket before, then patched from that bucket's final cells
before the walk; the chain writes each bucket's cells back into v.
The kernel itself runs only on the card (chip_smoke.py holds it there
against its plain version); here a float32 numpy copy of its loops
(`_emulate`) is held BITWISE (`torch.equal`) to
`sdca_sparse_bucket_plain` for every objective, on rows that repeat ids
(zero-valued duplicates), over consecutive buckets that share hot ids,
with -0.0 entries in v, and shown to fail without the patch.
The delta is the plain version's own on the worker vector; the chain's
tree walk of it is held to the plain one by test_torch_bisect_tree.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.objectives import get_objective       # noqa: E402
from repro_torch.data.synthetic import make_sparse_classification  # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.kernels import sdca_sparse_bucket as ks      # noqa: E402

OBJS = ["ridge", "hinge", "logistic"]
LAM_N, SIG = 3.2, 2.0
EMPTY = -1
f32 = np.float32


def _hash_cell(i: int, bits: int) -> int:
    return ((i * 2654435761) & 0xFFFFFFFF) >> (32 - bits)


def _stage(idx, bits):
    """One bucket's links, as the producer warps build them: (table,
    cells, slot, rpos, run_len) of (B, nnz) ids (insertion in t order;
    the kernel's order varies, its walk does not depend on it)."""
    B, nnz = idx.shape
    H = 1 << bits
    table = np.full(H, EMPTY, np.int64)
    cells, slot = [], np.empty(B * nnz, np.int64)
    for t, i in enumerate(idx.reshape(-1).tolist()):
        h = _hash_cell(i, bits)
        while table[h] not in (EMPTY, i):
            h = (h + 1) & (H - 1)
        if table[h] == EMPTY:
            table[h] = i
            cells.append(h)
        slot[t] = h
    rpos = np.empty(B * nnz, np.int64)
    run_len = np.empty(B * nnz, np.int64)
    for t in range(B * nnz):
        row, k = idx[t // nnz], t % nnz
        i = row[k]
        rpos[t] = sum(int(r < i or (r == i and k2 < k))
                      for k2, r in enumerate(row))
        first = not any(r == i for r in row[:k])
        run_len[t] = int((row == i).sum()) if first else 0
    return table, cells, slot, rpos, run_len


def _probe(table, i, bits):
    H = len(table)
    h = _hash_cell(i, bits)
    while table[h] != EMPTY:
        if table[h] == i:
            return h
        h = (h + 1) & (H - 1)
    return None


def _emulate(obj, idxb, valb, yb, ab, qb, v0, lam_n, sig, patch=True):
    """The loops of csrc/sdca_sparse_bucket.cu in float32, every worker
    in lockstep (the delta on the worker vector, as the plain scan)."""
    W, nb, B, nnz = idxb.shape
    E = B * nnz
    bits = (2 * E - 1).bit_length()
    assert 1 << bits == ks.table_cells(E)
    idxb, valb = idxb.numpy(), valb.numpy()
    yb, ab, qb = yb.numpy(), ab.numpy(), qb.numpy()
    v = v0.numpy().copy()
    a_out = np.empty((W, nb, B), np.float32)
    stages = [[None] * nb for _ in range(W)]
    for b in range(nb):
        for w in range(W):
            # producers: links and the working set, from v as the write-
            # back of bucket b-1 has not happened yet
            table, cells, slot, rpos, run_len = _stage(idxb[w, b], bits)
            S = np.full(len(table), np.nan, np.float32)
            pairs = []
            for h in cells:
                S[h] = v[w, table[h]]
                if b > 0:
                    hp = _probe(stages[w][b - 1]["table"], table[h], bits)
                    if hp is not None:
                        pairs.append((h, hp))
            stages[w][b] = dict(table=table, cells=cells, slot=slot,
                                rpos=rpos, run_len=run_len, S=S)
            # the chain: patch from bucket b-1's final cells, write b-1 back
            if b > 0:
                prev = stages[w][b - 1]
                if patch:
                    for h, hp in pairs:
                        S[h] = prev["S"][hp]
                for h in prev["cells"]:
                    v[w, prev["table"][h]] = prev["S"][h]
        for i in range(B):
            r = range(i * nnz, (i + 1) * nnz)
            m = np.zeros(W, np.float32)
            for w in range(W):
                st, val = stages[w][b], valb[w, b].reshape(-1)
                for t in r:                   # lane 0, left to right
                    m[w] = f32(m[w] + f32(st["S"][st["slot"][t]] * val[t]))
            q = (torch.tensor(sig) * torch.from_numpy(qb[:, b, i].copy())
                 / torch.tensor(lam_n))                # the producers' q_eff
            d = obj.delta(torch.from_numpy(m), torch.from_numpy(
                ab[:, b, i].copy()), torch.from_numpy(yb[:, b, i].copy()),
                q).numpy()
            for w in range(W):
                st, val = stages[w][b], valb[w, b].reshape(-1)
                a_out[w, b, i] = f32(ab[w, b, i] + d[w])
                c = f32(f32(f32(sig) * d[w]) / f32(lam_n))
                rval = np.empty(nnz, np.float32)       # val in run order
                rval[st["rpos"][r]] = val[r]
                for t in r:                   # the first lane of each run
                    L = st["run_len"][t]
                    if L > 0:
                        h, p = st["slot"][t], st["rpos"][t]
                        acc = f32(st["S"][h] + f32(c * val[t]))
                        for j in range(1, L):
                            acc = f32(acc + f32(c * rval[p + j]))
                        st["S"][h] = acc
    for w in range(W):
        last = stages[w][nb - 1]
        for h in last["cells"]:
            v[w, last["table"][h]] = last["S"][h]
    return torch.as_tensor(a_out), torch.as_tensor(v)


def _tiles(name, W=2, n=48, d=40, nnz=8, B=4, seed=0, hot=3):
    """Padded-CSR worker tiles whose rows repeat ids (zeroed), with one
    id (`hot`) in every row of every bucket and v[hot] = -0.0 (with a
    few more -0.0 entries), so consecutive buckets share hot ids."""
    (idx, val), y, _ = make_sparse_classification(
        n=W * n, d=d, nnz=nnz, seed=seed, skew=1.1)
    rng = np.random.default_rng(seed)
    idx[:, -1] = hot
    val[:, -1] = rng.standard_normal(W * n).astype(np.float32)
    val[(idx[:, :-1] == hot).any(axis=1), -1] = 0.0
    if name == "ridge":
        y = rng.normal(size=y.shape).astype(np.float32)
        a = (0.1 * rng.normal(size=y.shape)).astype(np.float32)
    else:
        a = (y * rng.uniform(0.05, 0.5, size=y.shape)).astype(np.float32)
    v0 = (0.1 * rng.normal(size=(W, d))).astype(np.float32)
    v0[:, hot] = -0.0
    v0[:, rng.choice(d, 3, replace=False)] = -0.0
    t = lambda x, *s: torch.as_tensor(x.reshape(*s))
    return ops.sparse_tiles(t(idx, W, n, nnz), t(val, W, n, nnz),
                            t(y, W, n), t(a, W, n), torch.as_tensor(v0),
                            bucket=B)


@pytest.mark.parametrize("name", OBJS)
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_is_the_plain_scan(name, seed):
    tiles = _tiles(name, seed=seed)
    idxb = tiles[0]
    rows = idxb.reshape(-1, idxb.shape[-1]).numpy()
    assert any(len(set(r)) < len(r) for r in rows)
    obj = get_objective(name)
    a_e, v_e = _emulate(obj, *tiles, LAM_N, SIG)
    a_p, v_p = ks.sdca_sparse_bucket_plain(obj, *tiles, LAM_N, SIG)
    assert torch.equal(a_e, a_p) and torch.equal(v_e, v_p)


@pytest.mark.parametrize("name", OBJS)
def test_walk_without_the_patch_is_wrong(name):
    """The bucket-boundary hazard is real on these rows: reading each
    bucket's working set before the bucket before it is written back,
    and not patching it, changes the result."""
    tiles = _tiles(name)
    obj = get_objective(name)
    a_e, v_e = _emulate(obj, *tiles, LAM_N, SIG, patch=False)
    a_p, v_p = ks.sdca_sparse_bucket_plain(obj, *tiles, LAM_N, SIG)
    assert not (torch.equal(a_e, a_p) and torch.equal(v_e, v_p))


def test_negative_zero_meets_zero_valued_duplicates():
    """v[id] = -0.0 and a row whose entries of that id are all zero: the
    scan adds u = c * 0.0 into it, which turns -0.0 into +0.0 when c >
    0; the walk folds the same zeros, so it keeps the scan's bits (a
    walk that skipped zero-valued entries would keep -0.0)."""
    idx = torch.tensor([[[[3, 3, 1, 2], [1, 3, 3, 0]]]], dtype=torch.int32)
    val = torch.tensor([[[[0.0, 0.0, 0.5, -0.25], [1.0, 0.0, 0.0, 0.5]]]])
    y = torch.tensor([[[1.0, -1.0]]])
    a = torch.tensor([[[0.25, -0.25]]])
    q = torch.tensor([[[0.3125, 1.25]]])
    v0 = torch.tensor([[0.5, -0.0, 0.25, -0.0]])
    obj = get_objective("ridge")
    a_e, v_e = _emulate(obj, idx, val, y, a, q, v0, LAM_N, SIG)
    a_p, v_p = ks.sdca_sparse_bucket_plain(obj, idx, val, y, a, q, v0,
                                           LAM_N, SIG)
    assert torch.equal(a_e, a_p) and torch.equal(v_e, v_p)
    assert torch.equal(v_p[0, 3].sign(), torch.tensor(0.0))
    assert not torch.signbit(v_p[0, 3])


@pytest.mark.parametrize("B,nnz,fits", [(16, 40, True), (4, 8, True),
                                        (1, 640, True), (64, 40, False),
                                        (16, 3_728, False)])
def test_shared_memory_model(B, nnz, fits):
    """The replicated kernel's memory at criteo's bucket (16 x 40) and
    others: the chain's products in shared memory, then the producers'
    ids and two stages of links, in shared memory where they fit and in
    a global region per block where they do not.  Either way one lane
    takes the replicated kernel."""
    E = B * nnz
    H = ks.table_cells(E)
    assert H >= 2 * E and H & (H - 1) == 0 and H < 4 * E + 1
    n4 = -(-nnz // 4) * 4
    assert ks.region_words(B, nnz) == E + ks.STAGES * (
        8 * E + 2 * H + 3 * B + 4)
    assert ks.smem_bytes(B, nnz) == 4 * (n4 + ks.region_words(B, nnz))
    assert ks.smem_bytes(16, 40) == 76_864
    assert ks.fits_smem(B, nnz) == fits
    assert ops.sparse_solver_plan(4 * B, nnz, 10**6, B) == ("kernel", None)


@pytest.mark.parametrize("nnz,fits", [(8, True), (40, True), (3_728, True),
                                      (9_000, True), (10_000, False)])
def test_sharded_row_model(nnz, fits):
    """The sharded kernel's row of operands (six arrays of nnz, rounded
    up to 4) beside a ready flag per chunk of products and the
    coefficient: in shared memory up to ~9,600 nonzeros, in a global
    scratch row per block beyond.  Either way M lanes take the sharded
    pair when the replicated stages do not fit."""
    n4 = -(-nnz // 4) * 4
    assert ks.sharded_row_words(nnz) == 6 * n4
    assert ks.sharded_smem_bytes(nnz) == 4 * (
        6 * n4 + -(-nnz // ks.SHARDED_CHUNK) + 1)
    assert ks.sharded_fits_smem(nnz) == fits
    assert ops.sparse_solver_plan(64, nnz, 10**6, 16, model_lanes=4) == (
        "kernel" if ks.fits_smem(16, nnz) else "kernel-sharded", None)
