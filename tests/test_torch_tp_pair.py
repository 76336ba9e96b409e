"""The dense tensor-parallel pair's step (`csrc/sdca_bucket_tp.cu`) as a
numpy walk of its stages and its per-warp order.

The kernel runs only on the card.  This file walks what it computes, one
launch at a time, in its own order and in float32: the items its
producer stages (bucket b+1's rows for the Gram passes, then per stage
bucket b's rows with their v rows and bucket b+1's rows), G's
upper-triangle tiles, 32 a pass, over the rows f = w (mod
TP_COMPUTE_WARPS) of each compute warp w in ascending order, the warps'
partials summed in warp order and mirrored, v_new[f] = v[f] +
(sigma'/lam_n) sum_i x[f][i] delta_i (i ascending), and m0 = X^T v_new
in the same warps-over-rows order.  The card contracts each
multiply-add into one FMA where the walk rounds twice, so the walk is
held to the plain functions within the card's tolerance (TOL_TP, as
`chip_smoke.py` holds the kernel) and to the reference package's
sub-epoch; what the walk shows exactly is that a lane's arithmetic is
its own (alone == inside a stacked launch, bitwise), which the process
mesh rests on.  ~18 s on one process.
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdca as ref_sdca
from repro.core.objectives import get_objective as ref_objective
from repro_torch.core import sdca
from repro_torch.core.objectives import get_objective
from repro_torch.kernels import ops
from repro_torch.kernels import sdca_bucket as kd

CU = pathlib.Path(kd.__file__).parent / "csrc" / "sdca_bucket_tp.cu"
TOL_TP = (1e-4, 1e-5)                  # chip_smoke.py's, rtol / atol
CW = kd.TP_COMPUTE_WARPS
f32 = np.float32
OBJECTIVES = ("ridge", "hinge", "logistic")


# ---- the walk -------------------------------------------------------------

def items(b: int, nxt: int, K: int,
          passes: int) -> list[tuple[int, int, bool]]:
    """The launch's staged items in the producer's order (`item_at`):
    (bucket, stage, with its v rows)."""
    out = ([(nxt, k, False) for _ in range(passes) for k in range(K)]
           if nxt >= 0 else [])
    for k in range(K):
        if b >= 0:
            out.append((b, k, True))
        if nxt >= 0:
            out.append((nxt, k, b < 0))
    return out


def tiles(B: int) -> list[tuple[int, int]]:
    """G's upper-triangle kTile x kTile tiles, row-major (`tile_coords`)."""
    nt = -(-B // kd.TP_TILE)
    return [(i, j) for i in range(nt) for j in range(i, nt)]


def group_rounds(d_loc: int, R: int, groups: int):
    """The rows as `groups` row groups take them, stage by stage: per
    round, (the groups that still have a row, their rows f = k R + r0 +
    g), so group g walks f = g (mod groups) in ascending order (the
    compute warps, `groups` = CW, or a warp's lane groups, CW x
    `tp_lane_groups`; R is a multiple of either)."""
    for k in range(-(-d_loc // R)):
        rows = min(R, d_loc - k * R)
        for r0 in range(0, rows, groups):
            g = np.arange(min(groups, rows - r0))
            yield g, k * R + r0 + g


def group_sum(acc: np.ndarray) -> np.ndarray:
    """(groups, ...) the groups' partials -> their sum in group order."""
    tot = acc[0]
    for g in range(1, acc.shape[0]):
        tot = tot + acc[g]
    return tot


def row_dots(x: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """(X delta)_f of (*g, d_loc, B) rows (`row_dot`): over 4-column
    blocks from block (f >> 1) & 3 on, wrapping, each block's columns
    ascending; over the columns ascending when B % 4 != 0."""
    *g, d_loc, B = x.shape
    dot = np.zeros((*g, d_loc), f32)
    if B % 4:
        for i in range(B):
            dot = dot + x[..., :, i] * deltas[..., None, i]
        return dot
    nc = B // 4
    f = np.arange(d_loc)
    c = ((f >> 1) & 3) % nc
    for _ in range(nc):
        for e in range(4):
            i = 4 * c + e                                  # (d_loc,)
            dot = dot + x[..., f, i] * np.take(deltas, i, axis=-1)
        c = (c + 1) % nc
    return dot


def rows_of(t: np.ndarray, f: np.ndarray, axis: int) -> np.ndarray:
    """Rows f of t along `axis`, moved to the front (one a warp)."""
    return np.moveaxis(np.take(t, f, axis=axis), axis, 0)


def gram_walk(x: np.ndarray) -> np.ndarray:
    """G = X^T X of (*g, d_loc, B) rows: per pass, each row group's rows
    (a warp's lane group) in ascending order for the pass's tiles,
    summed in group order; the passes' tiles cover G's upper triangle
    once, mirrored below."""
    *g, d_loc, B = x.shape
    R = kd.tp_stage_rows(B)
    T = tiles(B)
    per, ng = min(len(T), 32), CW * kd.tp_lane_groups(B)
    G = np.full((*g, B, B), np.nan, f32)
    for p in range(kd.tp_gram_passes(B)):
        acc = np.zeros((ng, *g, B, B), f32)
        for w, f in group_rounds(d_loc, R, ng):
            xr = rows_of(x, f, -2)
            acc[w] += xr[..., :, None] * xr[..., None, :]
        tot = group_sum(acc)
        for ti, tj in T[per * p:per * (p + 1)]:
            s = np.s_[kd.TP_TILE * ti:kd.TP_TILE * (ti + 1)]
            t = np.s_[kd.TP_TILE * tj:kd.TP_TILE * (tj + 1)]
            assert np.isnan(G[..., s, t]).all()           # each tile once
            G[..., s, t] = tot[..., s, t]
    upper = np.triu(np.ones((B, B), bool))
    G = np.where(upper, G, np.swapaxes(G, -1, -2))
    assert not np.isnan(G).any()                          # every entry
    return G


def step_walk(obj, total, x_b, x_n, v, a, y, lam_n: float, sig: float):
    """One launch for the blocks (*g): total (*g, B, 1 + B) the summed
    partials of bucket b, x_b / x_n (*g, d_loc, B) the rows of bucket b
    and b+1 (None: no solve / no partials), v (*g, d_loc), a / y (*g,
    B) -> (a_new or None, v_new, parts or None)."""
    x = x_n if x_n is not None else x_b
    *g, d_loc, B = x.shape
    K = -(-d_loc // kd.tp_stage_rows(B))
    seq = items(0 if x_b is not None else -1, 1 if x_n is not None else -1,
                K, kd.tp_gram_passes(B))
    # each bucket's stages staged once a pass, the v rows once a stage
    assert [k for t, k, _ in seq if t == 0] == (
        list(range(K)) if x_b is not None else [])
    assert [k for _, k, with_v in seq if with_v] == list(range(K))
    a_new, v_new = None, v
    if x_b is not None:
        t = lambda z: torch.tensor(np.array(z))  # noqa: E731
        deltas = sdca.bucket_solve(
            obj, t(total[..., 1:]), t(total[..., 0]), t(a), t(y),
            t(f32(lam_n)), t(f32(sig))).numpy()
        a_new = a + deltas
        v_new = v + (f32(sig) / f32(lam_n)) * row_dots(x_b, deltas)
    parts = None
    if x_n is not None:
        acc = np.zeros((CW, *g, B), f32)
        for w, f in group_rounds(d_loc, kd.tp_stage_rows(B), CW):
            acc[w] += rows_of(x_n, f, -2) * rows_of(v_new, f, -1)[..., None]
        parts = np.concatenate([group_sum(acc)[..., None], gram_walk(x_n)],
                               axis=-1)
    return a_new, v_new, parts


def subepoch_walk(obj, xb, yb, ab, v, M: int, lam_n: float, sig: float):
    """The fused loop on the walk: bucket 0's partials, then per
    bucket the lane-ordered sum and one step.  xb (W, nb, M*d_loc, B),
    yb / ab (W, nb, B), v (W, M*d_loc) -> (a_new (W, nb, B), v, the
    lanes' partials of every bucket (W, nb, M, B, 1 + B))."""
    W, nb, d, B = xb.shape
    x = xb.reshape(W, nb, M, d // M, B)
    vl = v.reshape(W, M, d // M)
    lanes = lambda t: np.broadcast_to(t[:, None], (W, M, B))  # noqa: E731
    a_new = np.empty_like(ab)
    seen = np.empty((W, nb, M, B, B + 1), f32)
    _, _, parts = step_walk(obj, None, None, x[:, 0], vl, None, None,
                            lam_n, sig)
    for b in range(nb):
        seen[:, b] = parts
        total = parts[:, 0]
        for m in range(1, M):
            total = total + parts[:, m]
        a_m, vl, parts = step_walk(
            obj, np.broadcast_to(total[:, None], (W, M, B, B + 1)), x[:, b],
            x[:, b + 1] if b + 1 < nb else None, vl, lanes(ab[:, b]),
            lanes(yb[:, b]), lam_n, sig)
        assert (a_m == a_m[:, :1]).all()           # every lane's duals
        a_new[:, b] = a_m[:, 0]
    return a_new, vl.reshape(W, d), seen


# ---- inputs ---------------------------------------------------------------

def inputs(objective: str, W: int, M: int, d_loc: int, B: int, nb: int,
           seed: int = 29):
    """Unit columns, labels and feasible duals (as chip_smoke.py's
    check makes them), tiled as `ops.dense_tiles` tiles them."""
    rng = np.random.default_rng(seed)
    d, n = M * d_loc, nb * B
    X = rng.standard_normal((W, d, n)).astype(f32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    v0 = (0.1 * rng.standard_normal((W, d))).astype(f32)
    y = rng.choice([-1.0, 1.0], size=(W, n)).astype(f32)
    if objective == "ridge":
        y = rng.standard_normal((W, n)).astype(f32)
        a = (0.1 * rng.standard_normal((W, n))).astype(f32)
    else:
        a = (y * rng.uniform(0.05, 0.5, size=(W, n))).astype(f32)
    lam_n, sig = 1e-3 * W * n, float(W)
    xb = np.ascontiguousarray(X.reshape(W, d, nb, B).transpose(0, 2, 1, 3))
    return X, y, a, v0, xb, lam_n, sig


def _within(what, got, want, tol=TOL_TP):
    rtol, atol = tol
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want)
    assert (err <= atol + rtol * np.abs(want)).all(), (
        f"{what}: max abs err {err.max()}")


# ---- tests ----------------------------------------------------------------

#: a lane's widths: epsilon's d/2 and d/4, and one ragged against the
#: stage's rows and the compute warps (2 stages at B 16, the last 5 rows)
D_LOCS = (1000, 500, 245)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("B", (16, 48))
@pytest.mark.parametrize("d_loc", D_LOCS)
def test_walk_within_tol_of_the_plain_pair(d_loc, B, objective):
    """A whole sub-epoch (2 workers x 2 lanes, 4 buckets) of the walk:
    each bucket's partials within TOL_TP of `sdca.tp_partials` on the
    same v, and the duals and v within TOL_TP of the plain pair's
    sub-epoch (`sdca.dense_local_subepoch` with model lanes)."""
    W, M, nb = 2, 2, 4
    obj = get_objective(objective)
    X, y, a, v0, xb, lam_n, sig = inputs(objective, W, M, d_loc, B, nb)
    yb, ab = y.reshape(W, nb, B), a.reshape(W, nb, B)
    a_w, v_w, seen = subepoch_walk(obj, xb, yb, ab, v0, M, lam_n, sig)
    a_p, dv_p = sdca.dense_local_subepoch(
        obj, torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(a),
        torch.from_numpy(v0), torch.tensor(f32(lam_n)),
        torch.tensor(f32(sig)), B, model_lanes=M)
    _within("duals", a_w.reshape(W, -1), a_p.numpy())
    _within("dv", (v_w - v0) / f32(sig), dv_p.numpy())
    # each bucket's partials against tp_partials on the walk's own v
    x = torch.from_numpy(xb).reshape(W, nb, M, d_loc, B)
    v = torch.from_numpy(v0).reshape(W, M, d_loc)
    for b in range(nb):
        want = sdca.tp_partials(x[:, b], v)
        _within(f"bucket {b}'s partials", seen[:, b], want.numpy())
        total = sdca.lane_ordered_sum(want)
        _, v = sdca.tp_solve(obj, total, x[:, b], torch.from_numpy(ab[:, b]),
                             torch.from_numpy(yb[:, b]), v,
                             torch.tensor(f32(lam_n)), torch.tensor(f32(sig)))


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_walk_lane_alone_equals_stacked(objective):
    """A lane walked alone (W 1, one lane) is bitwise the same lane of
    the stacked (W 4, Mh 2) walk: every launch's duals, v and partials,
    given the same summed partials."""
    W, M, d_loc, B, nb = 4, 2, 245, 16, 3
    obj = get_objective(objective)
    _, y, a, v0, xb, lam_n, sig = inputs(objective, W, M, d_loc, B, nb)
    yb, ab = y.reshape(W, nb, B), a.reshape(W, nb, B)
    x = xb.reshape(W, nb, M, d_loc, B)
    vl = v0.reshape(W, M, d_loc)
    lanes = lambda t: np.broadcast_to(t[:, None], (W, M, B))  # noqa: E731
    _, _, parts = step_walk(obj, None, None, x[:, 0], vl, None, None,
                            lam_n, sig)
    for b in range(nb):
        total = parts[:, 0] + parts[:, 1]
        nxt = x[:, b + 1] if b + 1 < nb else None
        got = step_walk(obj, np.broadcast_to(total[:, None],
                                             (W, M, B, B + 1)),
                        x[:, b], nxt, vl, lanes(ab[:, b]), lanes(yb[:, b]),
                        lam_n, sig)
        for w in range(W):
            for m in range(M):
                one = step_walk(
                    obj, total[w:w + 1, None].copy(),
                    x[w:w + 1, b, m:m + 1].copy(),
                    None if nxt is None else nxt[w:w + 1, m:m + 1].copy(),
                    vl[w:w + 1, m:m + 1].copy(),
                    ab[w:w + 1, b][:, None].copy(),
                    yb[w:w + 1, b][:, None].copy(), lam_n, sig)
                for s, o in zip(got, one):
                    if s is not None:
                        assert np.array_equal(s[w, m], o[0, 0]), (b, w, m)
        _, vl, parts = got


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_fused_loop_matches_unfused_plain_loop(objective):
    """`ops.sdca_bucket_tp_subepoch`, the fused loop (bucket 0's
    partials, then a step a bucket), on the CPU runs its steps' plain
    versions in sequence: bitwise the unfused plain loop (partials,
    sum, solve a bucket), and within TOL_TP of the walk and of the
    reference package's sub-epoch on the whole d (the lanes' sum is the
    whole tile's)."""
    W, M, d_loc, B, nb = 2, 2, 500, 16, 5
    obj = get_objective(objective)
    X, y, a, v0, xb, lam_n, sig = inputs(objective, W, M, d_loc, B, nb)
    t = torch.from_numpy
    ak, dvk = ops.sdca_bucket_tp_subepoch(obj, t(X), t(y), t(a), t(v0),
                                          lam_n, sig, bucket=B,
                                          model_lanes=M)
    ap, dvp = sdca.dense_local_subepoch(
        obj, t(X), t(y), t(a), t(v0), torch.tensor(f32(lam_n)),
        torch.tensor(f32(sig)), B, model_lanes=M)
    assert torch.equal(ak, ap) and torch.equal(dvk, dvp)
    a_w, v_w, _ = subepoch_walk(obj, xb, y.reshape(W, nb, B),
                                a.reshape(W, nb, B), v0, M, lam_n, sig)
    _within("walk duals", a_w.reshape(W, -1), ak.numpy())
    _within("walk dv", (v_w - v0) / f32(sig), dvk.numpy())
    for w in range(W):
        ar, dvr = ref_sdca.dense_local_subepoch(
            ref_objective(objective), jnp.asarray(X[w]), jnp.asarray(y[w]),
            jnp.asarray(a[w]), jnp.asarray(v0[w]), jnp.float32(lam_n),
            jnp.float32(sig), B)
        _within("reference duals", ak[w].numpy(), np.asarray(ar))
        _within("reference dv", dvk[w].numpy(), np.asarray(dvr))


def test_constants_read_against_the_source():
    """The Python mirrors of the step's layout are the .cu's constants,
    and the shared-memory model is the launcher's `layout_of` term for
    term: ten slots of a stage's x and v rows, a row of partials a
    compute warp, two v_new buffers, a / y / q / deltas and the staged
    [m0 | G] (the launcher refuses any other size, so the card checks
    the model too)."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src)
                   .group(1).split("//")[0].strip())
    assert const("kComputeWarps") == kd.TP_COMPUTE_WARPS
    assert const("kSlots") == kd.TP_SLOTS
    assert const("kSlotFloats") == kd.TP_SLOT_FLOATS
    assert const("kTile") == kd.TP_TILE
    assert const("kTotalSmemMaxB") == kd.TP_TOTAL_SMEM_MAX_B
    assert const("kMaxBucket") == kd.MAX_BUCKET
    assert re.search(r"constexpr int kThreads = 64 \+ kComputeThreads;", src)
    assert kd.TP_THREADS == 64 + 32 * kd.TP_COMPUTE_WARPS == 320
    assert "constexpr int kRedFloats = 32 * kTile * kTile;" in src
    body = re.search(r"Layout layout_of\(int B\) \{(.*?)\n\}", src, re.S)
    want = ("const int ng = kComputeWarps * lane_groups(B); // the rows' "
            "groups const int r = kSlotFloats / (B + 1) / ng * ng; L.rows = "
            "r > ng ? r : ng; L.x_floats = round4(L.rows * B + 3); L.slot_floats = "
            "L.x_floats + round4(L.rows + 3); L.total_in_smem = B <= "
            "kTotalSmemMaxB; const int floats = 4 * kSlots + kSlots * "
            "L.slot_floats + kComputeWarps * kRedFloats + 2 * "
            "round4(L.rows) + 4 * round4(B) + (L.total_in_smem ? "
            "round4(B * (B + 1)) : 0); L.bytes = 4 * floats;")
    assert " ".join(body.group(1).split()).replace("Layout L; ", "") \
        .replace(" return L;", "") == want
    assert "return 32 / (T < 32 ? T : 32);" in src
    assert [kd.tp_lane_groups(B) for B in (1, 8, 16, 20, 24, 48)] == [
        32, 10, 3, 2, 1, 1]
    assert [kd.tp_stage_rows(B) for B in (1, 16, 48, 64, 512)] == [
        2048, 240, 80, 56, 8]
    assert [kd.tp_gram_passes(B) for B in (16, 28, 29, 48, 512)] == [
        1, 1, 2, 3, 258]
    # the launcher takes exactly the model's bytes and raises on a misfit
    assert "smem_bytes != layout_of(B).bytes" in src
    assert re.search(r"cudaFuncAttributeMaxDynamicSharedMemorySize", src)
    # dense_recursion.cuh's sums: the pair uses B1's recursion alone
    for fn in ("margin_sum", "gram_sum", "update_sum"):
        assert fn not in src
    assert "bucket_recursion<OBJ, MPL>" in src
