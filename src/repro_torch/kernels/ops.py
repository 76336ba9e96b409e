"""Wrappers around the CUDA kernels: padding, unscaling, misfit checks.

`sdca_bucket_subepoch` and `sdca_sparse_bucket_subepoch` are
call-compatible with `core.sdca.dense_local_subepoch` and
`core.sdca.sparse_local_subepoch` (with any number of leading worker
axes), so the engine routes a whole P*K worker stack through one kernel
launch; `sdca_sparse_sharded_subepoch` is the feature-sharded route,
every (worker, model lane) block in one launch per bucket, or one lane
a process with the working sets exchanged by a callable; and
`sdca_bucket_tp_subepoch` is dense tensor parallelism through the split
pair, the lanes' partials summed between its steps (one launch a bucket:
its solve and the next bucket's partials).
`rglru_scan` and `flash_attention` serve the LM: the RG-LRU recurrence
and online-softmax attention at the reference's public layouts.
`dense_tiles`, `sparse_tiles` and `sharded_tiles` own the layout of the
kernels' arguments (padding, tiling, the q precompute, the sharded
kernel's links).  The misfit
predicates say, on static shapes, whether a kernel
can take a workload; their budgets are the H100's: 227 KB of opt-in
shared memory per block, and global memory for what does not fit.
`plan_solver` is the door into the geometry planner (`core.planner`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.objectives import Objective
from repro_torch.core.sdca import row_sq_norms
from . import flash_attention as _fa
from . import rglru as _rglru
from . import sdca_bucket, sdca_sparse_bucket


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class MisfitCode:
    """Stable enum-style codes for kernel misfit reasons."""
    BUCKET_INDIVISIBLE = "BUCKET_INDIVISIBLE"   # B does not divide n_local
    BUCKET_CAP = "BUCKET_CAP"                   # dense recursion cap B<=512
    SMEM_ROW = "SMEM_ROW"                       # a row's products over smem


class Misfit(str):
    """A misfit reason string carrying its stable `MisfitCode`."""
    __slots__ = ("code",)
    code: str

    def __new__(cls, code: str, text: str) -> "Misfit":
        self = super().__new__(cls, text)
        self.code = code
        return self


def sparse_slice_width(d: int, model_lanes: int) -> int:
    """Per-lane slice width d_loc of the feature-sharded sparse route:
    ceil(d_pad / M) rounded up to a multiple of 8, with d_pad = d rounded
    up to a multiple of 8 — the reference's formula, so both packages
    cut the same slices.  Slices are contiguous, disjoint and cover
    [0, d) because d_loc * M >= d_pad."""
    d_pad = _round_up(max(d, 8), 8)
    M = max(int(model_lanes), 1)
    return _round_up(-(-d_pad // M), 8)


def sparse_solver_plan(n_local: int, nnz: int, d: int, bucket: int, *,
                       model_lanes: int = 1) -> tuple[str, Misfit | None]:
    """Data-parallel vs feature-parallel route on static shapes.

    -> (route, reason): "kernel" (the replicated kernel: v replicas in
    global memory, the bucket's links and working set in shared memory,
    or in global memory where they do not fit), "kernel-sharded" (each
    of `model_lanes` lanes owns a d/M slice of v; tiles, working set and
    scratch in global memory, one row's operands in shared memory where
    they fit) or "torch" with the misfit.  Prefers the replicated kernel
    (no per-bucket exchange) when its stages fit shared memory, and on
    a single lane.  Bucket divisibility misfits, and on one lane a row
    wider than the replicated kernel's row of products in shared memory
    (`sdca_sparse_bucket.row_fits_smem`; the sharded kernel takes any
    width); d never misfits (the card's 50 MB L2 holds the hot entries
    of v).
    """
    del d
    if bucket <= 0 or n_local % bucket:
        return "torch", Misfit(
            MisfitCode.BUCKET_INDIVISIBLE,
            f"bucket={bucket} does not divide n_local={n_local}")
    if model_lanes > 1 and not sdca_sparse_bucket.fits_smem(bucket, nnz):
        return "kernel-sharded", None
    if not sdca_sparse_bucket.row_fits_smem(nnz):
        return "torch", Misfit(
            MisfitCode.SMEM_ROW,
            f"nnz={nnz}: the replicated kernel keeps a row's products in "
            f"shared memory, above the opt-in past 58,112 nonzeros; a "
            f"layout with model lanes takes the sharded kernel")
    return "kernel", None


def plan_solver(n: int, d: int, *, nnz: int = 0, sparse: bool = False,
                name: str = "", bucket: int | None = None,
                chunks: int | None = None,
                nnz_multiple: int | None = None, model_lanes: int = 1,
                streamed: bool = False, cache_dir=None, probe_fn=None,
                spec=None, device="cuda"):
    """Geometry and route for a workload: -> `core.planner.SolverPlan`.

    The kernels-side door into the planner: the workload signature of
    (n, d, nnz, sparse), the topology of `device` (the card unless the
    caller asks for the CPU) with the pods and lanes of `spec` (an
    `EngineConfig`; one worker without it, as in the reference, whose
    door takes no deployment), and `planner.resolve_plan` under
    ``$REPRO_PLAN``, with the plan cached per (workload, topology).
    Knobs passed explicitly are kept.  ``streamed=True`` adds the
    host-to-device ingest bytes to the score and ``|st1`` to the
    workload's fingerprint.  `probe_fn(plan) -> seconds` times a
    candidate under ``$REPRO_PLAN=probe``; on the card what it raises
    propagates.
    """
    from repro_torch.core import planner
    sig = planner.WorkloadSignature(n=int(n), d=int(d), nnz=int(nnz),
                                    sparse=bool(sparse), name=name,
                                    streamed=bool(streamed))
    topo = planner.Topology.detect(spec, model_lanes=model_lanes,
                                   device=device)
    return planner.resolve_plan(sig, topo, bucket=bucket, chunks=chunks,
                                nnz_multiple=nnz_multiple,
                                cache_dir=cache_dir, probe_fn=probe_fn)


def sparse_kernel_misfit(n_local: int, nnz: int, d: int, bucket: int,
                         model_lanes: int = 1) -> Misfit | None:
    """Why no sparse kernel can run this workload, or None.

    The boolean view of `sparse_solver_plan`: None when a kernel takes
    the workload (the replicated one, or given `model_lanes` > 1 the
    sharded pair: every shape the one takes, the other takes too), so
    callers on a feature-sharded layout use it as the sharded verdict."""
    route, reason = sparse_solver_plan(n_local, nnz, d, bucket,
                                       model_lanes=model_lanes)
    return reason if route == "torch" else None


def dense_kernel_misfit(d: int, n_local: int, bucket: int) -> Misfit | None:
    """Why the dense kernel cannot run this workload, or None.

    The kernel takes any d and B, and tiles or Gram matrices that do
    not fit shared memory are read from global memory, so the only
    misfits are bucket divisibility and the recursion's B cap.
    """
    del d
    if bucket <= 0 or n_local % bucket:
        return Misfit(MisfitCode.BUCKET_INDIVISIBLE,
                      f"bucket={bucket} does not divide n_local={n_local}")
    if bucket > sdca_bucket.MAX_BUCKET:
        return Misfit(MisfitCode.BUCKET_CAP,
                      f"bucket={bucket} exceeds the kernel's in-bucket "
                      f"recursion cap of B <= {sdca_bucket.MAX_BUCKET}")
    return None


#: provenances whose rows are vouched for upstream: the Session checks
#: array sources at entry, and the registry's samplers dedupe rows.
#: Every other label gets checked host-side.
_TRUSTED_SOURCES = ("resident arrays",)


def _check_csr_invariant(idx, val, source: str) -> None:
    """Host-side check of the no-duplicate-nonzero CSR invariant for
    rows of untrusted provenance (a device-to-host copy and a sort)."""
    if any(source.startswith(s) for s in _TRUSTED_SOURCES):
        return
    from repro_torch.data.formats import raise_on_duplicate_nonzeros
    i = idx.detach().cpu().numpy()
    v = val.detach().cpu().numpy()
    raise_on_duplicate_nonzeros(i.reshape(-1, i.shape[-1]),
                                v.reshape(-1, v.shape[-1]),
                                f"{source}: sparse rows")


def _scalar(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def dense_tiles(Xl, yl, al, v0, *, bucket: int):
    """The dense kernel's arguments for a worker stack, as the wrapper
    launches it: (xb (W, nb, d, B), yb, ab (W, nb, B), v0 (W, d)), all
    f32, contiguous.

    Xl: (*w, d, n_local) columns in visiting order; yl/al (*w, n_local);
    v0 (*w, d).  Nothing is padded: the kernel takes any d and B (the
    reference pads both to multiples of 8 for the TPU's tiling; zero
    rows and columns would only add bytes, ~14 % at HIGGS' d = 28).
    """
    *w, d, n_local = Xl.shape
    W = math.prod(w)
    nb = n_local // bucket
    xb = Xl.reshape(W, d, nb, bucket).permute(0, 2, 1, 3)    # (W, nb, d, B)
    return (xb.float().contiguous(), yl.reshape(W, nb, bucket).float(),
            al.reshape(W, nb, bucket).float(), v0.reshape(W, d).float())


def _csr_tiles(idx, val, yl, al, *, bucket: int, source: str):
    """(idxb, valb (W, nb, B, nnz), yb, ab, qb (W, nb, B)) of a worker
    stack's padded-CSR rows; q = sum val^2 over the full chunk with the
    plain scan's exact expression, which carries the bitwise result."""
    *w, n_local, nnz = idx.shape
    W = math.prod(w)
    B = bucket
    if B <= 0 or n_local % B:
        raise ValueError(
            f"bucket={B} must divide the {source} chunk's row count "
            f"{n_local} (the engine hands the kernel whole buckets)")
    nb = n_local // B
    qb = row_sq_norms(val.float()).reshape(W, nb, B)
    return (idx.reshape(W, nb, B, nnz), val.reshape(W, nb, B, nnz),
            yl.reshape(W, nb, B), al.reshape(W, nb, B), qb)


def sparse_tiles(idx, val, yl, al, v0, *, bucket: int,
                 source: str = "ad-hoc arrays"):
    """The sparse kernel's arguments for a worker stack, as the wrapper
    launches it: (idxb, valb (W, nb, B, nnz), yb, ab, qb (W, nb, B),
    v0 (W, d_pad)).

    idx/val: (*w, n_local, nnz) padded-CSR rows in visiting order; v0:
    (*w, d).  Only d is padded (zero entries, never indexed).
    """
    tiles = _csr_tiles(idx, val, yl, al, bucket=bucket, source=source)
    W = tiles[0].shape[0]
    d = v0.shape[-1]
    d_pad = _round_up(max(d, 8), 8)
    v0p = torch.nn.functional.pad(v0.reshape(W, d).float(), (0, d_pad - d))
    return tiles + (v0p,)


def _bucket_links(idxb):
    """The sharded kernel's links of (W, nb, B, nnz) feature ids:
    (W, nb, 5, B*nnz) int32 planes pos, slot, run_len, group_len, rpos.

    Each bucket's entries (visiting order t = i*nnz + k) are sorted by
    (feature id, t), stably.  pos[t] is t's place in that order;
    slot[t] the place of the first entry of t's feature; run_len[t],
    for the first entry of a feature in a row, the row's count of that
    feature's entries (0 elsewhere); group_len[t], for the first entry
    of a feature in the bucket, the bucket's count (0 elsewhere);
    rpos[t] t's place when its row alone is sorted by (feature id, k),
    so a row's run of one feature is contiguous there from its first
    entry.  `csrc/sdca_sparse_sharded_bucket.cu` and
    `csrc/sparse_recursion.cuh` say how the kernel walks them.
    """
    W, nb, B, nnz = idxb.shape
    E = B * nnz
    ids, order = torch.sort(idxb.reshape(W * nb, E), dim=-1, stable=True)
    place = torch.arange(E, device=ids.device).expand_as(order)
    new_id = torch.ones_like(order, dtype=torch.bool)
    new_id[:, 1:] = ids[:, 1:] != ids[:, :-1]
    row = order // nnz
    new_run = new_id.clone()
    new_run[:, 1:] |= row[:, 1:] != row[:, :-1]

    def starts_and_lengths(new):
        first = torch.cummax(torch.where(new, place, 0), dim=-1).values
        count = torch.zeros_like(order).scatter_add_(
            1, first, torch.ones_like(order))
        return first, count

    first_id, id_len = starts_and_lengths(new_id)
    _, run_len = starts_and_lengths(new_run)
    pos = torch.empty_like(order).scatter_(1, order, place)
    row_order = torch.sort(idxb.reshape(W * nb * B, nnz), dim=-1,
                           stable=True).indices
    rpos = torch.empty_like(row_order).scatter_(
        1, row_order, torch.arange(nnz, device=ids.device).expand_as(
            row_order))
    planes = (pos, torch.gather(first_id, 1, pos),
              torch.gather(run_len, 1, pos), torch.gather(id_len, 1, pos),
              rpos.reshape(W * nb, E))
    return torch.stack(planes, 1).to(torch.int32).reshape(W, nb, 5, E)


def sharded_tiles(idx, val, yl, al, v0, *, bucket: int, model_lanes: int,
                  source: str = "ad-hoc arrays"):
    """The feature-sharded kernels' arguments for a worker stack, as
    `sdca_sparse_sharded_subepoch` launches them: (idxb, valb (Wk, nb,
    B, nnz), yb, ab, qb (Wk, nb, B), links (Wk, nb, 5, B*nnz), v_loc
    (Wk, M, d_loc)).

    idx/val: (*w, n_local, nnz) padded-CSR rows in visiting order; v0:
    (*w, d) each worker's replicated v.  v_loc is a fresh copy of v0,
    zero-padded to M * d_loc and cut into the M lanes' slices
    (`sparse_slice_width`); the sharded kernel updates it in place.
    """
    idxb, valb, yb, ab, qb = _csr_tiles(idx, val, yl, al, bucket=bucket,
                                        source=source)
    idxb = idxb.to(torch.int32).contiguous()
    valb = valb.float().contiguous()
    yb, ab = yb.float().contiguous(), ab.float().contiguous()
    Wk = idxb.shape[0]
    d = v0.shape[-1]
    M = max(int(model_lanes), 1)
    d_loc = sparse_slice_width(d, M)
    v_loc = torch.nn.functional.pad(v0.reshape(Wk, d).float(),
                                    (0, M * d_loc - d)).reshape(Wk, M, d_loc)
    return idxb, valb, yb, ab, qb, _bucket_links(idxb), v_loc


def sdca_bucket_subepoch(obj: Objective, Xl, yl, al, v0, lam_n, sig, *,
                         bucket: int, source: str = "ad-hoc arrays"):
    """Every worker's dense sub-epoch through the kernel.

    Xl: (*w, d, n_local) columns in visiting order; yl/al (*w, n_local);
    v0 (*w, d).  Returns (a_new, dv) with dv the UNSCALED global delta
    (CoCoA+ convention, as `dense_local_subepoch`).
    """
    *w, d, n_local = Xl.shape
    xb, yb, ab, v0p = dense_tiles(Xl, yl, al, v0, bucket=bucket)
    a_new, v_fin = sdca_bucket.sdca_bucket_kernel(
        obj, xb, yb, ab, v0p, float(lam_n), float(sig), source)

    a_out = a_new.reshape(*w, n_local)
    dv = (v_fin - v0p) / _scalar(sig, v0.device)
    return a_out.to(al.dtype), dv.reshape(*w, d).to(v0.dtype)


def sdca_sparse_bucket_subepoch(obj: Objective, idx, val, yl, al, v0,
                                lam_n, sig, *, bucket: int,
                                source: str = "ad-hoc arrays"):
    """Every worker's SPARSE sub-epoch through the kernel.

    idx/val: (*w, n_local, nnz) padded-CSR rows in visiting order; v0:
    (*w, d) replicated shared vector.  Returns (a_new, dv) with dv the
    UNSCALED global delta — call-compatible with
    `core.sdca.sparse_local_subepoch` and BITWISE equal to it on the
    same device.
    """
    _check_csr_invariant(idx, val, source)
    *w, n_local, _ = idx.shape
    d = v0.shape[-1]
    args = sparse_tiles(idx, val, yl, al, v0, bucket=bucket, source=source)
    a_new, v_fin = sdca_sparse_bucket.sdca_sparse_bucket_kernel(
        obj, *args, float(lam_n), float(sig), source)

    v0p = args[-1]
    a_out = a_new.reshape(*w, n_local)
    dv = (v_fin[:, :d] - v0p[:, :d]) / _scalar(sig, v0.device)
    return a_out.to(al.dtype), dv.reshape(*w, d).to(v0.dtype)


def owner_select(parts, idx_b, d_loc: int):
    """The exchanged working set from every lane's partial one: parts
    (M, Wk, B, nnz) in lane order, idx_b (Wk, B, nnz) the bucket's ids
    -> (Wk, B, nnz), each entry the bits of the lane that owns its
    feature (``idx // d_loc``).  Pure data movement: a sum of the
    partials would turn an owned -0.0 into +0.0."""
    owner = (idx_b.long() // d_loc)[None]
    return torch.gather(parts, 0, owner)[0].contiguous()


def sdca_sparse_sharded_subepoch(obj: Objective, idx, val, yl, al, v0,
                                 lam_n, sig, *, bucket: int,
                                 model_lanes: int, lane: int | None = None,
                                 exchange=None,
                                 source: str = "ad-hoc arrays"):
    """Every worker's FEATURE-SHARDED sparse sub-epoch.

    idx/val: (*w, n_local, nnz) padded-CSR rows in visiting order; v0:
    (*w, d) each worker's replicated v, of which lane m keeps only its
    slice [m*d_loc, (m+1)*d_loc) (`sparse_slice_width`).  Per bucket,
    two launches: (1) the gather gives each worker its exchanged
    working set, every entry the bits of the slice that owns its
    feature; (2) the recursion runs the bucket on every held lane and
    scatters each lane's owned entries into its slice.

    The stacked form (``lane`` None, the default) holds all
    `model_lanes` lanes on a tensor axis: the gather reads every slice,
    so it is the reference's per-lane gather, all-gather and
    owner-select as one load per entry (pure data movement, so the
    working set is bitwise the replicated kernel's).  The process form
    holds one lane, ``lane``: the gather is that lane's partial working
    set (exact +0.0 off its slice), ``exchange(partial)`` returns every
    lane's partial stacked in lane order, (M, Wk, B, nnz) (on a process
    mesh the ordered all-gather over 'model',
    `engine.MeshCollectives.gather_model`), each entry keeps its
    owner's bits (``idx // d_loc``; never a sum, which would lose
    -0.0), and the recursion runs this lane alone.

    Returns (a_new (*w, Mh, n_local), dv (*w, Mh, d)) for the Mh held
    lanes (M, or 1): every held lane's duals (all equal) and each held
    lane's UNSCALED global delta, zero outside its slice, so an ordered
    sum over the lanes gives the replicated dv.
    """
    _check_csr_invariant(idx, val, source)
    *w, n_local, nnz = idx.shape
    d = v0.shape[-1]
    M = max(int(model_lanes), 1)
    d_loc = sparse_slice_width(d, M)
    idxb, valb, yb, ab, qb, links, v_loc = sharded_tiles(
        idx, val, yl, al, v0, bucket=bucket, model_lanes=M, source=source)
    m0 = 0
    if lane is not None:
        if exchange is None or not 0 <= lane < M:
            raise ValueError(f"the process form holds lane {lane} of {M} "
                             f"and needs an exchange")
        m0 = int(lane)
        v_loc = v_loc[:, m0:m0 + 1].contiguous()
    Wk, nb, B, _ = idxb.shape
    Mh = v_loc.shape[1]
    v_loc0 = v_loc.clone()
    a_new = torch.empty((Wk, Mh, nb, B), dtype=torch.float32,
                        device=idx.device)
    for b in range(nb):
        W = sdca_sparse_bucket.sdca_sparse_gather_bucket(
            idxb, b, v_loc, m0, source=source)
        if lane is not None:
            W = owner_select(exchange(W), idxb[:, b], d_loc)
        a_new[:, :, b] = sdca_sparse_bucket.sdca_sparse_sharded_bucket(
            obj, idxb, valb, yb, ab, qb, links, b, W, v_loc, float(lam_n),
            float(sig), source, m0=m0)
    dv_loc = (v_loc - v_loc0) / _scalar(sig, v0.device)
    dv = torch.zeros((Wk, Mh, M, d_loc), dtype=torch.float32,
                     device=v0.device)
    for h in range(Mh):
        dv[:, h, m0 + h] = dv_loc[:, h]
    dv = dv.reshape(Wk, Mh, M * d_loc)[..., :d]
    return (a_new.reshape(*w, Mh, n_local).to(al.dtype),
            dv.reshape(*w, Mh, d).to(v0.dtype))


def sdca_bucket_tp_subepoch(obj: Objective, Xl, yl, al, v0, lam_n, sig, *,
                            bucket: int, model_lanes: int, reduce=None,
                            source: str = "ad-hoc arrays"):
    """Every worker's dense TENSOR-PARALLEL sub-epoch through the split
    pair's step (`sdca_bucket.sdca_bucket_tp_step`).

    Xl: (*w, Mh*d_loc, n_local) each worker's held lanes' rows in lane
    order, columns in visiting order; yl/al (*w, n_local); v0 (*w,
    Mh*d_loc) the lanes' slices of v.  Bucket 0's partials of every held
    lane, then per bucket b: ``reduce`` over the model lanes ((W, Mh, B,
    1 + B) -> (W, B, 1 + B); default `core.sdca.lane_ordered_sum`, the
    stacked form, all lanes held; on a process mesh, one lane a rank,
    the ordered all-gather sum over 'model', `engine.MeshCollectives.
    model_sum`), then one step: b's solve and b+1's partials (nb + 1
    launches in all).  Returns (a_new (*w, n_local), dv (*w,
    Mh*d_loc)) with dv the UNSCALED delta of the held rows, as
    `core.sdca.dense_local_subepoch` with ``model_lanes``.
    """
    from repro_torch.core.sdca import lane_ordered_sum
    reduce = lane_ordered_sum if reduce is None else reduce
    *w, d, n_local = Xl.shape
    Mh = int(model_lanes)
    xb, yb, ab, v = dense_tiles(Xl, yl, al, v0, bucket=bucket)
    yb, ab = yb.contiguous(), ab.contiguous()
    v = v.contiguous().clone()                     # updated in place
    v_start = v.clone()
    W, nb, _, B = xb.shape
    a_new = torch.empty((W, nb, B), dtype=torch.float32, device=xb.device)

    def step(total, b):
        return sdca_bucket.sdca_bucket_tp_step(
            obj, total, xb, yb, ab, v, b, float(lam_n), float(sig),
            model_lanes=Mh, source=source)

    parts = step(None, -1)[1] if nb else None
    for b in range(nb):
        a_b, parts = step(reduce(parts).contiguous(), b)
        a_new[:, b] = a_b[:, 0]
    dv = (v - v_start) / _scalar(sig, v0.device)
    return (a_new.reshape(*w, n_local).to(al.dtype),
            dv.reshape(*w, d).to(v0.dtype))


def rglru_scan(x, a_log, gate_a, gate_x, h0):
    """The RG-LRU recurrence (kernels/rglru.py) over T.

    x, gate_a, gate_x: (T, D) with h0 (D,), or (B, T, D) with h0 (B, D);
    a_log: (D,).  Returns (h in x's dtype, the final state in f32 with
    h0's shape).  The reference's wrapper returns h only; the final
    state is its kernel's second output, which seeds the decode cache.
    No padding or blocking of T: the CUDA kernel walks any T and D."""
    if x.dim() == 2:
        h, h_last = _rglru.rglru_kernel(x[None], a_log, gate_a[None],
                                        gate_x[None], h0.reshape(1, -1))
        return h[0], h_last[0]
    return _rglru.rglru_kernel(x, a_log, gate_a, gate_x, h0)


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0):
    """(B, S, H, hd) flash attention (kernels/flash_attention.py).

    q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hd_v); the
    GQA group is H // Hkv and the true kv length is Sk.  Unlike the
    reference's wrapper nothing is padded: the CUDA kernels mask their
    own ragged edge (f32: any hd, hd_v <= 256; bf16 the same, on the
    tensor cores at every width pair of `flash_attention.TC_HEAD_DIMS`,
    whose padding to 64 columns is done on chip)."""
    return _fa.flash_attention_kernel(q, k, v, kind=kind, window=window)
