"""Flash attention forward: the CUDA kernels and their plain version.

`flash_attention_kernel` runs online-softmax attention with causal,
local (window) or full masks and GQA in one launch, replacing the
reference's Pallas kernel
`repro/kernels/flash_attention.py:flash_attention_kernel`.  `route`
picks one of two hand-written kernels.  bf16 goes to
`csrc/flash_attention_tc.cu` (wgmma on the bf16 tensor cores) wherever
one of its instantiations covers the widths: hd and hd_v, multiples of
8, each rounded up to a multiple of 64, give a pair of `TC_HEAD_DIMS`,
as every served config's do (hd 64, 112, 128, 256; MLA's 192 / 128 and
96 / 64).  f32, and bf16 at any other hd, hd_v <= 256, go to
`csrc/flash_attention.cu` (f32 math on the CUDA cores: an f32
tensor-core product would be TF32, which the port does not use).  Both
keep the reference's public (B, S, H, hd) layout, so nothing is
transposed or padded in device memory: the tensor-core kernel reads q,
k and v through tensor maps with their own strides (MLA's v, a slice
of its kv tensor, is read in place) and fills the columns past the
real widths with zeros on chip; the CUDA-core kernel takes contiguous
copies.  kv is never padded either (the reference's `seq_k` has no
caller in the port), and keys past Sk in the last kv tile are masked by
the kernels' own ragged edge.  On a CPU tensor the same function runs
`flash_attention_plain`, the plain PyTorch version (the masked softmax
written out in f32); on a CUDA tensor it launches a kernel or raises.

The backward (`flash_attention_bwd`) has its own route, `bwd_route`.
bf16 at the padded width pairs of `BWD_TC_PAIRS` ((64, 64) and
(256, 256), what the full-width train runs launch) goes to
`csrc/flash_attention_bwd_tc.cu`: wgmma on the bf16 tensor cores, dq
(and each q tile's lse and rowsum(dO o)) a q tile a block, then dk and
dv a kv tile a block in the transposed frame, the heads of a GQA group
split over blocks and summed in order where the kv tiles alone would
leave SMs idle (`bwd_tc_head_split`).  It reads each row's log-sum-exp
from the forward, which the tensor-core forward writes where it is asked
to (`flash_attention_kernel(..., with_lse=True)`).  f32, and bf16 at
the other pairs, go to `csrc/flash_attention_bwd.cu`: two launches on
the CUDA cores (dq with each row's log-sum-exp and rowsum(dO o)
recomputed, then dk and dv a kv tile and kv head a block), f32 math.
Both are deterministic (no atomics).  Their plain version is
`flash_attention_bwd_plain`.  `FlashAttentionFn` is the differentiable
form, which `ops.flash_attention` always runs: the forward route above
(with lse where a grad is recorded and the backward takes it), and the
backward route (the plain version on CPU tensors).  Where no grad is
recorded it saves nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, costs
from .contracts import SMEM_OPTIN_BYTES

NEG_INF = -1e30
KINDS = {"causal": 0, "local": 1, "full": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head width (q/k and v) the CUDA-core kernel takes
MAX_HEAD_DIM = 256
#: the CUDA-core kernel's q-tile rows and kv-tile keys
#: (csrc/flash_attention.cu)
BQ = BK = 64
#: the bf16 tensor-core kernel's instantiations (`Tile` in
#: csrc/flash_attention_tc.cu), by padded (q/k width, v width): (consumer
#: warpgroups of TC_WG_ROWS q rows, K/V ring stages, producer warp)
TC_HEAD_DIMS = {(64, 64): (4, 4, True), (128, 64): (4, 4, True),
                (128, 128): (3, 4, False), (192, 128): (3, 3, False),
                (256, 256): (2, 2, False)}
#: the tensor-core kernel's rows of one consumer warpgroup, keys per kv
#: tile, and columns of one TMA box (the unit its widths are padded to)
TC_WG_ROWS = TC_BK = TC_COLS = 64
LOG2E = 1.4426950408889634

#: the backward kernel's q-tile rows and kv-tile keys
#: (csrc/flash_attention_bwd.cu)
BWD_BQ, BWD_BK = 64, 32
#: the tensor-core backward's instantiations (`Tile` in
#: csrc/flash_attention_bwd_tc.cu), by padded (q/k width, v width): (ring
#: stages, warpgroups of the dk / dv launch that share a kv tile, each
#: owning that share of the columns)
BWD_TC_PAIRS = {(64, 64): (2, 1), (256, 256): (2, 2)}
#: the tensor-core backward's q-tile rows and kv-tile keys
BWD_TC_BQ = BWD_TC_BK = 64
#: the dk / dv launch splits a GQA group's heads over blocks, one head a
#: block, where (kv tiles x B x Hkv) is below this many blocks (the
#: H100's SMs), so that it is deterministic for a shape on every card
BWD_TC_SPLIT_BELOW = 132

#: launches of either CUDA kernel (the plain version does not count),
#: and of each: the CUDA-core kernel and the bf16 tensor-core kernel
launches = 0
core_launches = 0
tc_launches = 0
#: calls of either backward kernel (each two or three launches: dq, then
#: dk and dv), and of each: the CUDA-core kernel and the tensor-core one
bwd_launches = 0
bwd_core_launches = 0
bwd_tc_launches = 0


def tc_widths(hd: int, hd_v: int) -> tuple[int, int]:
    """The padded (q/k, v) widths of the tensor-core instantiation that
    would take hd and hd_v: each rounded up to whole TMA boxes."""
    return -(-hd // TC_COLS) * TC_COLS, -(-hd_v // TC_COLS) * TC_COLS


def route(dtype: torch.dtype, hd: int, hd_v: int) -> str:
    """Which kernel takes these inputs: "tc" (bf16 where an instantiation
    of TC_HEAD_DIMS covers the widths; TMA reads rows whose byte stride
    is a multiple of 16, so hd and hd_v are multiples of 8: tensor cores)
    or "core" (f32, and bf16 at other widths: CUDA cores); raises on what
    neither takes."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_kernel: dtype {dtype} not "
                         f"supported (f32 or bf16)")
    if (dtype == torch.bfloat16 and hd > 0 and hd_v > 0 and hd % 8 == 0
            and hd_v % 8 == 0 and tc_widths(hd, hd_v) in TC_HEAD_DIMS):
        return "tc"
    if 0 < hd <= MAX_HEAD_DIM and 0 < hd_v <= MAX_HEAD_DIM:
        return "core"
    raise ValueError(f"flash_attention_kernel: head widths hd={hd}, "
                     f"hd_v={hd_v}; the CUDA-core kernel takes <= "
                     f"{MAX_HEAD_DIM}")


def bwd_route(dtype: torch.dtype, hd: int, hd_v: int) -> str:
    """Which backward kernel takes these inputs: "tc" (bf16 where the
    padded pair is one of BWD_TC_PAIRS, hd and hd_v multiples of 8:
    tensor cores) or "core" (f32, and bf16 at other widths: CUDA cores);
    raises on what neither takes."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_bwd: dtype {dtype} not "
                         f"supported (f32 or bf16)")
    if (dtype == torch.bfloat16 and hd > 0 and hd_v > 0 and hd % 8 == 0
            and hd_v % 8 == 0 and tc_widths(hd, hd_v) in BWD_TC_PAIRS):
        return "tc"
    if 0 < hd <= MAX_HEAD_DIM and 0 < hd_v <= MAX_HEAD_DIM:
        return "core"
    raise ValueError(f"flash_attention_bwd: head widths hd={hd}, "
                     f"hd_v={hd_v}; the kernel takes <= {MAX_HEAD_DIM}")


def kv_tile_range(q_start: int, rows: int, Sq: int, Sk: int, *, kind: str,
                  window: int, bk: int) -> tuple[int, int]:
    """[begin, end) of the kv tiles of `bk` keys that the q rows
    [q_start, q_start + rows) visit: the tiles their mask reaches, as
    both kernels compute it (per block, and per warpgroup in the
    tensor-core kernel)."""
    q_last = min(q_start + rows, Sq) - 1
    end = -(-Sk // bk)
    if kind != "full":
        end = min(end, q_last // bk + 1)
    begin = 0
    if kind == "local" and q_start - window + 1 > 0:
        begin = (q_start - window + 1) // bk
    return begin, max(begin, end)


def bwd_q_tile_range(k_start: int, Sq: int, Sk: int, *, kind: str,
                     window: int, bq: int = BWD_BQ,
                     bk: int = BWD_BK) -> tuple[int, int]:
    """[begin, end) of the q tiles of `bq` rows whose mask reaches keys
    [k_start, k_start + bk): the tiles a backward kernel's dk / dv
    launch walks for one kv tile (`q_tiles` in
    csrc/flash_attention_bwd.cu; `fa_bwd_tc_dkdv` in
    csrc/flash_attention_bwd_tc.cu at BWD_TC_BQ, BWD_TC_BK)."""
    end = -(-Sq // bq)
    begin = 0 if kind == "full" else k_start // bq
    if kind == "local":
        k_last = min(k_start + bk, Sk) - 1
        end = min(end, min(Sq - 1, k_last + window - 1) // bq + 1)
    return begin, max(begin, end)


def bwd_tc_head_split(B: int, Sk: int, H: int, Hkv: int) -> int:
    """Blocks a GQA group's heads are split over in the tensor-core
    backward's dk / dv launch: one head a block (H // Hkv) where the kv
    tiles alone, (kv tiles x B x Hkv) blocks, are fewer than
    BWD_TC_SPLIT_BELOW, else 1 (the whole group a block)."""
    G = H // Hkv
    if G > 1 and -(-Sk // BWD_TC_BK) * B * Hkv < BWD_TC_SPLIT_BELOW:
        return G
    return 1


def smem_bytes(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of one CUDA-core block, f32 whatever the
    input type: the Q tile, the transposed K tile, the V tile and the
    probability tile, with the kernel's +1 pads."""
    return 4 * (BQ * (hd + 1) + hd * (BK + 1) + BK * hd_v + BQ * (BK + 1))


def tc_tile(hd: int, hd_v: int) -> tuple[int, int, int]:
    """(q rows per block, keys per kv tile, K/V ring stages) of the
    tensor-core instantiation that takes hd and hd_v (`Config` in
    csrc/flash_attention_tc.cu)."""
    nc, stages, _ = TC_HEAD_DIMS[tc_widths(hd, hd_v)]
    return TC_WG_ROWS * nc, TC_BK, stages


def smem_bytes_tc(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of one tensor-core block: the bf16 Q tile
    and the ring's stages of K and V tiles at the padded widths, plus 1
    KB to align the swizzled tiles and 128 bytes of mbarriers."""
    hq, hv = tc_widths(hd, hd_v)
    bq, bk, stages = tc_tile(hd, hd_v)
    return 2 * (bq * hq + stages * bk * (hq + hv)) + 1024 + 128


def bwd_smem_bytes(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of one block of either backward launch, f32
    whatever the input type: the Q and dO tiles, the K and V tiles, the
    P / dS tile, each with the kernel's +1 pad, and the q tile's lse and
    D."""
    return 4 * (BWD_BQ * (hd + 1) + BWD_BQ * (hd_v + 1) + BWD_BK * (hd + 1)
                + BWD_BK * (hd_v + 1) + BWD_BQ * (BWD_BK + 1) + 2 * BWD_BQ)


def bwd_tc_smem_bytes(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of one block of either tensor-core backward
    launch (`Config::kSmem`, which its launcher requires): the fixed
    pair of 64-row bf16 tiles (Q and dO, or K and V) and the ring's
    stages of the other pair at the padded widths, each stage's lse and
    D of 64 rows (512 bytes), plus 1 KB to align the swizzled tiles and
    128 bytes of mbarriers."""
    hq, hv = tc_widths(hd, hd_v)
    stages, _ = BWD_TC_PAIRS[(hq, hv)]
    pair = 2 * 64 * (hq + hv)
    return (1 + stages) * pair + stages * 2 * BWD_TC_BQ * 4 + 1024 + 128


def _fn():
    fn = build.load("flash_attention").flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                   ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _fn_tc():
    fn = build.load("flash_attention_tc").flash_attention_tc_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                   ctypes.c_float, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def _fn_bwd():
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 10 + [i] * 9 + [ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _fn_bwd_tc():
    fn = build.load("flash_attention_bwd_tc").flash_attention_bwd_tc_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 12 + [i] * 9 + [f, f, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def mask(Sq: int, Sk: int, *, kind: str, window: int,
         device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which (query, key) pairs attend."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    if kind == "causal":
        return qpos >= kpos
    if kind == "local":
        return (qpos >= kpos) & (qpos - kpos < window)
    if kind == "full":
        return torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    raise ValueError(f"unknown attention kind {kind!r}")


def flash_attention_plain(q, k, v, *, kind: str = "causal", window: int = 0,
                          with_lse: bool = False):
    """The plain PyTorch version of `flash_attention_kernel`, same
    contract: the (Sq, Sk) scores in f32, masked to -1e30, softmax, then
    the weighted sum of v; with_lse: also each row's log-sum-exp of the
    masked scores, (B, H, Sq) f32."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (hd ** -0.5)
    ok = mask(Sq, Sk, kind=kind, window=window, device=q.device)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    o = o / torch.clamp_min(l, 1e-30)
    # contiguous, as the kernels write it
    o = o.permute(0, 3, 1, 2, 4).contiguous().reshape(B, Sq, H, hd_v) \
        .to(q.dtype)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def _tma_strides(t) -> list[int] | None:
    """t's (head, row, batch) element strides as the tensor-core
    kernel's tensor maps take them, or None where TMA cannot read t in
    place (columns not contiguous; a stride or the base not 16-byte
    aligned).  A dimension of size 1 is never stepped: its stride is
    taken as the contiguous one."""
    size, stride = t.shape, t.stride()
    if (stride[3] != 1 and size[3] > 1) or t.data_ptr() % 16:
        return None
    out, inner = [], size[3]
    for d in (2, 1, 0):
        s = stride[d] if size[d] > 1 else inner
        if s <= 0 or s % 8:
            return None
        out.append(s)
        inner = s * size[d]
    return out


def _launch_tc(q, k, v, kind: str, window: int, with_lse: bool = False):
    """The tensor-core kernel on checked bf16 inputs, each read with its
    own strides where TMA can (else from a contiguous copy); with_lse:
    also each row's log-sum-exp, (B, H, Sq) f32."""
    global launches, tc_launches
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    ts, strides = [], []
    for t in (q, k, v):
        st = _tma_strides(t)
        if st is None:
            t = t.contiguous()
            st = _tma_strides(t)
        ts.append(t)
        strides += st
    q, k, v = ts
    smem = smem_bytes_tc(hd, hd_v)
    o = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn_tc()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   None if lse is None else lse.data_ptr(),
                   B, Sq, Sk, H, Hkv, hd, hd_v, KINDS[kind], int(window),
                   hd ** -0.5 * LOG2E, (ctypes.c_longlong * 9)(*strides),
                   smem, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention tensor-core kernel launch failed: CUDA error "
            f"{err} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, hd={hd}, "
            f"hd_v={hd_v}, strides {strides}, {smem} bytes of shared "
            f"memory)")
    launches += 1
    tc_launches += 1
    return o if lse is None else (o, lse)


def _launch_core(q, k, v, kind: str, window: int):
    """The CUDA-core kernel on checked inputs, f32 or bf16 at any widths
    it takes (bf16 also where the tensor cores take them, for a caller
    that times one kernel against the other)."""
    global launches, core_launches
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    smem = smem_bytes(hd, hd_v)
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"flash_attention_kernel: {smem} bytes of shared "
                         f"memory exceed the {SMEM_OPTIN_BYTES}-byte opt-in")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                Sq, Sk, H, Hkv, hd, hd_v, KINDS[kind], int(window),
                hd ** -0.5, DTYPE_CODES[q.dtype], smem, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention CUDA-core kernel launch failed: CUDA error "
            f"{err} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, hd={hd}, "
            f"hd_v={hd_v}, {smem} bytes of shared memory)")
    launches += 1
    core_launches += 1
    return o


@costs.counted("flash_attention", costs.flash_attention_call)
def flash_attention_kernel(q, k, v, *, kind: str = "causal", window: int = 0,
                           with_lse: bool = False):
    """q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hd_v);
    H a multiple of Hkv (head h reads kv head h // (H // Hkv)); f32 or
    bf16, one dtype (`route` says which kernel takes them).  Returns
    (B, Sq, H, hd_v) in q's dtype; with_lse: (o, each row's log-sum-exp
    of the scaled, masked scores (B, H, Sq) f32), which only the
    tensor-core kernel writes (the backward it feeds takes only those
    widths).  On the `meta` device (the dry run's trace) the same
    checks, then empty outputs of those shapes: nothing runs or loads."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kind=kind, window=window,
                                     with_lse=with_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_kernel: unsupported device "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_kernel: q, k, v must be "
                         "(B, S, H, hd)")
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    if (k.shape[0] != B or k.shape[-1] != hd or tuple(v.shape[:3])
            != (B, Sk, Hkv) or Hkv <= 0 or H % Hkv or Sk <= 0):
        raise ValueError(f"flash_attention_kernel: shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not agree")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_kernel: {name} is "
                             f"{t.dtype} on {t.device}, q {q.dtype} on "
                             f"{q.device}")
    tc = route(q.dtype, hd, hd_v) == "tc"
    if with_lse and not tc:
        raise ValueError(f"flash_attention_kernel: lse is written by the "
                         f"tensor-core kernel only ({q.dtype}, hd={hd}, "
                         f"hd_v={hd_v})")
    if q.device.type == "meta":
        o = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
        if not with_lse:
            return o
        return o, torch.empty((B, H, Sq), dtype=torch.float32,
                              device=q.device)
    if tc:
        return _launch_tc(q, k, v, kind, window, with_lse)
    return _launch_core(q, k, v, kind, window)


def flash_attention_bwd_plain(q, k, v, o, do, *, kind: str = "causal",
                              window: int = 0):
    """The plain PyTorch version of `flash_attention_bwd`, same contract:
    the masked scores in f32, P from their log-sum-exp, D = rowsum(do o),
    then dv = P^T do, dS = P (do v^T - D), dq = scale dS k, dk = scale
    dS^T q.  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = hd ** -0.5
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    kf, vf = k.float(), v.float()
    dog = do.float().reshape(B, Sq, Hkv, G, hd_v)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    ok = mask(Sq, Sk, kind=kind, window=window, device=q.device)
    s = s.masked_fill(~ok, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse).masked_fill(~ok, 0.0)
    D = (dog * o.float().reshape(B, Sq, Hkv, G, hd_v)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    # contiguous, as the kernels write them
    return (dq.reshape(B, Sq, H, hd).to(q.dtype).contiguous(),
            dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous())


@costs.counted("flash_attention_bwd", costs.flash_attention_bwd_call)
def flash_attention_bwd(q, k, v, o, do, *, kind: str = "causal",
                        window: int = 0, lse=None):
    """dq, dk, dv of `flash_attention_kernel`'s o = attention(q, k, v)
    given do = dL/do (o and do (B, Sq, H, hd_v) in q's dtype).  CPU
    tensors run `flash_attention_bwd_plain`; CUDA tensors launch the
    kernel `bwd_route` names or raise: "tc" needs the forward's lse
    ((B, H, Sq) f32, `flash_attention_kernel(..., with_lse=True)`),
    "core" recomputes it (contiguous copies of what is not contiguous,
    as MLA's v, a slice of its kv).  On the `meta` device: the same
    checks, then empty gradients; nothing runs or loads."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, kind=kind,
                                         window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    which = bwd_route(q.dtype, hd, hd_v)
    if (tuple(k.shape) != (B, Sk, Hkv, hd) or tuple(v.shape[:3])
            != (B, Sk, Hkv) or Hkv <= 0 or H % Hkv or Sk <= 0):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"agree")
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {q.device}")
    if tuple(o.shape) != (B, Sq, H, hd_v) or o.shape != do.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be {(B, Sq, H, hd_v)}")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    if which == "core" and q.device.type == "meta":
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if which == "core":
        return _bwd_core(q, k, v, o, do, kind, window)
    if (lse is None or tuple(lse.shape) != (B, H, Sq)
            or lse.dtype != torch.float32 or lse.device != q.device):
        got = None if lse is None else (tuple(lse.shape), lse.dtype,
                                        lse.device)
        raise ValueError(f"flash_attention_bwd: the tensor-core backward "
                         f"reads the forward's lse, (B, H, Sq) = "
                         f"{(B, H, Sq)} f32 on {q.device}; got {got}")
    if q.device.type == "meta":
        return tuple(torch.empty_like(t) for t in (q, k, v))
    return _bwd_tc(q, k, v, o, do, lse.contiguous(), kind, window)


def _bwd_core(q, k, v, o, do, kind: str, window: int):
    """The CUDA-core backward on checked contiguous inputs, f32 or bf16 at
    any widths it takes (bf16 also where the tensor cores take them, for
    a caller that times one kernel against the other)."""
    global bwd_launches, bwd_core_launches
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    smem = bwd_smem_bytes(hd, hd_v)
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"flash_attention_bwd: {smem} bytes of shared "
                         f"memory exceed the {SMEM_OPTIN_BYTES}-byte opt-in")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dd = torch.empty_like(lse)
    err = _fn_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), lse.data_ptr(), dd.data_ptr(), B, Sq, Sk,
                    H, Hkv, hd, hd_v, KINDS[kind], int(window), hd ** -0.5,
                    DTYPE_CODES[q.dtype], smem,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward kernel launch failed: CUDA error "
            f"{err} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, hd={hd}, "
            f"hd_v={hd_v}, {smem} bytes of shared memory)")
    bwd_launches += 1
    bwd_core_launches += 1
    return dq, dk, dv


def _bwd_tc(q, k, v, o, do, lse, kind: str, window: int):
    """The tensor-core backward on checked contiguous bf16 inputs and the
    forward's lse: the scratch of each q tile's lse and D, and, where the
    dk / dv launch splits the heads (`bwd_tc_head_split`), the f32
    partials it sums."""
    global bwd_launches, bwd_tc_launches
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    smem = bwd_tc_smem_bytes(hd, hd_v)
    split = bwd_tc_head_split(B, Sk, H, Hkv)
    dev = q.device
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ld = torch.empty((B * H * -(-Sq // BWD_TC_BQ) * 2 * BWD_TC_BQ,),
                     dtype=torch.float32, device=dev)
    part_k = part_v = None
    if split > 1:
        part_k = torch.empty((B, Sk, Hkv * split, hd), dtype=torch.float32,
                             device=dev)
        part_v = torch.empty((B, Sk, Hkv * split, hd_v),
                             dtype=torch.float32, device=dev)
    err = _fn_bwd_tc()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ld.data_ptr(),
        None if part_k is None else part_k.data_ptr(),
        None if part_v is None else part_v.data_ptr(), B, Sq, Sk, H, Hkv,
        hd, hd_v, KINDS[kind], int(window), hd ** -0.5 * LOG2E, hd ** -0.5,
        split, smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention tensor-core backward launch failed: CUDA "
            f"error {err} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, "
            f"hd={hd}, hd_v={hd_v}, head split {split}, {smem} bytes of "
            f"shared memory)")
    bwd_launches += 1
    bwd_tc_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """B5 with its backward: the forward route of `flash_attention_kernel`
    (tensor cores or CUDA cores, unchanged), and `flash_attention_bwd` on
    the saved q, k, v and o, and lse where the backward reads it.
    `need_lse` (the caller records a grad: inside `forward` grad mode is
    off, so `ops.flash_attention` says so): the forward then also keeps
    each row's log-sum-exp where the backward takes it, on the CPU (the
    plain version's) and where `bwd_route` is "tc"."""

    @staticmethod
    def forward(ctx, q, k, v, kind: str, window: int, need_lse: bool):
        hd, hd_v = q.shape[-1], v.shape[-1]
        lse = None
        if need_lse and (q.device.type == "cpu"
                         or bwd_route(q.dtype, hd, hd_v) == "tc"):
            o, lse = flash_attention_kernel(q, k, v, kind=kind,
                                            window=window, with_lse=True)
        else:
            o = flash_attention_kernel(q, k, v, kind=kind, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kind, ctx.window = kind, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, kind=ctx.kind,
                                         window=ctx.window, lse=lse)
        return dq, dk, dv, None, None, None
