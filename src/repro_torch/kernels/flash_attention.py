"""Flash attention forward: the CUDA kernel and its plain version.

`flash_attention_kernel` runs online-softmax attention with causal,
local (window) or full masks, GQA, and keys past `seq_k` masked, in one
launch (`csrc/flash_attention.cu`, which replaces the reference's
Pallas kernel `repro/kernels/flash_attention.py:flash_attention_kernel`).
It keeps the reference's public (B, S, H, hd) layout: the CUDA kernel
reads and writes it with strides, so nothing is transposed or padded.
On a CPU tensor the same function runs `flash_attention_plain`, the
plain PyTorch version (the masked softmax written out in f32); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .contracts import SMEM_OPTIN_BYTES

NEG_INF = -1e30
KINDS = {"causal": 0, "local": 1, "full": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head width (q/k and v) the kernel takes
MAX_HEAD_DIM = 256
#: the kernel's q-tile rows and kv-tile keys (csrc/flash_attention.cu)
BQ = BK = 64

#: launches of the CUDA kernel (the plain version does not count)
launches = 0


def smem_bytes(hd: int, hd_v: int) -> int:
    """Dynamic shared memory of one block: the f32 Q tile, the
    transposed K tile, the V tile and the probability tile, with the
    kernel's +1 pads."""
    return 4 * (BQ * (hd + 1) + hd * (BK + 1) + BK * hd_v + BQ * (BK + 1))


def _fn():
    fn = build.load("flash_attention").flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                   ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def mask(Sq: int, Sk: int, *, kind: str, window: int, seq_k: int,
         device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which (query, key) pairs attend."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = kpos < seq_k
    if kind == "causal":
        ok = ok & (qpos >= kpos)
    elif kind == "local":
        ok = ok & (qpos >= kpos) & (qpos - kpos < window)
    elif kind != "full":
        raise ValueError(f"unknown attention kind {kind!r}")
    return ok


def flash_attention_plain(q, k, v, *, kind: str = "causal", window: int = 0,
                          seq_k: int | None = None):
    """The plain PyTorch version of `flash_attention_kernel`, same
    contract: the (Sq, Sk) scores in f32, masked to -1e30, softmax, then
    the weighted sum of v."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    seq_k = Sk if seq_k is None else seq_k
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (hd ** -0.5)
    ok = mask(Sq, Sk, kind=kind, window=window, seq_k=seq_k, device=q.device)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    o = o / torch.clamp_min(l, 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v).to(q.dtype)


def flash_attention_kernel(q, k, v, *, kind: str = "causal", window: int = 0,
                           seq_k: int | None = None):
    """q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hd_v);
    H a multiple of Hkv (head h reads kv head h // (H // Hkv)); f32 or
    bf16, one dtype.  seq_k: the true kv length (keys at or past it are
    masked), default Sk.  Returns (B, Sq, H, hd_v) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kind=kind, window=window,
                                     seq_k=seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel: unsupported device "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_kernel: q, k, v must be "
                         "(B, S, H, hd)")
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_kernel: dtype {q.dtype} not "
                         f"supported (f32 or bf16)")
    if (k.shape[0] != B or k.shape[-1] != hd or tuple(v.shape[:3])
            != (B, Sk, Hkv) or Hkv <= 0 or H % Hkv):
        raise ValueError(f"flash_attention_kernel: shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not agree")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_kernel: {name} is "
                             f"{t.dtype} on {t.device}, q {q.dtype} on "
                             f"{q.device}")
    if hd > MAX_HEAD_DIM or hd_v > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_kernel: head widths hd={hd}, "
                         f"hd_v={hd_v}; the kernel takes <= {MAX_HEAD_DIM}")
    seq_k = Sk if seq_k is None else int(seq_k)
    if not 0 < seq_k <= Sk:
        raise ValueError(f"flash_attention_kernel: seq_k={seq_k} outside "
                         f"(0, {Sk}]")
    smem = smem_bytes(hd, hd_v)
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"flash_attention_kernel: {smem} bytes of shared "
                         f"memory exceed the {SMEM_OPTIN_BYTES}-byte opt-in")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, Sq, Sk, H, Hkv, hd, hd_v, KINDS[kind], int(window), seq_k,
                hd ** -0.5, DTYPE_CODES[q.dtype], smem,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"(B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, hd={hd}, "
            f"hd_v={hd_v}, {smem} bytes of shared memory)")
    launches += 1
    return o
