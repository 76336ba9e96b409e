"""The backward of B5 (flash attention) and B6 (RG-LRU) on the CPU.

`flash_attention_bwd_plain`, the plain version of
`csrc/flash_attention_bwd.cu`, against `jax.vjp` of the reference's
`blocked_attention` (what the reference's train step differentiates off
the TPU) for every mask, GQA, MLA's hd != hd_v and cross-attention (Sq
!= Sk), and against torch autograd through the port's own
`blocked_attention`; `rglru_bwd_plain` against `jax.vjp` of the
reference's `_rglru_scan`, with a cotangent on the final state too.  The
autograd `Function`s send CPU tensors to the plain versions and refuse
any other non-CUDA device (no fallback).  The kernel's tile walk is
mirrored in Python (`kv_tile_range`, `bwd_q_tile_range`): every
unmasked (query, key) pair lies in a visited tile, for both launches.
B6's backward kernel's phases (the gates, the two chains, the
gradients, d a_log's sum from the end) are mirrored in PyTorch and
held `torch.equal` to `rglru_bwd_plain`: the split reorders no
rounding.

Tolerances (f32, inputs from numpy seeds): dq, dk, dv within atol 2e-5,
rtol 1e-4 of the reference (measured at most 2.9e-6 abs on these
shapes: the two frameworks sum in other orders), and of torch autograd
through the port's blocked attention (measured 1.9e-6); the RG-LRU
gradients within rtol 1e-4, atol 1e-5 of the reference's (the same
recurrence walked backwards against an associative scan's vjp; measured
3.8e-6 abs, 2.1e-7 of the largest).  CPU seconds: about 22, most of it
JAX's tracing of the reference.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import blocked_attention as ref_blocked  # noqa: E402
from repro.models.recurrent import _rglru_scan as ref_scan  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru as rg  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

#: (B, Sq, Sk, H, Hkv, hd, hd_v, kinds): GQA at hd 64, MQA at hd 256
#: local, MLA's 192 / 128 and 96 / 64, a ragged hd 112, cross-attention
#: Sq != Sk (full), and a group of one
CASES = [(2, 37, 37, 6, 2, 16, 16, ("causal", "local", "full")),
         (1, 40, 40, 4, 1, 32, 32, ("causal", "local")),
         (2, 33, 33, 4, 4, 24, 16, ("causal", "full")),
         (1, 29, 29, 3, 3, 12, 8, ("causal",)),
         (2, 21, 45, 4, 2, 16, 16, ("full",)),
         (1, 45, 21, 2, 1, 8, 8, ("full",))]
WINDOW = 7
ATOL, RTOL = 2e-5, 1e-4


def _inputs(B, Sq, Sk, H, Hkv, hd, hd_v, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return f(B, Sq, H, hd), f(B, Sk, Hkv, hd), f(B, Sk, Hkv, hd_v), \
        f(B, Sq, H, hd_v)


def _cases():
    for c in CASES:
        for kind in c[7]:
            name = "x".join(map(str, c[:7]))
            yield pytest.param(c[:7], kind, id=f"{kind}-{name}")


@pytest.mark.parametrize("shape,kind", list(_cases()))
def test_bwd_plain_matches_reference_vjp(shape, kind):
    q, k, v, do = _inputs(*shape)
    Sq = shape[1]
    qpos = jnp.arange(Sq)

    def f(q, k, v):
        return ref_blocked(q, k, v, q_positions=qpos, kind=kind,
                           window=WINDOW, chunk=16)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    got = fa.flash_attention_bwd_plain(t[0], t[1], t[2],
                                       torch.from_numpy(np.array(o)),
                                       t[3], kind=kind, window=WINDOW)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("shape,kind", list(_cases()))
def test_bwd_plain_equals_autograd_of_blocked_attention(shape, kind):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(*shape, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attn.blocked_attention(*leaves, q_positions=torch.arange(shape[1]),
                               kind=kind, window=WINDOW, chunk=16)
    want = torch.autograd.grad(o, leaves, do)
    got = fa.flash_attention_bwd_plain(q, k, v, o.detach(), do, kind=kind,
                                       window=WINDOW)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_attention_function_routes_cpu_to_plain(monkeypatch):
    """`ops.flash_attention` runs `FlashAttentionFn`: forward and
    backward on the plain versions for CPU tensors (the kernels are never
    loaded, no launch is counted), the same gradients as calling
    `flash_attention_bwd_plain` directly; without a grad recorded (no
    grad, inference mode) it builds no node and the same output."""
    calls = []
    real = fa.flash_attention_bwd_plain
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(build, "load", lambda stem: pytest.fail(stem))
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(2, 19, 19, 4, 2, 8, 8))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa.bwd_launches
    o = ops.flash_attention(*leaves, kind="causal")
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    assert calls == [1] and fa.bwd_launches == before
    want = real(q, k, v, o.detach(), do, kind="causal")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert ops.flash_attention(*leaves, kind="causal").grad_fn is None
    with torch.inference_mode():
        o_inf = ops.flash_attention(q, k, v, kind="causal")
    assert o_inf.grad_fn is None and torch.equal(o_inf, o.detach())


class _OtherDevice(torch.Tensor):
    """A CPU tensor that says it lives on a device the port has no route
    for (`meta` is the dry run's shape-only route)."""
    @property
    def device(self):
        return torch.device("xpu")


def test_bwd_refuses_other_devices(monkeypatch):
    """No fallback: off the CPU the backward launches its kernel or
    raises; it never runs the plain version (on `meta` it returns empty
    gradients and runs nothing)."""
    def refuse(*a, **k):
        raise AssertionError("the plain backward ran")
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", refuse)
    monkeypatch.setattr(rg, "rglru_bwd_plain", refuse)
    q = torch.empty((1, 4, 2, 8)).as_subclass(_OtherDevice)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(q, q[:, :, :1], q[:, :, :1], q, q)
    x = torch.empty((1, 4, 8)).as_subclass(_OtherDevice)
    with pytest.raises(ValueError, match="unsupported device"):
        rg.rglru_bwd(x, x[0, 0], x, x, x[:, 0], x, x[:, 0])
    q = torch.empty((1, 4, 2, 8), device="meta")
    dq, dk, dv = fa.flash_attention_bwd(q.float(), q[:, :, :1].float(),
                                        q[:, :, :1].float(), q.float(),
                                        q.float())
    assert (dq.device.type, dq.shape, dk.shape) == ("meta", q.shape,
                                                    (1, 4, 1, 8))
    x = torch.empty((1, 4, 8), device="meta")
    grads = rg.rglru_bwd(x, x[0, 0], x, x, x[:, 0], x, x[:, 0])
    assert [g.shape for g in grads] == [x.shape, (8,), x.shape, x.shape,
                                        (1, 8)]


def test_rglru_bwd_plain_matches_reference_vjp():
    rng = np.random.default_rng(3)
    B, T, D = 2, 50, 12
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    x, ga, gx = f(B, T, D), f(B, T, D), f(B, T, D)
    a_log = -rng.uniform(0.05, 1.0, D).astype(np.float32)
    h0, dh, dl = f(B, D) * 0.3, f(B, T, D), f(B, D)
    _, vjp = jax.vjp(lambda *a: ref_scan(*a), *(jnp.asarray(a) for a in (
        x, a_log, ga, gx, h0)))
    want = vjp((jnp.asarray(dh), jnp.asarray(dl)))
    got = rg.rglru_bwd_plain(*(torch.from_numpy(a) for a in (
        x, a_log, ga, gx, h0, dh, dl)))
    for name, g, w in zip(("dx", "da_log", "dga", "dgx", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_rglru_function_routes_cpu_to_plain(monkeypatch):
    """`ops.rglru_scan` runs `RGLRUFn`; its backward is
    `rglru_bwd_plain` on CPU tensors (no kernel loaded), with a zero
    cotangent where the caller drops the final state; equal to torch
    autograd through the plain forward."""
    calls = []
    real = rg.rglru_bwd_plain
    monkeypatch.setattr(rg, "rglru_bwd_plain",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(build, "load", lambda stem: pytest.fail(stem))
    rng = np.random.default_rng(4)
    B, T, D = 2, 17, 6
    x, ga, gx = (torch.from_numpy(rng.standard_normal((B, T, D)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))
    a_log = torch.from_numpy(-rng.uniform(0.1, 1, D).astype(
        np.float32)).requires_grad_(True)
    h0 = torch.zeros((B, D))
    before = rg.bwd_launches
    h, _ = ops.rglru_scan(x, a_log, ga, gx, h0)
    dh = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    got = torch.autograd.grad(h, (x, a_log, ga, gx), dh)
    assert calls == [1] and rg.bwd_launches == before
    hp, _ = rg.rglru_plain(x, a_log, ga, gx, h0)     # autograd's own
    want = torch.autograd.grad(hp, (x, a_log, ga, gx), dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_bwd_tile_walks_cover_every_unmasked_pair(kind):
    """The kernel's two walks, mirrored: a q tile visits the kv tiles of
    `kv_tile_range` (launch 1), a kv tile the q tiles of
    `bwd_q_tile_range` (launch 2); each covers every unmasked pair."""
    BQ, BK = fa.BWD_BQ, fa.BWD_BK
    for Sq, Sk, window in ((130, 130, 7), (64, 200, 70), (200, 64, 33),
                           (257, 257, 64), (31, 31, 1), (100, 100, 2048)):
        ok = fa.mask(Sq, Sk, kind=kind, window=window).numpy()
        seen1 = np.zeros_like(ok)
        for qs in range(0, Sq, BQ):
            b, e = fa.kv_tile_range(qs, BQ, Sq, Sk, kind=kind,
                                    window=window, bk=BK)
            seen1[qs:qs + BQ, b * BK:e * BK] = True
        seen2 = np.zeros_like(ok)
        for ks in range(0, Sk, BK):
            b, e = fa.bwd_q_tile_range(ks, Sq, Sk, kind=kind, window=window)
            seen2[b * BQ:e * BQ, ks:ks + BK] = True
        assert not (ok & ~seen1).any() and not (ok & ~seen2).any(), (
            Sq, Sk, window)


def test_bwd_kernel_constants_match_source():
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kBQ"]), int(consts["kBK"])) == (fa.BWD_BQ,
                                                        fa.BWD_BK)
    assert fa.bwd_smem_bytes(256, 256) == 206_336
    assert fa.bwd_smem_bytes(64, 64) == 58_880
    assert max(fa.bwd_smem_bytes(a, b) for a in range(8, 257, 8)
               for b in range(8, 257, 8)) <= fa.SMEM_OPTIN_BYTES


def _rglru_bwd_phases(x, a_log, gate_a, gate_x, h0, dh, dh_last):
    """A mirror of csrc/rglru_bwd.cu's launches: (1) the gates of every
    step at once, b = sqrt(max(z, 1e-12)) (i x) and dh in f32; (2) the
    two chains, h forward from h0 and g backward from dh_last, each only
    its multiply and add; (3) every step's gradients at once, from r, i,
    z and the square root recomputed and a, e2, h_{t-1}, g; (4) d a_log's
    terms summed from t = T - 1 down to 0, then over the batch rows."""
    exp = rg._exp
    r = torch.sigmoid(gate_a.float())                       # 1. gates
    iv = torch.sigmoid(gate_x.float())
    la = (rg.RG_C * a_log.float()) * r
    e2 = exp(2.0 * la)
    a = exp(la)
    b = torch.sqrt(torch.clamp_min(1.0 - e2, 1e-12)) * (iv * x.float())
    dhf = dh.float()
    T = x.shape[1]
    h, hs = h0.float(), torch.empty_like(a)                 # 2. chains
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    carry, g = dh_last.float(), torch.empty_like(a)
    for t in range(T - 1, -1, -1):
        g[:, t] = dhf[:, t] + carry
        carry = a[:, t] * g[:, t]
    r = torch.sigmoid(gate_a.float())                       # 3. gradients
    iv = torch.sigmoid(gate_x.float())
    xf = x.float()
    z = 1.0 - e2
    sq = torch.sqrt(torch.clamp_min(z, 1e-12))
    u = iv * xf
    hp = torch.cat([h0.float()[:, None], hs[:, :-1]], dim=1)
    da, du, dsq = g * hp, g * sq, g * u
    dx = du * iv
    dgx = (du * xf) * (iv * (1.0 - iv))
    dmax = dsq * (torch.full_like(sq, 0.5) / sq)
    dz = torch.where(z > 1e-12, dmax, torch.where(
        z == 1e-12, 0.5 * dmax, torch.zeros_like(dmax)))
    dla = da * a + 2.0 * (-dz * e2)
    term = dla * r
    dga = (dla * (rg.RG_C * a_log.float())) * (r * (1.0 - r))
    dal = torch.zeros_like(h)                               # 4. d a_log
    for t in range(T - 1, -1, -1):
        dal = dal + term[:, t]
    return (dx.to(x.dtype), rg._batch_sum(8.0 * dal), dga.to(gate_a.dtype),
            dgx.to(gate_x.dtype), carry)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D", [(3, 77, 80), (2, 1, 77)])
def test_rglru_bwd_phase_split_equals_plain(B, T, D, dtype):
    """The kernel's phase split (gates, then chains, then gradients, then
    d a_log's ordered sum) reorders no rounding: torch.equal to
    `rglru_bwd_plain`."""
    rng = np.random.default_rng(B * T + D)
    f = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, ga, gx, dh = (f(B, T, D).to(dtype) for _ in range(4))
    a_log = torch.from_numpy(-rng.uniform(0.0, 0.5, D).astype(np.float32))
    h0, dl = f(B, D) * 0.1, f(B, D)
    got = _rglru_bwd_phases(x, a_log, ga, gx, h0, dh, dl)
    want = rg.rglru_bwd_plain(x, a_log, ga, gx, h0, dh, dl)
    for name, g, w in zip(("dx", "da_log", "dga", "dgx", "dh0"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_rglru_bwd_constants_match_source():
    src = (build.CSRC / "rglru_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kLanes"]), int(consts["kTile"]),
            int(consts["kStages"])) == (rg.BWD_LANES, rg.BWD_TILE,
                                        rg.BWD_STAGES)
    assert "2 * kRingFloats * 4" in src
    assert rg.bwd_smem_bytes() == 2 * 12 * 32 * 32 * 4 == 98_304
