"""The port's flash attention (B5) against the JAX package.

On the CPU `repro_torch.kernels.ops.flash_attention` runs the kernel's
plain version (the masked softmax written out in f32).  It is held to
the reference's Pallas kernel in interpret mode
(`repro.kernels.ops.flash_attention(..., interpret=True)`) and to the
reference's `blocked_attention`, with the reference's own tolerances
(tests/test_kernels.py): 2e-4 in f32, 5e-2 in bf16.  The port's
`blocked_attention` (its decode/CPU path) is held to the reference's
the same way.  Inputs are drawn with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models.attention import blocked_attention as ref_blocked  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

WINDOW = 24
TOL = {np.float32: 2e-4, "bfloat16": 5e-2}

# (B, Sq, Sk, H, Hkv, hd, hd_v)
SHAPES = {
    "gqa": (2, 64, 64, 4, 2, 32, 32),
    "mqa_hdv": (1, 64, 64, 4, 1, 32, 16),
    "sq_lt_sk": (1, 32, 64, 2, 2, 32, 32),
    "ragged": (2, 48, 48, 2, 2, 16, 16),
    "ragged_mqa_hd256": (1, 75, 75, 4, 1, 256, 256),
}


def _inputs(shape, seed, dtype=np.float32):
    B, Sq, Sk, H, Hkv, hd, hd_v = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd_v)).astype(np.float32)
    return q, k, v


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(a).to(dtype)


def _cases():
    for kind in ("causal", "local", "full"):
        for name, shape in SHAPES.items():
            if kind == "causal" and shape[1] != shape[2]:
                continue        # causal needs aligned positions
            yield pytest.param(kind, shape, id=f"{kind}-{name}")


@pytest.mark.parametrize("kind,shape", list(_cases()))
def test_plain_matches_reference_kernel_and_blocked(kind, shape):
    q, k, v = _inputs(shape, seed=sum(shape))
    out = ops.flash_attention(_t(q), _t(k), _t(v), kind=kind, window=WINDOW)
    ref_k = ref_ops.flash_attention(_j(q), _j(k), _j(v), kind=kind,
                                    window=WINDOW, bq=16, bk=16,
                                    interpret=True)
    ref_b = ref_blocked(_j(q), _j(k), _j(v), q_positions=jnp.arange(shape[1]),
                        kind=kind, window=WINDOW, chunk=16)
    assert out.shape == ref_k.shape and out.dtype == torch.float32
    for ref in (ref_k, ref_b):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind,shape", list(_cases()))
def test_port_blocked_matches_reference_blocked(kind, shape):
    q, k, v = _inputs(shape, seed=sum(shape) + 1)
    out = attn.blocked_attention(_t(q), _t(k), _t(v),
                                 q_positions=torch.arange(shape[1]),
                                 kind=kind, window=WINDOW, chunk=16)
    ref = ref_blocked(_j(q), _j(k), _j(v), q_positions=jnp.arange(shape[1]),
                      kind=kind, window=WINDOW, chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_bf16_matches_reference(kind):
    shape = SHAPES["gqa"]
    q, k, v = _inputs(shape, seed=7)
    out = ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), kind=kind,
                              window=WINDOW)
    ref = ref_ops.flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                  _j(v, jnp.bfloat16), kind=kind,
                                  window=WINDOW, bq=16, bk=16,
                                  interpret=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_padded_kv_masked_by_seq_k(kind):
    """The port never pads kv: attention over the true-length kv equals
    the reference kernel called on zero-padded kv with the true length
    as its `seq_k` (keys at or past it masked)."""
    B, S, H, Hkv, hd = 1, 40, 2, 1, 32
    q, k, v = _inputs((B, S, S, H, Hkv, hd, hd), seed=11)
    pad = ((0, 0), (0, 8), (0, 0), (0, 0))
    kp, vp = np.pad(k, pad), np.pad(v, pad)
    out = fa.flash_attention_plain(_t(q), _t(k), _t(v), kind=kind,
                                   window=WINDOW)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(
        -1, a.shape[1], a.shape[3])
    ref = ref_fa.flash_attention_kernel(
        tr(q), tr(kp), tr(vp), kind=kind, window=WINDOW, bq=8, bk=16,
        group=H // Hkv, seq_k=S, interpret=True)
    ref = np.asarray(ref).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)
    via_ops = ops.flash_attention(_t(q), _t(k), _t(v), kind=kind,
                                  window=WINDOW)
    assert torch.equal(via_ops, out)


def test_attention_dispatch_on_cpu_is_blocked():
    """On CPU tensors `attention` takes the blocked path (the kernel is
    for the card) and counts no kernel launch."""
    q, k, v = _inputs(SHAPES["gqa"], seed=3)
    before = fa.launches
    out = attn.attention(_t(q), _t(k), _t(v), q_positions=torch.arange(64),
                         kind="local", window=WINDOW, chunk=16)
    ref = attn.blocked_attention(_t(q), _t(k), _t(v),
                                 q_positions=torch.arange(64), kind="local",
                                 window=WINDOW, chunk=16)
    assert torch.equal(out, ref) and fa.launches == before


def test_kernel_budget_fits_both_configs():
    """Shared memory of the kernel's tiles fits the H100 opt-in at the
    widths of both served configs (hd 256 and 64) and at the cap."""
    from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES
    assert fa.smem_bytes(256, 256) == 214_528 <= SMEM_OPTIN_BYTES
    assert fa.smem_bytes(64, 64) == 66_304
    assert fa.smem_bytes(fa.MAX_HEAD_DIM, fa.MAX_HEAD_DIM) <= SMEM_OPTIN_BYTES


def test_mask_kinds():
    ok = fa.mask(6, 5, kind="local", window=2)
    want = np.array([[1, 0, 0, 0, 0], [1, 1, 0, 0, 0],
                     [0, 1, 1, 0, 0], [0, 0, 1, 1, 0],
                     [0, 0, 0, 1, 1], [0, 0, 0, 0, 1]], bool)
    np.testing.assert_array_equal(ok.numpy(), want)
    full = fa.mask(3, 4, kind="full", window=0)
    assert full.shape == (3, 4) and full.all()
    np.testing.assert_array_equal(
        fa.mask(3, 3, kind="causal", window=0).numpy(),
        np.tril(np.ones((3, 3), bool)))
    with pytest.raises(ValueError):
        fa.mask(2, 2, kind="sliding", window=1)


class _OtherDevice(torch.Tensor):
    """A CPU tensor that says it lives on a device the port has no route
    for (`meta` is the dry run's shape-only route)."""
    @property
    def device(self):
        return torch.device("xpu")


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 4, 2, 8)).as_subclass(_OtherDevice)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_kernel(q, q, q)
    m = torch.zeros((1, 4, 2, 8), device="meta")
    o = fa.flash_attention_kernel(m, m, m)
    assert (o.device.type, o.shape) == ("meta", m.shape)
