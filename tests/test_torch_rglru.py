"""The port's RG-LRU (B6 and the recurrent block) against the JAX package.

On the CPU `repro_torch.kernels.ops.rglru_scan` runs the kernel's plain
version.  It is held to the reference's oracle `kernels/ref.py`
`rglru_ref` and to its Pallas kernel in interpret mode at the sizes of
tests/test_kernels.py, with that file's tolerances: rtol 1e-5, atol 1e-6
in f32, 3e-2 in bf16.  The port's RG-LRU block (prefill, decode, and the
prefill cache's f32 final state) is held to the reference's, whose scan
is an associative scan over the same recurrence: f32 within rtol 1e-5,
atol 1e-5 (measured at most 2.4e-7 abs at these sizes).  Inputs are drawn
with numpy from a seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro.models.layers import materialize  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402


def _inputs(T, D, seed, B=None):
    rng = np.random.default_rng(seed)
    lead = (T, D) if B is None else (B, T, D)
    x, ga, gx = (rng.standard_normal(lead).astype(np.float32)
                 for _ in range(3))
    a_log = (-np.abs(rng.standard_normal(D)) * .1).astype(np.float32)
    h0 = (rng.standard_normal(D if B is None else (B, D)) * 0.1).astype(
        np.float32)
    return x, a_log, ga, gx, h0


def _t(*arrs, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) if a.dtype == np.float32 and
            a.ndim > 1 else torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("T,D,bt", [
    (64, 128, 16), (128, 128, 128), (256, 256, 64), (32, 8, 8),
])
def test_plain_matches_oracle_and_reference_kernel(T, D, bt):
    x, a_log, ga, gx, h0 = _inputs(T, D, seed=T + D)
    h, h_last = ops.rglru_scan(*_t(x, a_log, ga, gx, h0))
    j = [jnp.asarray(a) for a in (x, a_log, ga, gx, h0)]
    hr = ref_kref.rglru_ref(*j)
    hk = ref_ops.rglru_scan(*j, block_t=bt, interpret=True)
    for ref in (hr, hk):
        np.testing.assert_allclose(h.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    assert h_last.shape == (D,) and torch.equal(h_last, h[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_oracle(dtype):
    T, D = 64, 128
    x, a_log, ga, gx, _ = _inputs(T, D, seed=0)
    h0 = np.zeros(D, np.float32)
    tdt = getattr(torch, dtype)
    h, h_last = ops.rglru_scan(*_t(x, a_log, ga, gx, h0, dtype=tdt))
    # the oracle on the inputs as the port saw them (rounded to dtype)
    xr, gar, gxr = (np.asarray(jnp.asarray(a, getattr(jnp, dtype)),
                               np.float32) for a in (x, ga, gx))
    hr = ref_kref.rglru_ref(jnp.asarray(xr), jnp.asarray(a_log),
                            jnp.asarray(gar), jnp.asarray(gxr),
                            jnp.asarray(h0))
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert h.dtype == tdt and h_last.dtype == torch.float32
    np.testing.assert_allclose(h.float().numpy(), np.asarray(hr), rtol=tol,
                               atol=tol)
    # the final state is the f32 recurrence, never rounded to dtype
    np.testing.assert_allclose(h_last.numpy(), np.asarray(hr)[-1],
                               rtol=1e-5, atol=1e-6)


def test_batched_equals_per_row():
    B, T, D = 3, 40, 16
    x, a_log, ga, gx, h0 = _inputs(T, D, seed=5, B=B)
    h, h_last = ops.rglru_scan(*_t(x, a_log, ga, gx, h0))
    for b in range(B):
        hb, lb = ops.rglru_scan(*_t(x[b], a_log, ga[b], gx[b], h0[b]))
        assert torch.equal(h[b], hb) and torch.equal(h_last[b], lb)


def test_port_scan_matches_reference_associative_scan():
    """The port's `_rglru_scan` (B6's plain version on the CPU) against
    the reference block's associative scan, which B6 replaces on the
    port's path."""
    B, T, D = 2, 512, 64
    x, a_log, ga, gx, h0 = _inputs(T, D, seed=9, B=B)
    h, h_last = rec._rglru_scan(*_t(x, a_log, ga, gx, h0))
    hr, lr = ref_rec._rglru_scan(*(jnp.asarray(a) for a in
                                   (x, a_log, ga, gx, h0)))
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(lr), rtol=1e-5,
                               atol=1e-6)


def _block_params(seed):
    jcfg = dataclasses.replace(ref_smoke("recurrentgemma-2b"),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              dtype=torch.float32)
    p = materialize(ref_rec.rglru_block_specs(jcfg), jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    pt = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    return jcfg, cfg, p, pt


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def test_block_fwd_and_prefill_state_match_reference():
    jcfg, cfg, p, pt = _block_params(1)
    x = _x(2, 40, cfg.d_model, 2)
    y = rec.rglru_block_fwd(pt, torch.as_tensor(x), cfg)
    yr = ref_rec.rglru_block_fwd(p, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5,
                               atol=1e-5)
    c = lm._rec_prefill_cache(pt, torch.as_tensor(x), cfg)
    cr = ref_lm._rec_prefill_cache(p, jnp.asarray(x), jcfg)
    assert c["h"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(c["h"].numpy(), np.asarray(cr["h"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c["conv"].float().numpy(),
                                  np.asarray(cr["conv"], np.float32))


def test_block_decode_matches_reference():
    jcfg, cfg, p, pt = _block_params(3)
    rng = np.random.default_rng(4)
    x = _x(2, 1, cfg.d_model, 5)
    h = rng.standard_normal((2, cfg.rglru_dim)).astype(np.float32)
    conv = rng.standard_normal((2, 3, cfg.rglru_dim)).astype(np.float32)
    conv_bf = jnp.asarray(conv, jnp.bfloat16)
    y, c = rec.rglru_block_decode(
        pt, torch.as_tensor(x),
        {"h": torch.as_tensor(h),
         "conv": torch.as_tensor(conv).to(torch.bfloat16)}, cfg)
    yr, cr = ref_rec.rglru_block_decode(
        p, jnp.asarray(x), {"h": jnp.asarray(h), "conv": conv_bf}, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c["h"].numpy(), np.asarray(cr["h"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c["conv"].float().numpy(),
                                  np.asarray(cr["conv"], np.float32))


def test_decode_recurrence_equals_prefill():
    """Token-by-token decode from the zero state reproduces the prefill
    block's outputs and its final state.  Decode keeps the conv window
    in bf16, as the reference does, while prefill convolves in f32: that
    rounding (2^-9 relative per tap, measured 2.8e-3 abs here) sets the
    tolerance, 1e-2."""
    _, cfg, _, pt = _block_params(6)
    B, S = 2, 24
    x = torch.as_tensor(_x(B, S, cfg.d_model, 7))
    y = rec.rglru_block_fwd(pt, x, cfg)
    c_pre = lm._rec_prefill_cache(pt, x, cfg)
    cache = {"h": torch.zeros((B, cfg.rglru_dim)),
             "conv": torch.zeros((B, 3, cfg.rglru_dim))}
    outs = []
    for t in range(S):
        o, cache = rec.rglru_block_decode(pt, x[:, t:t + 1], cache, cfg)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y.numpy(),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(cache["h"].numpy(), c_pre["h"].numpy(),
                               rtol=1e-2, atol=1e-2)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rglru.rglru_kernel(x, torch.zeros(8), x, x, torch.zeros((1, 8)))
