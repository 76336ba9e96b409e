"""The port's sharded working-set gather (B3) against the JAX reference.

`kernels.sdca_sparse_bucket.sdca_sparse_gather_bucket(idxb, b, v_held,
m0)` gives each worker's bucket entries the bits of the held v slice
that owns their feature, exact +0.0 where none is held.  Covered at
small sizes on the CPU, where the wrapper runs its plain version:
  * the one-lane form (one slice held, m0 = m) bitwise against the
    reference's Pallas gather (`_gather_slice_kernel`, interpret mode)
    for every lane;
  * the stacked form (every slice held, m0 = 0) bitwise against the
    reference's per-lane gathers followed by its all-gather and
    owner-select, with -0.0 planted in v;
  * a numpy copy of the CUDA kernel's thread loop (4 entries a thread,
    the 16-byte and the 4-byte paths, a ragged E) bitwise against the
    plain version; the kernel itself runs only on the card, where
    chip_smoke.py holds it against its plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import sdca_sparse_bucket as jsb           # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.kernels import sdca_sparse_bucket as ks      # noqa: E402

NEG_ZERO = np.float32(-0.0).view(np.int32)


def _bits(t) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(t, np.float32)).view(np.int32)


def _case(d, M, Wk=2, nb=2, B=16, nnz=8, seed=0):
    """(idxb (Wk, nb, B, nnz) int32, v_loc (Wk, M, d_loc) f32) with ids
    in [0, d), v zero-padded past d and -0.0 at every bucket's first
    id of each worker."""
    rng = np.random.default_rng(seed + d + M)
    d_loc = ops.sparse_slice_width(d, M)
    idxb = rng.integers(0, d, (Wk, nb, B, nnz)).astype(np.int32)
    v = np.zeros((Wk, M * d_loc), np.float32)
    v[:, :d] = rng.standard_normal((Wk, d)).astype(np.float32)
    for w in range(Wk):
        v[w, idxb[w, :, 0, 0]] = -0.0
    return (torch.as_tensor(idxb),
            torch.as_tensor(v.reshape(Wk, M, d_loc)))


@pytest.mark.parametrize("d", [50, 250])          # uneven slices + padding
@pytest.mark.parametrize("M", [2, 4])
def test_one_lane_gather_bitwise_vs_reference(d, M):
    """Mh = 1, m0 = m: lane m's partial working set, bit for bit the
    reference kernel's W_loc (owned entries the slice's bits, -0.0
    included; every other entry +0.0)."""
    idxb, v_loc = _case(d, M)
    Wk, nb = idxb.shape[:2]
    d_loc = v_loc.shape[-1]
    negz = 0
    for b in range(nb):
        for m in range(M):
            got = ks.sdca_sparse_gather_bucket(
                idxb, b, v_loc[:, m:m + 1].contiguous(), m)
            assert got.shape == idxb[:, b].shape
            for w in range(Wk):
                want = jsb.sdca_sparse_gather_bucket(
                    jnp.asarray(idxb[w, b].numpy()),
                    jnp.asarray(v_loc[w, m].numpy())[:, None],
                    jnp.int32(m * d_loc), True)
                np.testing.assert_array_equal(_bits(got[w]), _bits(want))
                negz += int((_bits(want) == NEG_ZERO).sum())
    assert negz > 0


@pytest.mark.parametrize("d", [50, 250])
@pytest.mark.parametrize("M", [2, 4])
def test_stacked_gather_bitwise_vs_reference_exchange(d, M):
    """Mh = M, m0 = 0: each worker's exchanged working set, bit for bit
    the reference's M per-lane gathers stacked (its all-gather) and
    owner-selected (idx // d_loc), -0.0 kept; also the one-lane forms
    put together the same way."""
    idxb, v_loc = _case(d, M, seed=1)
    Wk, nb = idxb.shape[:2]
    d_loc = v_loc.shape[-1]
    for b in range(nb):
        got = ks.sdca_sparse_gather_bucket(idxb, b, v_loc)
        lanes = torch.stack([ks.sdca_sparse_gather_bucket(
            idxb, b, v_loc[:, m:m + 1].contiguous(), m) for m in range(M)])
        for w in range(Wk):
            idx_t = jnp.asarray(idxb[w, b].numpy())
            parts = jnp.stack([jsb.sdca_sparse_gather_bucket(
                idx_t, jnp.asarray(v_loc[w, m].numpy())[:, None],
                jnp.int32(m * d_loc), True) for m in range(M)])
            owner = (idx_t // jnp.int32(d_loc)).astype(jnp.int32)
            want = jnp.take_along_axis(parts, owner[None], axis=0)[0]
            np.testing.assert_array_equal(_bits(got[w]), _bits(want))
            own = torch.as_tensor(np.array(owner)).long()[None]
            mine = torch.take_along_dim(lanes[:, w], own, dim=0)[0]
            np.testing.assert_array_equal(_bits(got[w]), _bits(mine))
        assert bool((_bits(got) == NEG_ZERO).any())


def _emulate_gather_kernel(idxb, b, v_held, m0, vec):
    """The thread loop of csrc/sdca_sparse_gather_bucket.cu in numpy,
    on the flat device layout: thread t of worker w takes entries 4t ..
    4t+3 of the bucket's ids (one 16-byte read when `vec`, else 4-byte
    reads that stop at E), tests each id - m0*d_loc against Mh*d_loc
    as an unsigned number and loads w's held slices there, else +0.0."""
    Wk, nb, B, nnz = idxb.shape
    _, Mh, d_loc = v_held.shape
    E = B * nnz
    lo, span = m0 * d_loc, Mh * d_loc
    ids = idxb.numpy().reshape(-1).astype(np.int64)
    v = v_held.numpy().reshape(-1)
    out = np.full(Wk * E, np.nan, np.float32)
    for w in range(Wk):
        for e0 in range(0, E, 4):
            base = (w * nb + b) * E + e0
            if vec:
                assert E % 4 == 0
                q = ids[base:base + 4] - lo
            else:
                q = np.array([ids[base + j] - lo if e0 + j < E else -1
                              for j in range(4)])
            held = q.astype(np.uint64) < np.uint64(span)
            x = [v[w * span + q[j]] if held[j] else np.float32(0.0)
                 for j in range(4)]
            for j in range(4):
                if e0 + j < E:
                    out[w * E + e0 + j] = x[j]
    return torch.as_tensor(out.reshape(Wk, B, nnz))


@pytest.mark.parametrize("B,nnz,vec", [(16, 8, True), (16, 8, False),
                                       (3, 7, False)])
@pytest.mark.parametrize("form", ["stacked", "one_lane"])
def test_kernel_thread_loop_is_the_plain_gather(B, nnz, vec, form):
    """Both load paths of the kernel, and E = 21 (not a multiple of 4),
    give the plain version's bits in both forms."""
    d, M = 250, 4
    idxb, v_loc = _case(d, M, Wk=3, nb=3, B=B, nnz=nnz, seed=2)
    held = ([(v_loc, 0)] if form == "stacked" else
            [(v_loc[:, m:m + 1].contiguous(), m) for m in range(M)])
    for b in range(idxb.shape[1]):
        for v_held, m0 in held:
            got = _emulate_gather_kernel(idxb, b, v_held, m0, vec)
            want = ks.sdca_sparse_gather_plain(idxb, b, v_held, m0)
            np.testing.assert_array_equal(_bits(got), _bits(want))


def test_gather_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused, not run through the plain version."""
    idxb = torch.zeros((1, 1, 8, 8), dtype=torch.int32, device="meta")
    v = torch.zeros((1, 2, 64), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ks.sdca_sparse_gather_bucket(idxb, 0, v)
