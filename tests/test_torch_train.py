"""The port's LM train step against the JAX package, for all ten smoke
configs.

The reference's parameters (`repro.launch.steps.init_params`) are
carried over by `convert.lm_params_from_reference` (its gradients and
AdamW moments, stacked the same way, by the same function), the batches
come from numpy seeds, and `dtype` is replaced by f32 on both sides
unless a test says bf16.  On the CPU the port's attention is the
blocked formulation under torch autograd and RG-LRU's backward is
`rglru_bwd_plain` (through `RGLRUFn`); the kernels' own backward is
held to those plain versions on the card (`chip_smoke.py`).

Tolerances, measured on these inputs and stated with margin:
  * f32 loss within 1e-5 abs of `jax.value_and_grad(steps.loss_fn)`
    (measured at most 4.8e-7), and every gradient leaf within 2e-3 of
    that leaf's largest magnitude (measured at most 8.5e-4,
    whisper-base; 1.9e-4 or less for the other nine): the reference's
    std-1 stacked blocks drive activations into the thousands, where the
    two frameworks' f32 roundings differ most;
  * the bf16 loss (the configs' own dtype) within 0.01 abs (measured at
    most 2.6e-3, whisper-base; 4.4e-4 or less for the others);
  * five AdamW steps (lr 3e-3, the reference's defaults otherwise)
    against its jitted `make_train_step` (`STEP_ARCHS`: one config of
    each block kind and frontend), each step taken from the
    reference's own state, since a free run diverges by design: Adam's
    first update is lr * g / (|g| + eps), +-lr for any |g| above eps,
    so an entry whose gradient is at the two frameworks' rounding level
    lands 2 lr apart, and these configs' losses amplify that (whisper's
    gradient norm moves 12 % a step later).  Held: the loss within 1e-4
    (measured 9.5e-7), the gradient norm within 2e-3 relative (measured
    5.5e-4, whisper), the moments within rtol 1e-3 and atol 2e-4 (mu) /
    1e-5 (nu) (measured 8.9e-6 / 7.0e-7 abs), every parameter within
    4 lr (measured 5.0e-3, whisper), and at most 5 % of a step's
    parameter entries beyond 1e-5 + 1e-5 |p| (measured 0.11 %, whisper;
    2.5 % for deepseek on the reference's eager draws);
  * a few free-running bf16 steps on one repeated batch reduce the loss,
    as tests/test_models.py asserts of the reference.
Remat (`cfg.remat`, `torch.utils.checkpoint`) gives gradients bitwise
equal to the plain forward's, and `launch.train`'s resume from a
checkpoint (f32 and int8 moments) is bitwise a straight run.  CPU
seconds: about 110 (the reference's jit compiles take most of it).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    tree_items, tree_leaves, tree_map)
from repro_torch.optim import adamw  # noqa: E402

ARCHS = sorted(list_archs())
#: the configs whose AdamW steps are compared with the reference's: one
#: for each block kind and frontend (GQA, RG-LRU with local attention,
#: MLA with MoE, mLSTM / sLSTM, the encoder-decoder, the vision slice);
#: every config's gradient is compared above
STEP_ARCHS = ["deepseek-v2-lite-16b", "phi-3-vision-4.2b",
              "recurrentgemma-2b", "smollm-360m", "whisper-base",
              "xlstm-1.3b"]
B, S = 2, 16
LR = 3e-3
STEPS = 5


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio":
        b["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                          np.float32)
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model),
                                           np.float32)
    return b


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _conv(tree, cfg):
    return lm_params_from_reference(jax.tree.map(np.asarray, tree), cfg)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's parameters of `arch`'s smoke config (jitted: the
    same draws in fewer seconds than eagerly, though not the same bits)."""
    return jax.jit(ref_steps.init_params, static_argnums=0)(
        ref_smoke(arch), jax.random.PRNGKey(0))


def _setup(arch, f32=True):
    """(reference cfg, port cfg, the reference's params, a batch)."""
    jcfg, cfg = ref_smoke(arch), get_smoke(arch)
    jp = _ref_params(arch)
    if f32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, cfg, jp, _batch(cfg)


def _grads(params, batch, cfg):
    live = [p.detach().clone().requires_grad_(True)
            for p in tree_leaves(params)]
    it = iter(live)
    loss = steps.loss_fn(tree_map(lambda _p: next(it), params), batch, cfg)
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(live, gs)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    jcfg, cfg, jp, bn = _setup(arch)
    jl, jg = jax.jit(jax.value_and_grad(ref_steps.loss_fn),
                     static_argnums=2)(jp, _j(bn), jcfg)
    loss, gs = _grads(_conv(jp, cfg), _t(bn), cfg)
    assert abs(float(loss) - float(jl)) <= 1e-5
    want = tree_leaves(_conv(jg, cfg))
    assert len(gs) == len(want)
    for g, w in zip(gs, want):
        assert g.dtype == w.dtype == torch.float32
        err = float((g - w).abs().max())
        assert err <= 2e-3 * float(w.abs().max()) + 1e-12, (err, w.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(arch):
    jcfg, cfg, jp, bn = _setup(arch, f32=False)
    assert cfg.dtype == torch.bfloat16
    jl = jax.jit(ref_steps.loss_fn, static_argnums=2)(jp, _j(bn), jcfg)
    with torch.no_grad():
        loss = steps.loss_fn(_conv(jp, cfg), _t(bn), cfg)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= 0.01


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference(arch):
    jcfg, cfg, jp, bn = _setup(arch)
    joc = dataclasses.replace(ref_steps.make_opt_cfg(jcfg), lr=LR)
    toc = dataclasses.replace(steps.make_opt_cfg(cfg), lr=LR)
    jstep = jax.jit(ref_steps.make_train_step(jcfg, joc))
    tstep = steps.make_train_step(cfg, toc)
    jb, tb = _j(bn), _t(bn)
    p, o = jp, ref_adamw.init(jp, joc)
    for _ in range(STEPS):
        tp = _conv(p, cfg)
        to = adamw.AdamWState(torch.tensor(int(o.step), dtype=torch.int32),
                              _conv(o.mu, cfg), _conv(o.nu, cfg))
        p, o, m = jstep(p, o, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert int(to.step) == int(o.step)
        assert abs(float(tm["loss"]) - float(m["loss"])) <= 1e-4
        assert abs(float(tm["grad_norm"]) / float(m["grad_norm"]) - 1) \
            <= 2e-3
        for mine, ref, atol in ((to.mu, o.mu, 2e-4), (to.nu, o.nu, 1e-5)):
            for a, b in zip(tree_leaves(mine), tree_leaves(_conv(ref, cfg))):
                torch.testing.assert_close(a, b, rtol=1e-3, atol=atol)
        n = off = 0
        for a, b in zip(tree_leaves(tp), tree_leaves(_conv(p, cfg))):
            d = (a - b).abs()
            assert float(d.max()) <= 4 * LR
            off += int((d > 1e-5 + 1e-5 * b.abs()).sum())
            n += d.numel()
        assert off <= 0.05 * n, off / n


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reduces_loss(arch):
    """A few AdamW steps on one repeated batch (bf16, the configs' own
    dtype) reduce the loss, as tests/test_models.py holds the
    reference."""
    cfg = get_smoke(arch)
    oc = dataclasses.replace(steps.make_opt_cfg(cfg), lr=LR)
    params = steps.init_params(cfg, 0, "cpu")
    state = adamw.init(params, oc)
    step = steps.make_train_step(cfg, oc)
    bn = _batch(cfg, seed=1)
    bn["labels"] = bn["tokens"]
    losses = []
    for _ in range(STEPS):
        params, state, m = step(params, state, _t(bn))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-360m",
                                  "whisper-base", "deepseek-v2-lite-16b"])
def test_remat_grads_equal_plain_forward(arch):
    _, cfg, jp, bn = _setup(arch)
    params = _conv(jp, cfg)
    plain = _grads(params, _t(bn), dataclasses.replace(cfg, remat=False))
    remat = _grads(params, _t(bn), dataclasses.replace(cfg, remat=True))
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(plain[1], remat[1]):
        assert torch.equal(a, b)


def test_train_mode_is_prefill_without_caches():
    _, cfg, jp, bn = _setup("recurrentgemma-2b")
    params, toks = _conv(jp, cfg), _t(bn)["tokens"]
    with torch.no_grad():
        lt, ct = lm.forward(params, toks, cfg, mode="train")
        lp, cp = lm.forward(params, toks, cfg, mode="prefill")
    assert ct is None and cp is not None
    assert torch.equal(lt, lp)
    with pytest.raises(ValueError):
        lm.forward(params, toks, cfg, mode="eval")


def test_lm_loss_matches_reference_with_mask():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.uniform(size=(2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = ref_lm.lm_loss(jnp.asarray(logits).astype(jdt),
                                  jnp.asarray(labels), jm)
            got = lm.lm_loss(torch.from_numpy(logits).to(tdt),
                             torch.from_numpy(labels), tm)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_make_opt_cfg_follows_opt_dtype():
    assert steps.make_opt_cfg(get_config("kimi-k2-1t-a32b")).state_dtype \
        == "int8"
    assert steps.make_opt_cfg(get_config("smollm-360m")).state_dtype \
        == torch.float32
    bf = dataclasses.replace(get_smoke("smollm-360m"), opt_dtype="bf16")
    assert steps.make_opt_cfg(bf).state_dtype == torch.bfloat16


@pytest.mark.parametrize("opt_dtype", ["f32", "int8"])
def test_resume_is_bitwise(tmp_path, opt_dtype):
    """`launch.train.train`: 2 steps saved at step 2, then a new run
    resumed from it to step 4, equal bit for bit (params, moments and
    step) to a straight 4-step run."""
    cfg = dataclasses.replace(get_smoke("smollm-360m"), opt_dtype=opt_dtype)
    kw = dict(batch=2, seq=12, verbose=False, device="cpu", seed=3)
    p1, o1, l1 = train.train(cfg, steps=4, **kw)
    train.train(cfg, steps=2, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    p2, o2, l2 = train.train(cfg, steps=4, ckpt_dir=str(tmp_path), **kw)
    assert l2 == l1[2:]
    assert torch.equal(o1.step, o2.step) and int(o2.step) == 4
    a = [x for _, x in tree_items((p1, o1.mu, o1.nu))]
    b = [x for _, x in tree_items((p2, o2.mu, o2.nu))]
    assert len(a) == len(b) and any(x.dtype == torch.int8 for x in a) \
        == (opt_dtype == "int8")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
