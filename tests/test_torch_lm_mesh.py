"""The LM's train and serve steps on a process mesh (`launch.train.
train(mesh=)`, `launch.serve.serve(mesh=)`, `sharding.layout.LMLayout`)
against the reference's single-device step and the port's one process.

One module-scoped spawn runs 4 CPU processes of `tools/lm_mesh_rank.py`
on the gloo backend (a file store under ``tmp_path``; timeouts on the
rendezvous, on every collective and on the join).  The spawned script
imports neither JAX nor the reference: the reference's weights (its
seeded draws, carried over by `convert.lm_params_from_reference` and
cast to f32) reach it as an ``.npz``, and the reference's numbers are
computed in this process while the ranks run.  Every case is f32 at
smoke size:

  * the reference test's smollm variant (4 / 2 heads, d_model 128,
    d_ff 256) on (1, 2, 2) and (2, 2, 1), under ZeRO-3 on (1, 2, 2),
    and with bf16 and int8 moments on (1, 2, 2);
  * internlm2's smoke config (6 / 2 heads) with `shard_resid` and
    ZeRO-1 on (1, 2, 2);
  * granite's smoke config (6 / 1 heads) in the "fsdp" layout on
    (1, 2, 2), and in the "tp" layout, its one kv head gathered over
    'model'.

The smoke leaves are below the FSDP / ZeRO size floor of 4M entries, so
the ranks lower `steps._FSDP_MIN_SIZE` to 1,024 entries: every matrix
is then split as a full-size one is.  Each case holds: the 3 losses
within rtol 2e-2 / atol 2e-2 of the reference's jitted `make_train_step`
(its own batches, `batch_at(step)`; measured at most 9.7e-4, the int8
moments, and 4.1e-5 for f32 ones); step 0's loss within rtol 1e-5 /
atol 1e-6 of the port's one-process step (measured at most 4.8e-7), and
its gathered gradients within 1e-6 plus 5e-5 of each leaf's largest
magnitude: tensor parallelism reorders f32 sums (the row-parallel
outputs, the vocab-parallel loss), and the reference's std-1 smoke
weights, whose activations reach the thousands, carry that into the
embedding's rows (up to 3.5e-5 abs, 2.3e-5 of the leaf's largest; the
data-parallel (2, 2, 1) mesh is within 2.6e-8 of one process);
two runs `torch.equal` (every leaf of the parameters and moments on
every rank); the shards replicated over an axis the same bits on every
rank that holds them; `serve(mesh=)`'s ids equal to one process's and
its prefill logits within 1e-5.  The checkpoint: saved at step 2 on
(1, 2, 2), resumed there to step 3 bitwise the straight run, restored on
(2, 2, 1) and saved again, and that checkpoint `torch.equal` to the
first when one process reads both.  About 40 s on the CPU (the
reference's jitted steps while the ranks run).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.train import batch_at as ref_batch_at  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.checkpoint import restore_tree  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import DistMesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding.layout import LMLayout  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 240
STEPS, B, S = 3, 4, 32
SERVE = {"batch": 4, "prompt": 8, "gen": 4}
FSDP_MIN = 1024
#: step 0's gathered gradients against one process's: within GRAD_ATOL
#: plus GRAD_RTOL of each leaf's largest magnitude (measured at most
#: 2.3e-5 of it, the embedding of the ZeRO-3 smollm case; the loss is
#: held elementwise, rtol 1e-5 / atol 1e-6)
GRAD_ATOL, GRAD_RTOL = 1e-6, 5e-5
VARIANT = dict(n_heads=4, n_kv_heads=2, d_model=128, d_ff=256)

#: config key -> (arch, fields on both sides)
CFGS = {
    "smollm": ("smollm-360m", VARIANT),
    "smollm-bf16": ("smollm-360m", {**VARIANT, "opt_dtype": "bf16"}),
    "smollm-int8": ("smollm-360m", {**VARIANT, "opt_dtype": "int8"}),
    "internlm2": ("internlm2-20b", {"zero": "zero1", "shard_resid": True}),
    "granite": ("granite-20b", {"zero": "zero1", "layout": "fsdp"}),
}
#: case -> (config key, mesh, port-only fields, what runs)
CASES = {
    "smollm/122": ("smollm", (1, 2, 2), {}, ("train", "grads", "serve")),
    "smollm/221": ("smollm", (2, 2, 1), {}, ("train", "grads", "serve")),
    "smollm-zero3/122": ("smollm", (1, 2, 2), {"zero": "zero3"},
                         ("train", "grads")),
    "smollm-bf16/122": ("smollm-bf16", (1, 2, 2), {}, ("train",)),
    "smollm-int8/122": ("smollm-int8", (1, 2, 2), {"zero": "zero1"},
                        ("train",)),
    "internlm2/122": ("internlm2", (1, 2, 2), {}, ("train", "grads",
                                                   "serve")),
    "granite/122": ("granite", (1, 2, 2), {}, ("train", "grads", "serve")),
    "granite-tp/122": ("granite", (1, 2, 2), {"layout": "tp"},
                       ("train", "grads")),
}


def _cfg(key, extra=None):
    arch, fields = CFGS[key]
    return dataclasses.replace(get_smoke(arch), dtype=torch.float32,
                               **{**fields, **(extra or {})})


def _ref_cfg(key):
    arch, fields = CFGS[key]
    return dataclasses.replace(ref_smoke(arch), dtype=jnp.float32, **fields)


def _key(path):
    return "/".join(str(p) for p in path)


def _ref_weights(key):
    """The reference's seeded draw (bf16, as its init gives it) in f32."""
    arch, fields = CFGS[key]
    jcfg = dataclasses.replace(ref_smoke(arch), **fields)
    jp = jax.jit(ref_steps.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)


def _case_spec(name):
    key, mesh, extra, runs = CASES[name]
    arch, fields = CFGS[key]
    case = {"name": name, "arch": arch, "smoke": True, "dtype": "float32",
            "fields": {**fields, **extra}, "mesh": list(mesh),
            "weights": f"{key.split('-')[0]}.npz",
            "fsdp_min": FSDP_MIN}
    if "train" in runs:
        case["train"] = {"steps": STEPS, "batch": B, "seq": S, "runs": 2}
    if "grads" in runs:
        case["grads"] = {"batch": B, "seq": S}
    if "serve" in runs:
        case["serve"] = SERVE
    return case


def _ckpt_cases():
    base = _case_spec("smollm/122")
    out = []
    for name, mesh, tr in (
            ("ckpt/122", (1, 2, 2), {"steps": 2, "ckpt_dir": "ck_a",
                                     "ckpt_every": 2}),
            ("resume/122", (1, 2, 2), {"steps": 3, "ckpt_dir": "ck_a"}),
            ("elastic/221", (2, 2, 1), {"steps": 2, "ckpt_dir": "ck_a",
                                        "resave": "ck_b"})):
        case = {k: v for k, v in base.items()
                if k not in ("train", "grads", "serve")}
        case.update(name=name, mesh=list(mesh),
                    train={"batch": B, "seq": S, "runs": 1, **tr})
        out.append(case)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' records, rank 0's arrays, the weights, and the
    reference's losses (computed here while the ranks run)."""
    root = tmp_path_factory.mktemp("lm_mesh")
    weights = {}
    for key in ("smollm", "internlm2", "granite"):
        jp = _ref_weights(key)
        tree = lm_params_from_reference(jp, _cfg(key))
        weights[key] = (jp, tree)
        np.savez(root / f"{key}.npz", **{_key(p): t.numpy()
                                         for p, t in tree_items(tree)})
    cases = [_case_spec(n) for n in CASES] + _ckpt_cases()
    (root / "cases.json").write_text(json.dumps(
        {"cases": cases, "timeout": 120}))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for r in range(WORLD):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "lm_mesh_rank.py"),
             str(root), str(r), str(WORLD), "--device=cpu"],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    t0 = time.perf_counter()
    try:
        ref = {key: _ref_losses(key, weights[key.split("-")[0]][0])
               for key in CFGS}
        for p, _ in procs:
            p.wait(timeout=max(1.0, SPAWN_TIMEOUT
                               - (time.perf_counter() - t0)))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()[-4000:]
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return {"root": root, "ranks": ranks, "ref": ref,
            "arrays": dict(np.load(root / "rank0.npz")),
            "weights": {k: v[1] for k, v in weights.items()}}


def _ref_losses(key, jp):
    """The reference's 3 single-device steps (jitted), from its weights
    in f32, on `batch_at(step)`."""
    jcfg = _ref_cfg(key)
    oc = ref_steps.make_opt_cfg(jcfg)
    step = jax.jit(ref_steps.make_train_step(jcfg, oc))
    p = jax.tree.map(jnp.asarray, jp)
    o = ref_adamw.init(p, oc)
    out = []
    for s in range(STEPS):
        p, o, m = step(p, o, ref_batch_at(jcfg, B, S, s))
        out.append(float(m["loss"]))
    return out


def _weights(world, name):
    key = CASES[name][0].split("-")[0]
    return world["weights"][key]


def test_no_jax_on_the_ranks(world):
    for rec in world["ranks"]:
        assert rec["foreign_modules"] == []


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_reference(world, name):
    for rec in world["ranks"]:
        got = rec["cases"][name]["train"]["runs"][0]["losses"]
        np.testing.assert_allclose(got, world["ref"][CASES[name][0]],
                                   rtol=2e-2, atol=2e-2)
    first = world["ranks"][0]["cases"][name]["train"]["runs"][0]
    for rec in world["ranks"][1:]:      # global numbers, the same bits
        run = rec["cases"][name]["train"]["runs"][0]
        assert run["losses"] == first["losses"]
        assert run["grad_norms"] == first["grad_norms"]


@pytest.mark.parametrize("name", list(CASES))
def test_two_runs_torch_equal(world, name):
    for rec in world["ranks"]:
        a, b = rec["cases"][name]["train"]["runs"]
        assert a["losses"] == b["losses"]
        assert a["digests"] == b["digests"]


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_shards_bitwise(world, name):
    seen, shards = {}, 0
    for rec in world["ranks"]:
        for leaf, (dig, shard) in rec["cases"][name]["train"]["runs"][0][
                "digests"].items():
            key = (leaf, tuple(shard))
            assert seen.setdefault(key, dig) == dig, key
            shards += 1
    assert len(seen) < shards           # something is replicated


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "grads" in c[3]])
def test_step0_grads_match_one_process(world, name):
    cfg = _cfg(CASES[name][0], CASES[name][2])
    params = tree_map(torch.clone, _weights(world, name))
    b = train.batch_at(cfg, B, S, 0, device="cpu")
    loss, grads = steps.make_grad_step(cfg)(params, b)
    for rec in world["ranks"]:
        got = rec["cases"][name]["grads"]["loss"]
        np.testing.assert_allclose(got, float(loss), rtol=1e-5, atol=1e-6)
    arrays = world["arrays"]
    for path, g in tree_items(grads):
        err = np.abs(arrays[f"{name}/grads/{_key(path)}"] - g.numpy()).max()
        assert err <= GRAD_ATOL + GRAD_RTOL * float(g.abs().max()), \
            (_key(path), err)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "serve" in c[3]])
def test_serve_matches_one_process(world, name):
    cfg = _cfg(CASES[name][0], CASES[name][2])
    params = tree_map(torch.clone, _weights(world, name))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (
        SERVE["batch"], SERVE["prompt"])), dtype=torch.int64)
    from repro_torch.launch.serve import generate
    ids = generate(params, tokens, cfg, SERVE["gen"])
    with torch.inference_mode():
        logits, _ = lm.forward(params, tokens, cfg, mode="prefill")
    arrays = world["arrays"]
    np.testing.assert_array_equal(arrays[f"{name}/serve/ids"], ids.numpy())
    np.testing.assert_allclose(arrays[f"{name}/serve/logits"],
                               logits[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    for rec in world["ranks"]:
        assert rec["cases"][name]["serve"]["ids"] == ids.tolist()


def test_resume_on_the_same_mesh_is_bitwise(world):
    for rec in world["ranks"]:
        straight = rec["cases"]["smollm/122"]["train"]["runs"][0]
        resumed = rec["cases"]["resume/122"]["train"]["runs"][0]
        assert resumed["losses"] == straight["losses"][2:]
        assert resumed["digests"] == straight["digests"]


def test_elastic_checkpoint_torch_equal(world):
    """Saved on (1, 2, 2), restored on (2, 2, 1) and saved again: one
    process reads the two checkpoints to the same bits."""
    cfg = _cfg("smollm")
    params = tree_map(torch.clone, world["weights"]["smollm"])
    target = (params, adamw.init(params, steps.make_opt_cfg(cfg)))
    root = world["root"]
    a, meta_a = restore_tree(root / "ck_a" / "step_000000000002", target,
                             device="cpu")
    b, meta_b = restore_tree(root / "ck_b" / "step_000000000002", target,
                             device="cpu")
    assert meta_a["step"] == meta_b["step"] == 2
    la, lb = list(tree_items(a)), list(tree_items(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), _key(p)


def _hand_mesh(pod, data, model, rank=0):
    """A DistMesh with no process group: enough for what needs none."""
    return DistMesh(pod, data, model, rank, torch.device("cpu"), "gloo", {})


def test_heads_indivisible_raise():
    cfg = get_smoke("smollm-360m")          # 3 heads
    with pytest.raises(ValueError, match="heads do not split"):
        LMLayout(cfg, _hand_mesh(1, 2, 2))
    LMLayout(cfg, _hand_mesh(2, 2, 1))      # no tensor parallelism
    LMLayout(dataclasses.replace(cfg, layout="fsdp"), _hand_mesh(1, 2, 2))


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "recurrentgemma-2b",
                                  "whisper-base", "xlstm-1.3b"])
def test_later_slices_refused(arch):
    with pytest.raises(NotImplementedError, match="later slice"):
        LMLayout(get_smoke(arch), _hand_mesh(1, 2, 2))


@pytest.mark.parametrize("heads,kv,model,want", [
    (6, 2, 2, [[0], [1]]),                  # kv split over 'model'
    (6, 1, 2, [[0], [0]]),                  # one kv head, gathered
    (8, 2, 4, [[0], [0], [1], [1]]),        # a group's part a rank
    (12, 3, 2, [[0, 0, 0, 0, 1, 1], [1, 1, 2, 2, 2, 2]]),  # ragged
])
def test_kv_heads_a_rank_computes(heads, kv, model, want):
    cfg = dataclasses.replace(get_smoke("internlm2-20b"), n_heads=heads,
                              n_kv_heads=kv, d_model=16 * heads)
    got = [LMLayout(cfg, _hand_mesh(1, 1, model, rank=r)).kv_heads()
           for r in range(model)]
    assert got == want


@pytest.mark.parametrize("fields,mesh", [
    ({}, (1, 2, 2)), ({"zero": "zero3"}, (2, 2, 1)),
    ({"layout": "fsdp"}, (1, 2, 2))])
def test_init_params_shards_are_slices_of_the_one_card_draw(fields, mesh,
                                                            monkeypatch):
    monkeypatch.setattr(steps, "_FSDP_MIN_SIZE", FSDP_MIN)
    cfg = dataclasses.replace(get_smoke("internlm2-20b"), **fields)
    whole = steps.init_params(cfg, 3, "cpu")
    for r in range(WORLD):
        m = _hand_mesh(*mesh, rank=r)
        lay = steps.layout_for(cfg, m)
        got = steps.init_params(cfg, 3, "cpu", mesh=m)
        split = 0
        for (p, t), (_, w), (_, pl) in zip(tree_items(got), tree_items(whole),
                                           tree_items(lay.params)):
            assert torch.equal(t, lay.local(w, pl)), _key(p)
            assert t.untyped_storage().nbytes() == t.numel() * t.itemsize
            split += t.shape != w.shape
        assert split


def test_constrain_without_a_mesh_returns_its_input():
    x = torch.randn(2, 3, 4)
    assert sharding.get_mesh() is None
    assert sharding.constrain(x, ("pod", "data"), None, "model") is x


def test_constrain_refuses_a_mesh_with_no_processes():
    from repro_torch.launch.mesh import abstract_mesh
    sharding.set_mesh(abstract_mesh((2, 2), ("data", "model")))
    try:
        with pytest.raises(TypeError, match="DistMesh"):
            sharding.constrain(torch.zeros(2, 2), "data", "model")
    finally:
        sharding.set_mesh(None)


def test_dist_mesh_joint_axes():
    m = _hand_mesh(2, 2, 2, rank=5)                 # coords (1, 0, 1)
    assert m.coords == (1, 0, 1)
    assert m.group_index(("data", "model")) == 1
    assert m.group_index(("pod", "data")) == 2
    assert m.group_index(None) == 5
    assert m.group_size(("pod", "data")) == 4
    assert _hand_mesh(1, 2, 2).live_axes(("pod", "model")) == ("model",)
    assert _hand_mesh(1, 2, 2).group_size("pod") == 1


def test_constrain_slices_and_checks_shapes():
    """A dimension held whole that the spec splits is cut to this rank's
    chunk (no collective in the forward); one that does not divide, or
    a local shape that is not the held shard of `shape`, raises."""
    sharding.set_mesh(_hand_mesh(1, 2, 2, rank=3))  # data 1, model 1
    try:
        x = torch.arange(2 * 3 * 4.).reshape(2, 3, 4)
        got = sharding.constrain(x, ("pod", "data"), None, "model")
        assert torch.equal(got, x[..., 2:])
        assert sharding.constrain(got, ("pod", "data"), None, "model",
                                  held=(("pod", "data"), None, "model"),
                                  shape=(4, 3, 4)) is got
        with pytest.raises(ValueError, match="split"):
            sharding.constrain(x, "data", "model")
        with pytest.raises(ValueError, match="shard"):
            sharding.constrain(x, "data", None, None, shape=(2, 3, 4))
    finally:
        sharding.set_mesh(None)
