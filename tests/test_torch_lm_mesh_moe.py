"""MoE expert parallelism and MLA on a process mesh (`launch.train.
train(mesh=)`, `launch.serve.serve(mesh=)`, `sharding.layout.LMLayout`,
`models.moe.moe_apply(layout=)`) against the reference's single-device
step and the port's one process.

One module-scoped spawn runs 4 CPU processes of `tools/lm_mesh_rank.py`
on the gloo backend, as `tests/test_torch_lm_mesh.py` does: a file store
under ``tmp_path``, the reference's weights (its seeded draws carried
over by `convert.lm_params_from_reference`, in f32) as an ``.npz``, no
JAX on the ranks, the reference's numbers computed in this process while
the ranks run, the FSDP / ZeRO size floor lowered to 1,024 entries.
Every case is f32 at smoke size, batch 4 x 32 (128 tokens):

  * deepseek-v2-lite's smoke config (MLA without a q-LoRA, 8 experts,
    top-2, 2 shared) with ZeRO-1 and `shard_resid` on (1, 2, 2) and on
    (2, 2, 1) (the experts replicated over 'pod', a pod's owners taking
    its own tokens);
  * the same with `moe_capacity` 0.25, C 16 slots an expert for 256
    pairs, so that pairs really drop (the test prints how many);
  * kimi-k2's smoke config (GQA, 8 experts, top-2, 1 shared) on
    (1, 2, 2) with ZeRO-1 and int8 moments: `w_down`'s last axis is
    split over 'model', so its int8 rows take their amax over the shards
    (`LMLayout.row_max`);
  * minicpm3's smoke config (MLA with a q-LoRA, no experts) on
    (1, 2, 2) with ZeRO-1 and `shard_resid`;
  * kimi-k2's served alone on (2, 2, 1), the spawn's first case: its
    host stages are first grown under serving's inference mode and then
    written outside it (the gathered logits).

Each case holds, with these bounds: the 3 losses within rtol 2e-2 /
atol 2e-2 of the reference's jitted `make_train_step` on its own
batches (measured at most 8.8e-3, kimi's int8 moments, whose port on
one process is 1.3e-2 from the reference at its third step; 5.4e-4 for
the others); two runs `torch.equal`; replicated
shards the same bits on every rank that holds them; `serve(mesh=)`'s
ids equal to one process's and its prefill logits within 1e-5; and,
read from the collectives' payload shapes, no expert leaf's shard ever
all-gathered in a step.  Step 0 is also run on the port's own seeded
draw (`steps.init_params`, 1/sqrt(fan_in) scaled, cast to f32): its
loss within rtol 1e-5 / atol 1e-6 of the port's one process, its
gathered gradients within GRAD_ATOL plus GRAD_RTOL of each leaf's
largest magnitude (`tests/test_torch_lm_mesh.py`'s bounds; measured at
most 3.4e-6 of it), the router's and MLA's replicated latent weights
(`wkv_a`, `kv_norm`, `wq_a`, `q_norm`) named in the assertion, so that
a missing or doubled sum over 'model' shows (either is an error of
order one), and every MoE call's global `slot` and `keep`
integer-equal to one process's.  Why
not the reference's weights there: its smoke weights are std-1, the
activations reach the thousands and the router's softmax saturates, so
a relative 1e-7 of noise added to the dense block's MLP output moves
the one process's own step-0 gradients by up to 3.2e-4 of a leaf's
largest (kimi; 1.5e-6 on the port's draw), beyond that bound with no
mesh at all (`test_reference_weights_amplify_rounding`); the mesh's
reordered f32 sums are such noise.
About 30 s on the CPU (the reference's jitted steps while the ranks
run).
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
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import DistMesh  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map  # noqa: E402
from repro_torch.sharding.layout import EXPERT_LEAVES, LMLayout  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 240
STEPS, B, S = 3, 4, 32
SERVE = {"batch": 4, "prompt": 8, "gen": 4}
FSDP_MIN = 1024
#: step 0's gathered gradients against one process's (the bounds of
#: tests/test_torch_lm_mesh.py):
#: within GRAD_ATOL plus GRAD_RTOL of each leaf's largest magnitude; the
#: loss elementwise within rtol 1e-5 / atol 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-6, 5e-5
#: the leaves a missing or doubled sum over 'model' would show in
SEAM_LEAVES = ("router", "wkv_a", "kv_norm", "wq_a", "q_norm")
#: a capacity factor that drops pairs: C = 16 for 256 pairs over 8
#: experts
DROP = 0.25
ZERO1 = {"zero": "zero1", "shard_resid": True}

#: config key -> (arch, fields on both sides)
CFGS = {
    "deepseek": ("deepseek-v2-lite-16b", ZERO1),
    "deepseek-drop": ("deepseek-v2-lite-16b", {**ZERO1,
                                               "moe_capacity": DROP}),
    "kimi": ("kimi-k2-1t-a32b", {**ZERO1, "opt_dtype": "int8"}),
    "minicpm3": ("minicpm3-4b", ZERO1),
}
#: case -> (config key, mesh, what runs on the reference's weights);
#: step 0's gradients run on the port's draw in a case of their own,
#: named with ":port"
CASES = {
    "kimi-serve/221": ("kimi", (2, 2, 1), ("serve",)),
    "deepseek/122": ("deepseek", (1, 2, 2), ("train", "serve")),
    "deepseek/221": ("deepseek", (2, 2, 1), ("train", "serve")),
    "deepseek-drop/122": ("deepseek-drop", (1, 2, 2), ("train",)),
    "kimi/122": ("kimi", (1, 2, 2), ("train", "serve")),
    "minicpm3/122": ("minicpm3", (1, 2, 2), ("train", "serve")),
}
TRAIN_CASES = [n for n, c in CASES.items() if "train" in c[2]]
MOE_CASES = [n for n in TRAIN_CASES if CASES[n][0] != "minicpm3"]
PORT = ":port"


def _cfg(key):
    arch, fields = CFGS[key]
    return dataclasses.replace(get_smoke(arch), dtype=torch.float32,
                               **fields)


def _ref_cfg(key):
    arch, fields = CFGS[key]
    return dataclasses.replace(ref_smoke(arch), dtype=jnp.float32, **fields)


def _key(path):
    return "/".join(str(p) for p in path)


def _wkey(key):
    """The weights' key: a capacity changes no parameter."""
    return key.split("-")[0]


def _ref_weights(key):
    """The reference's seeded draw (bf16, as its init gives it) in f32."""
    arch, fields = CFGS[key]
    jcfg = dataclasses.replace(ref_smoke(arch), **fields)
    jp = jax.jit(ref_steps.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)


def _case_specs(name):
    """The case on the reference's weights, and its step 0 on the
    port's draw."""
    key, mesh, runs = CASES[name]
    arch, fields = CFGS[key]
    base = {"arch": arch, "smoke": True, "dtype": "float32",
            "fields": fields, "mesh": list(mesh), "fsdp_min": FSDP_MIN}
    case = {**base, "name": name, "weights": f"{_wkey(key)}.npz"}
    if "serve" in runs:
        case["serve"] = SERVE
    if "train" not in runs:
        return [case]
    case["train"] = {"steps": STEPS, "batch": B, "seq": S, "runs": 2}
    return [case, {**base, "name": name + PORT,
                   "weights": f"port-{_wkey(key)}.npz",
                   "grads": {"batch": B, "seq": S}}]


def _port_weights(key):
    """The port's seeded draw of the config, in f32."""
    return tree_map(lambda t: t.float(), steps.init_params(_cfg(key), 0,
                                                           "cpu"))


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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' records, rank 0's arrays, the weights, and the
    reference's losses (computed here while the ranks run)."""
    root = tmp_path_factory.mktemp("lm_mesh_moe")
    weights, port = {}, {}
    for key in {_wkey(k) for k in CFGS}:
        jp = _ref_weights(key)
        tree = lm_params_from_reference(jp, _cfg(key))
        weights[key] = (jp, tree)
        port[key] = _port_weights(key)
        for stem, t in ((key, tree), (f"port-{key}", port[key])):
            np.savez(root / f"{stem}.npz", **{_key(p): x.numpy()
                                              for p, x in tree_items(t)})
    cases = [c for n in CASES for c in _case_specs(n)]
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
        ref = {key: _ref_losses(key, weights[_wkey(key)][0])
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
            "weights": {k: v[1] for k, v in weights.items()}, "port": port}


def _one_process(world, name):
    """The port's one-process step 0 on its own draw: (loss, grads, the
    MoE calls' dispatch log)."""
    key = CASES[name][0]
    cfg = _cfg(key)
    params = tree_map(torch.clone, world["port"][_wkey(key)])
    b = train.batch_at(cfg, B, S, 0, device="cpu")
    with moe.record_dispatch() as log:
        loss, grads = steps.make_grad_step(cfg)(params, b)
    return loss, grads, log


def test_no_jax_on_the_ranks(world):
    for rec in world["ranks"]:
        assert rec["foreign_modules"] == []


@pytest.mark.parametrize("name", TRAIN_CASES)
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


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_two_runs_torch_equal(world, name):
    for rec in world["ranks"]:
        a, b = rec["cases"][name]["train"]["runs"]
        assert a["losses"] == b["losses"]
        assert a["pairs"] == b["pairs"]
        assert a["digests"] == b["digests"]


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_replicated_shards_bitwise(world, name):
    seen, shards = {}, 0
    for rec in world["ranks"]:
        for leaf, (dig, shard) in rec["cases"][name]["train"]["runs"][0][
                "digests"].items():
            key = (leaf, tuple(shard))
            assert seen.setdefault(key, dig) == dig, key
            shards += 1
    assert len(seen) < shards           # something is replicated


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_step0_grads_match_one_process(world, name):
    loss, grads, _ = _one_process(world, name)
    for rec in world["ranks"]:
        got = rec["cases"][name + PORT]["grads"]["loss"]
        np.testing.assert_allclose(got, float(loss), rtol=1e-5, atol=1e-6)
    arrays = world["arrays"]
    errs = {}
    for path, g in tree_items(grads):
        err = float(np.abs(arrays[f"{name}{PORT}/grads/{_key(path)}"]
                           - g.numpy()).max())
        errs[_key(path)] = (err, GRAD_ATOL + GRAD_RTOL * float(g.abs().max()))
    seam = {k: v for k, v in errs.items() if k.split("/")[-1] in SEAM_LEAVES}
    want = {"router"} if CASES[name][0] != "minicpm3" else set()
    if _cfg(CASES[name][0]).attention == "mla":
        want |= {"wkv_a", "kv_norm"}
    if _cfg(CASES[name][0]).q_lora_rank:
        want |= {"wq_a", "q_norm"}
    assert {k.split("/")[-1] for k in seam} == want
    bad = {k: v for k, v in seam.items() if not v[0] <= v[1]}
    assert not bad, f"router / MLA latent leaves (err, bound): {bad}"
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    assert not bad, f"(err, bound): {bad}"


@pytest.mark.parametrize("name", MOE_CASES)
def test_dispatch_slots_equal_one_process(world, name):
    _, _, log = _one_process(world, name)
    arrays = world["arrays"]
    assert len(log) == _cfg(CASES[name][0]).n_layers - 1   # MoE layers
    for i, rec in enumerate(log):
        for k in ("slot", "keep"):
            np.testing.assert_array_equal(
                arrays[f"{name}{PORT}/dispatch/{i}/{k}"], rec[k].numpy(),
                err_msg=f"call {i} {k}")
    pairs = moe.dispatch_counts(log)
    for rec in world["ranks"]:
        assert rec["cases"][name + PORT]["grads"]["pairs"] == pairs
    print(f"{name}: step 0 keeps {pairs['kept']} pairs, drops "
          f"{pairs['dropped']}")
    if CASES[name][0] == "deepseek-drop":
        assert pairs["dropped"] > pairs["kept"] // 4


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "serve" in c[2]])
def test_serve_matches_one_process(world, name):
    cfg = _cfg(CASES[name][0])
    params = tree_map(torch.clone, world["weights"][_wkey(CASES[name][0])])
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


def _expert_shards(name, rank):
    """The local shapes of the case's expert leaves on `rank`."""
    key, mesh, _ = CASES[name]
    lay = LMLayout(_cfg(key), _hand_mesh(*mesh, rank=rank))
    return {tuple(n // lay.mesh.group_size(a) for n, a in zip(pl.shape,
                                                              pl.part))
            for path, pl in tree_items(lay.params)
            if path[-1] in EXPERT_LEAVES and path[-2] == "moe"}


@pytest.mark.parametrize("name", MOE_CASES)
def test_no_expert_leaf_gathered(world, name):
    """No collective of a step carries an expert leaf's shard but the
    sum of its gradient over 'pod' (on a mesh with pods): the experts
    stay resident and only tokens move (the all-to-all's kinds are
    there)."""
    pods = CASES[name][1][0] > 1
    for r, rec in enumerate(world["ranks"]):
        shards = _expert_shards(name, r)
        colls = rec["cases"][name]["train"]["runs"][0]["collectives"]
        assert {"moe_ids", "moe_dispatch", "moe_combine"} <= set(colls)
        for kind, st in colls.items():
            hit = [s for s in st["shapes"] if tuple(s) in shards]
            assert not hit or (kind == "grad_sum" and pods), (kind, hit)


# -- the layout, no processes ---------------------------------------------

def _hand_mesh(pod, data, model, rank=0):
    """A DistMesh with no process group: enough for what needs none (a
    collective would raise)."""
    return DistMesh(pod, data, model, rank, torch.device("cpu"), "gloo", {})


@pytest.mark.parametrize("mesh", [(1, 2, 2), (2, 2, 1)])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
                                  "minicpm3-4b"])
def test_layout_accepts_moe_and_mla(arch, mesh):
    for cfg in (get_smoke(arch), get_config(arch)):
        lay = LMLayout(cfg, _hand_mesh(*mesh))
        experts = [pl for path, pl in tree_items(lay.params) if pl.ep]
        assert bool(experts) == bool(cfg.n_experts)
        for pl in experts:
            assert pl.ep == ("data",) and pl.part[0] == ("data",)


def test_moe_in_the_fsdp_layout_refused():
    cfg = dataclasses.replace(get_smoke("kimi-k2-1t-a32b"), layout="fsdp")
    with pytest.raises(NotImplementedError, match="fsdp"):
        LMLayout(cfg, _hand_mesh(1, 2, 2))


@pytest.mark.parametrize("mesh,want", [((1, 2, 2), []), ((2, 2, 1),
                                                         ["pod"])])
def test_expert_leaves_stay_resident(mesh, want, monkeypatch):
    """The three places an expert-parallel split differs from FSDP:
    `gather` leaves the shard as it is (on a mesh with no process group
    a gather would raise), `sync_grads` sums its gradient over no axis
    but 'pod' (and returns it untouched where there is none), and ZeRO-1
    splits it no further, while a dense leaf of the same block is
    gathered under ZeRO-3 and split by ZeRO-1."""
    monkeypatch.setattr(steps, "_FSDP_MIN_SIZE", FSDP_MIN)
    cfg = dataclasses.replace(get_smoke("deepseek-v2-lite-16b"),
                              zero="zero1")
    lay = LMLayout(cfg, _hand_mesh(*mesh))
    whole = steps.init_params(cfg, 0, "cpu")
    local = tree_map(lay.local, whole, lay.params)
    blk = ("blocks", 0, "0", "moe")
    for name in EXPERT_LEAVES:
        path = blk + (name,)
        pl = dict(tree_items(lay.params))[path]
        w = dict(tree_items(local))[path]
        assert lay.gather(w, pl) is w
        assert lay._zero(path) is None
        assert lay.grad_sum_axes(path) == want
    assert lay.grad_sum_axes(blk + ("router",)) == list(lay.batch_axes)
    assert lay._zero(blk + ("shared", "w_down")) is not None
    if not want:
        g = local["blocks"][0]["0"]["moe"]
        sub = {"blocks": [{"0": {"moe": {n: g[n] for n in EXPERT_LEAVES}}}]}
        out = lay.sync_grads(sub)
        for n in EXPERT_LEAVES:
            assert out["blocks"][0]["0"]["moe"][n] is g[n]
    z3 = LMLayout(dataclasses.replace(cfg, zero="zero3"), _hand_mesh(*mesh))
    at = dict(tree_items(z3.params))
    assert at[blk + ("w_gate",)].ep == ("data",)
    assert "data" in at[blk + ("shared", "w_down")].axes


def test_mla_attn_params_local_heads():
    """MLA on 'model' = 2: the rank runs n_heads / 2 heads on its own
    shards of `wq` / `wkv_b` / `wo`, the latent projections whole."""
    cfg = get_smoke("minicpm3-4b")
    lay = LMLayout(cfg, _hand_mesh(1, 1, 2, rank=1))
    at = dict(tree_items(lay.params))
    pa_pl = {path[-1]: pl for path, pl in at.items()
             if path[:3] == ("blocks", 0, "0") and path[3] == "attn"}
    assert pa_pl["wq_b"].part == ((), ("model",))
    assert pa_pl["wkv_b"].part == ((), ("model",))
    assert pa_pl["wo"].part == (("model",), ())
    for n in ("wkv_a", "kv_norm", "wq_a", "q_norm"):
        assert pa_pl[n].axes == ()
    pa = {"wq_b": torch.zeros(1)}
    got, acfg = lay.attn_params(pa)
    assert got is pa and acfg.n_heads == cfg.n_heads // 2
    assert lm.cache_shapes(lay.cache_cfg(), 2, 16) == lm.cache_shapes(
        cfg, 2, 16)


def _noise_moves_grads(params, cfg, monkeypatch):
    """The largest change, over the leaves, of one process's step-0
    gradients (relative to each leaf's largest magnitude) when a relative
    1e-7 of seeded noise is added to every dense MLP block's output."""
    b = train.batch_at(cfg, B, S, 0, device="cpu")
    _, clean = steps.make_grad_step(cfg)(tree_map(torch.clone, params), b)
    gen = torch.Generator().manual_seed(1)
    real = lm.mlp_apply

    def noisy(*a, **kw):
        out = real(*a, **kw)
        return out * (1 + 1e-7 * torch.randn(out.shape, generator=gen))

    monkeypatch.setattr(lm, "mlp_apply", noisy)
    _, moved = steps.make_grad_step(cfg)(tree_map(torch.clone, params), b)
    monkeypatch.setattr(lm, "mlp_apply", real)
    return max(float((g - h).abs().max() / g.abs().max())
               for (_, g), (_, h) in zip(tree_items(clean),
                                         tree_items(moved)))


def test_reference_weights_amplify_rounding(world, monkeypatch):
    """Why step 0 is held on the port's draw: on one process, noise at
    the level of f32 rounding moves kimi's step-0 gradients beyond
    GRAD_RTOL of a leaf's largest with the reference's std-1 smoke
    weights (its router saturates), and leaves them well inside it with
    the port's fan-in-scaled draw."""
    cfg = _cfg("kimi")
    ref = _noise_moves_grads(world["weights"]["kimi"], cfg, monkeypatch)
    port = _noise_moves_grads(world["port"]["kimi"], cfg, monkeypatch)
    print(f"1e-7 of noise moves step 0's gradients {ref:.2e} (the "
          f"reference's weights), {port:.2e} (the port's draw)")
    assert ref > GRAD_RTOL > 10 * port
