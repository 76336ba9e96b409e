"""The dry run's specs and spec transforms against the reference's.

`launch/specs.py` (SHAPES, applicable, cache_pspec, input_specs,
cache_specs), `launch/steps.py` (model_param_specs, opt_state_specs,
abstract_params, abstract_opt_state: shapes, dtypes, partitions and
per-device shards), the configs' mesh fields and active parameters,
`launch/variants.py` flash_analytic, `launch/glm.py` glm_analytic and
glm_model_flops, and `launch/cost_analysis.py` (Roofline,
collective_bytes) on the reference's production meshes, (16, 16) and
(2, 16, 16), built as abstract meshes on both sides (no device).  The
reference's per-device shard shapes come from
`NamedSharding(AbstractMesh, spec).shard_shape`.  ~6 s on one CPU
process.
"""
import dataclasses
import math

import pytest

pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import torch                                                 # noqa: E402

from repro.configs import get_config as jget_config         # noqa: E402
from repro.configs import list_archs                         # noqa: E402
from repro.launch import glm as jglm                         # noqa: E402
from repro.launch import hlo_analysis as jhlo                # noqa: E402
from repro.launch import specs as jspecs                     # noqa: E402
from repro.launch import steps as jsteps                     # noqa: E402
from repro.launch import variants as jvariants               # noqa: E402
from repro.launch.mesh import abstract_mesh as jabstract_mesh  # noqa: E402
from repro.models.layers import ParamSpec as JParamSpec     # noqa: E402
from repro.optim import adamw as jadamw                      # noqa: E402
from repro_torch import sharding                             # noqa: E402
from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.launch import cost_analysis, glm, specs, steps  # noqa: E402
from repro_torch.launch import variants                      # noqa: E402
from repro_torch.launch.glm import InputSpec                 # noqa: E402
from repro_torch.launch.mesh import (LINK_BW, PEAK_FLOPS,    # noqa: E402
                                     PEAK_FLOPS_F32, abstract_mesh)
from repro_torch.optim import adamw                          # noqa: E402

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.int32: torch.int32, jnp.int8: torch.int8}


def _meshes(name):
    shape, axes = MESHES[name]
    return jabstract_mesh(shape, axes), abstract_mesh(shape, axes)


def _norm(spec) -> tuple:
    """A partition as comparable tuples: a one-name tuple is the name."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _dtype(d):
    return DTYPES[jnp.dtype(d).type] if d != "int8" else torch.int8


def _port_leaves(tree, path=()):
    """(path, leaf) of a port tree whose leaves are records (InputSpec,
    AbstractArray, ParamSpec), dict keys sorted as jax flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (k,))
    elif isinstance(tree, (adamw.QMoment, adamw.AdamWState)):
        for f, v in zip(tree._fields, tree):
            yield from _port_leaves(v, path + (f,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JParamSpec))


def test_shapes_and_applicability_equal():
    assert {k: dataclasses.astuple(v) for k, v in specs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jspecs.SHAPES.items()}
    for arch in ARCHS:
        for name, shape in specs.SHAPES.items():
            assert specs.applicable(get_config(arch), shape) == \
                jspecs.applicable(jget_config(arch), jspecs.SHAPES[name])


def test_cache_pspec_grid_equal():
    shapes = [(128, 32768, 16, 128), (128, 32768, 8, 64), (1, 2048, 4, 512),
              (128, 32768, 512), (1, 2560), (32, 4, 4, 64), (48, 7, 3),
              (60, 128, 32768, 8, 112), (2, 5), (16, 1, 1, 16)]
    for shp in shapes:
        for mdiv in (1, 4, 16):
            for bdiv in (1, 16, 32):
                for stacked in (False, True):
                    got = specs.cache_pspec(shp, mdiv, bdiv, stacked)
                    want = jspecs.cache_pspec(shp, mdiv, bdiv, stacked)
                    assert _norm(got) == _norm(want), (shp, mdiv, bdiv)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal(arch, mesh_name):
    """Every input and cache record: shape, dtype, partition and the
    per-device shard, all four shapes."""
    jmesh, mesh = _meshes(mesh_name)
    for name, shape in specs.SHAPES.items():
        if not specs.applicable(get_config(arch), shape)[0]:
            continue
        got = list(_port_leaves(specs.input_specs(get_config(arch), shape,
                                                  mesh)))
        want = jax.tree.leaves(jspecs.input_specs(
            jget_config(arch), jspecs.SHAPES[name], jmesh))
        assert len(got) == len(want), (name, len(got), len(want))
        for (path, g), w in zip(got, want):
            assert isinstance(g, InputSpec)
            assert g.shape == tuple(w.shape), (name, path)
            assert g.dtype == _dtype(w.dtype), (name, path)
            part = w.sharding.spec if w.sharding is not None else ()
            assert _norm(g.partition) == _norm(part), (name, path)
            assert specs.shard_shape(g.shape, g.partition, mesh) == \
                _ref_shard(w), (name, path)


def _ref_shard(s) -> tuple:
    return tuple(s.sharding.shard_shape(s.shape) if s.sharding is not None
                 else s.shape)


def _ref_bytes(tree) -> int:
    return sum(math.prod(_ref_shard(s)) * jnp.dtype(s.dtype).itemsize
               for s in jax.tree.leaves(tree))


@pytest.mark.parametrize("mesh_name", [None] + list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal(arch, mesh_name):
    """model_param_specs and opt_state_specs leaf by leaf (mesh None
    too), and on a mesh the per-device bytes of the parameters and of
    f32, bf16 and int8 moments."""
    jmesh, mesh = _meshes(mesh_name) if mesh_name else (None, None)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for port_fn, ref_fn in ((steps.model_param_specs,
                             jsteps.model_param_specs),
                            (steps.opt_state_specs, jsteps.opt_state_specs)):
        got = list(_port_leaves(port_fn(cfg, mesh)))
        want = _ref_leaves(ref_fn(jcfg, jmesh))
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape), path
            assert g.dtype == _dtype(w.dtype), path
            assert _norm(g.pspec) == _norm(w.pspec), (path, g.pspec, w.pspec)
            assert (g.init, g.scale) == (w.init, w.scale), path
    if mesh is None:
        return
    p_port = steps.abstract_params(cfg, mesh)
    p_ref = jsteps.abstract_params(jcfg, jmesh)
    assert sum(a.shard_bytes for _, a in _port_leaves(p_port)) == \
        _ref_bytes(p_ref)
    for (path, g), w in zip(_port_leaves(p_port), jax.tree.leaves(p_ref)):
        assert g.shard == tuple(w.sharding.shard_shape(w.shape)), path
        assert _norm(g.partition) == _norm(w.sharding.spec), path
    for pdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16), ("int8", "int8")):
        o_port = steps.abstract_opt_state(cfg, mesh,
                                          adamw.AdamWConfig(state_dtype=pdt))
        o_ref = jsteps.abstract_opt_state(
            jcfg, jmesh, jadamw.AdamWConfig(state_dtype=jdt))
        got = list(_port_leaves(o_port))
        want = jax.tree.leaves(o_ref)
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            assert g.shape == tuple(w.shape), path
            assert g.shard == _ref_shard(w), path
            assert _norm(g.partition) == _norm(
                w.sharding.spec if w.sharding is not None else ()), path
            assert g.dtype == _dtype(w.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_config_mesh_fields_and_active_params_equal(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),):
        for f in ("fsdp", "zero", "shard_resid", "layout", "batch_axes",
                  "zero_stage"):
            assert getattr(port, f) == getattr(ref, f), f
        assert port.active_param_count() == ref.active_param_count()


def test_flash_analytic_equal():
    for arch in ARCHS:
        for name, shape in specs.SHAPES.items():
            for chips in (1, 256, 512):
                assert variants.flash_analytic(get_config(arch), shape,
                                               chips) == \
                    jvariants.flash_analytic(jget_config(arch),
                                             jspecs.SHAPES[name], chips)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_glm_analytic_and_model_flops_equal(mesh_name):
    """Term for term on the reference's meshes; "h2d bytes" from each
    package's planner (`streamed_transfer_bytes`, one formula) agree."""
    jmesh, mesh = _meshes(mesh_name)
    assert set(glm.GLM_CONFIGS) == set(jglm.GLM_CONFIGS)
    for name, scale in glm.GLM_CONFIGS.items():
        jscale = jglm.GLM_CONFIGS[name]
        assert glm.glm_analytic(scale, mesh, streamed=True) == \
            jglm.glm_analytic(jscale, jmesh, streamed=True)
        assert glm.glm_model_flops(scale, mesh) == \
            jglm.glm_model_flops(jscale, jmesh)
        low = glm.lower_glm(name, mesh)
        assert low["route"] in ("kernel", "kernel-sharded")
        for rec, spec in zip(low["inputs"],
                             jglm.glm_input_specs(jscale, jmesh)):
            assert tuple(rec["shard"]) == _ref_shard(spec)


def test_glm_analytic_one_card_has_no_collectives():
    mesh = abstract_mesh((1, 1, 1), ("pod", "data", "model"))
    for scale in glm.GLM_CONFIGS.values():
        cnt = glm.glm_analytic(scale, mesh)
        assert cnt["coll"] == 0.0 and cnt["flops"] > 0


def test_roofline_as_dict_equal():
    for args in ((1e15, 2e12, 3e9), (5.0, 1e12, 0.0), (1e9, 1.0, 1e12)):
        for peak in (PEAK_FLOPS, PEAK_FLOPS_F32):
            kw = dict(flops=args[0], hbm_bytes=args[1], coll_bytes=args[2],
                      peak_flops=peak, hbm_bw=3.35e12, link_bw=LINK_BW)
            assert cost_analysis.Roofline(**kw).as_dict() == \
                jhlo.Roofline(**kw).as_dict()


def test_collective_bytes_on_recorded_calls(monkeypatch):
    """Calls recorded by `CollectiveRecorder` (the collectives faked:
    no process group in the pytest process) give the per-kind result
    bytes the reference reads off HLO text of the same result shapes."""
    import torch.distributed as dist
    from repro_torch.analysis.trace import CollectiveRecorder
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_to_all_single", "send",
                 "barrier"):
        monkeypatch.setattr(dist, name, lambda *a, **k: None, raising=False)
    f32 = torch.zeros(1024, dtype=torch.float32)
    bf = torch.zeros((8, 64), dtype=torch.bfloat16)
    with CollectiveRecorder() as rec:
        dist.all_reduce(f32)
        dist.all_gather([torch.zeros(1024) for _ in range(4)], f32)
        dist.all_gather_into_tensor(torch.zeros(4096, dtype=torch.int8),
                                    torch.zeros(1024, dtype=torch.int8))
        dist.reduce_scatter_tensor(torch.zeros(256), f32)
        dist.all_to_all_single(torch.zeros((8, 64), dtype=torch.bfloat16),
                               bf)
        dist.send(bf, 1)
        dist.barrier()
    got = cost_analysis.collective_bytes(rec.calls)
    hlo = "\n".join([
        "%a = f32[1024]{0} all-reduce(f32[1024]{0} %x)",
        "%b = f32[4096]{0} all-gather(f32[1024]{0} %x)",
        "%c = s8[4096]{0} all-gather(s8[1024]{0} %y)",
        "%d = f32[256]{0} reduce-scatter(f32[1024]{0} %x)",
        "%e = bf16[8,64]{1,0} all-to-all(bf16[8,64]{1,0} %z)",
        "%f = bf16[8,64]{1,0} collective-permute(bf16[8,64]{1,0} %z)"])
    want = jhlo.collective_bytes(hlo)
    want["count"] += 1                     # the barrier: no HLO result
    assert got == want


def test_sharding_registry_cleans_partitions():
    sharding.set_mesh(None)
    try:
        assert sharding.clean_pspec((("pod", "data"), "model")) == \
            (("pod", "data"), "model")
        sharding.set_mesh(abstract_mesh((16, 16), ("data", "model")))
        assert sharding.get_mesh().size == 256
        assert sharding.clean_pspec((("pod", "data"), None, "model")) == \
            (("data",), None, "model")
        assert sharding.clean_pspec(("pod",)) == (None,)
    finally:
        sharding.set_mesh(None)
