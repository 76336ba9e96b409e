"""The dry run's counter and records (`launch/counting.py`,
`launch/dryrun.py`, `kernels/costs.py`), on the CPU.

  * the closed-form unmasked pairs of B5's masks equal the mask's sum,
    and the cost formulas `chip_smoke.py` bounds the kernels by read the
    same pairs;
  * B5's and B6's `meta` route: outputs (forward and backward, lse
    included) of the plain versions' shapes and dtypes, no CUDA build
    loaded; on the CPU the plain versions run; a tensor that says it is
    on CUDA reaches the launch (spied), never the meta route;
  * a smoke-size step counted on `meta` equals the same step counted on
    the CPU (the plain versions inside the kernels' wrappers): prefill
    of all ten configs, train of smollm-360m, recurrentgemma-2b and
    whisper-base, flops exactly and bytes within 1 % (equal, in fact:
    no op differs);
  * the xLSTM extrapolation (in the pattern's repeats and the chunks)
    and the AdamW chunk shortcut equal a direct trace;
  * `run_cell` writes the reference's record keys; a failing cell is
    recorded with status "error" and `main` exits 1.
The reference's `launch/dryrun.py` forces 512 host devices when
imported, so `model_flops` is held to the reference's
`active_param_count`, not to its module.  ~30 s on one CPU process.
"""
import dataclasses
import json

import pytest

pytest.importorskip("torch")

import torch                                                 # noqa: E402

from repro.configs import get_config as jget_config         # noqa: E402
from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.kernels import build, costs                 # noqa: E402
from repro_torch.kernels import flash_attention as fa        # noqa: E402
from repro_torch.kernels import rglru as rg                  # noqa: E402
from repro_torch.launch import counting, dryrun               # noqa: E402
from repro_torch.launch.specs import SHAPES                  # noqa: E402
from repro_torch.optim import adamw                          # noqa: E402

TOL_BYTES = 0.01
#: the extrapolated temp peak of an xLSTM step against a direct trace
#: (26 % under it in a train step at this size: the peak is a maximum
#: over the step's phases, not a sum, so no polynomial in the length
#: and depth holds it exactly; the dry run's `memory_method` says so)
TOL_XLSTM_TEMP = 0.5


@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_unmasked_pairs_closed_form(kind):
    for sq, sk in ((1, 1), (7, 7), (64, 64), (100, 37), (37, 100), (300, 270),
                   (270, 300), (2048, 1500), (5, 300)):
        for window in ((0, 1, 3, 16, 64, 100, 400) if kind == "local"
                       else (0,)):
            want = int(fa.mask(sq, sk, kind=kind, window=window).sum())
            assert costs.unmasked_pairs(sq, sk, kind=kind,
                                        window=window) == want, (sq, sk,
                                                                 window)


def test_cost_formulas_read_the_pairs():
    q = torch.zeros(2, 300, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 270, 2, 64, dtype=torch.bfloat16)
    v = torch.zeros(2, 270, 2, 32, dtype=torch.bfloat16)
    pairs = int(fa.mask(300, 270, kind="local", window=100).sum())
    assert costs.attention_cost(q, k, v, "local", 100) == (
        2 * 2 * (300 * 4 * 64 + 270 * 2 * 96 + 300 * 4 * 32),
        2 * 4 * pairs * 2 * (64 + 32))
    assert costs.fa_bwd_cost(q, k, v, "local", 100)[1] == \
        2 * 4 * pairs * 2 * (3 * 64 + 2 * 32)
    x = torch.zeros(2, 10, 8)
    assert costs.rglru_cost(x) == (4 * 160 * 4 + (8 + 32) * 4, 18 * 160,
                                   2 * 160 * costs.FP64_EXP["fast"])
    big = torch.full((8,), -200.0)          # 8 log_a = -1600 * sigmoid(0)
    assert costs.rglru_cost(x, big, torch.zeros(2, 10, 8),
                            {"fast": 29, "extra": 3})[2] == \
        2 * 160 * 29 + 2 * 160 * 3


def _fa_inputs(device, dtype, hd=64, hd_v=64):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g).to(dtype) for s in (
        (2, 40, 4, hd), (2, 33, 2, hd), (2, 33, 2, hd_v), (2, 40, 4, hd_v)))
    return [t.to(device) for t in (q, k, v, do)]


@pytest.fixture
def no_build(monkeypatch):
    """Any CUDA build or launch raises."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA build was loaded")
    for mod, names in ((build, ("load",)),
                       (fa, ("_fn", "_fn_tc", "_fn_bwd", "_fn_bwd_tc")),
                       (rg, ("_fn", "_fn_bwd"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)


@pytest.mark.parametrize("dtype,hd,hd_v", [(torch.bfloat16, 64, 64),
                                           (torch.float32, 64, 64),
                                           (torch.bfloat16, 96, 64)])
def test_meta_route_flash_attention(no_build, dtype, hd, hd_v):
    cpu = _fa_inputs("cpu", dtype, hd, hd_v)
    meta = _fa_inputs("meta", dtype, hd, hd_v)
    tc = fa.bwd_route(dtype, hd, hd_v) == "tc"
    for kind in ("causal", "local", "full"):
        kw = dict(kind=kind, window=16)
        o = fa.flash_attention_kernel(*meta[:3], **kw)
        o_c = fa.flash_attention_kernel(*cpu[:3], **kw)
        assert (o.device.type, o.shape, o.dtype) == ("meta", o_c.shape,
                                                     o_c.dtype)
        lse = None
        if fa.route(dtype, hd, hd_v) == "tc":
            o, lse = fa.flash_attention_kernel(*meta[:3], with_lse=True, **kw)
            _, lse_c = fa.flash_attention_kernel(*cpu[:3], with_lse=True, **kw)
            assert (lse.shape, lse.dtype) == (lse_c.shape, lse_c.dtype)
        grads = fa.flash_attention_bwd(*meta[:3], o, meta[3], **kw,
                                       lse=lse if tc else None)
        grads_c = fa.flash_attention_bwd(*cpu[:3], o_c, cpu[3], **kw)
        for g, gc in zip(grads, grads_c):
            assert (g.device.type, g.shape, g.dtype) == ("meta", gc.shape,
                                                         gc.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_meta_route_rglru(no_build, dtype):
    def inputs(dev):
        g = torch.Generator().manual_seed(1)
        x, ga, gx, dh = (torch.randn(2, 9, 8, generator=g).to(dtype)
                         for _ in range(4))
        a_log = -torch.rand(8, generator=g)
        h0, dh_last = torch.randn(2, 8, generator=g), torch.zeros(2, 8)
        return [t.to(dev) for t in (x, a_log, ga, gx, h0, dh, dh_last)]
    m, c = inputs("meta"), inputs("cpu")
    for fn, args in ((rg.rglru_kernel, slice(0, 5)),
                     (rg.rglru_bwd, slice(0, 7))):
        got, want = fn(*m[args]), fn(*c[args])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.device.type, g.shape, g.dtype) == ("meta", w.shape,
                                                         w.dtype)


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose `device` says CUDA: the wrappers take their
    launch path with it (the launches themselves are spied)."""
    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_reaches_the_launch_and_meta_only_on_meta(monkeypatch):
    calls = []

    def spy(name, ret):
        def f(*a, **k):
            calls.append(name)
            return ret(a)
        return f
    monkeypatch.setattr(fa, "_launch_tc", spy("tc", lambda a: a[0]))
    monkeypatch.setattr(fa, "_launch_core", spy("core", lambda a: a[0]))
    monkeypatch.setattr(fa, "_bwd_tc", spy("bwd_tc", lambda a: a[:3]))
    monkeypatch.setattr(fa, "_bwd_core", spy("bwd_core", lambda a: a[:3]))
    monkeypatch.setattr(rg, "_fn", lambda: spy("rglru", lambda a: 0))
    monkeypatch.setattr(rg, "_fn_bwd", lambda: spy("rglru_bwd", lambda a: 0))

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())

    class _CpuAllocs:                 # rglru's torch: allocates on the CPU
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def empty(*a, device=None, **k):
            return torch.empty(*a, **k)
    monkeypatch.setattr(rg, "torch", _CpuAllocs())
    q, k, v, do = (t.as_subclass(_SaysCuda) for t in
                   _fa_inputs("cpu", torch.bfloat16))
    lse = torch.zeros(2, 4, 40).as_subclass(_SaysCuda)
    fa.flash_attention_kernel(q, k, v)
    fa.flash_attention_bwd(q, k, v, q, do, lse=lse)
    fa.flash_attention_kernel(*(t.float() for t in (q, k, v)))
    fa.flash_attention_bwd(*(t.float() for t in (q, k, v, q, do)))
    x = torch.zeros(2, 9, 8).as_subclass(_SaysCuda)
    d8 = torch.zeros(8).as_subclass(_SaysCuda)
    h0 = torch.zeros(2, 8).as_subclass(_SaysCuda)
    rg.rglru_kernel(x, d8, x, x, h0)
    rg.rglru_bwd(x, d8, x, x, h0, x, h0)
    assert calls == ["tc", "bwd_tc", "core", "bwd_core", "rglru",
                     "rglru_bwd"]


def _cpu_count(cfg, kind, B, S):
    p, o, b = counting.step_inputs(cfg, kind, B, S, "cpu")
    mode = counting.CountingMode()
    with mode, counting.adamw_chunk_shortcut(mode):
        counting.run_step(cfg, kind, p, o, b)
    return mode.result()


CASES = [(a, "prefill") for a in list_archs()] + [
    ("smollm-360m", "train"), ("recurrentgemma-2b", "train"),
    ("whisper-base", "train")]


@pytest.mark.parametrize("arch,kind", CASES)
def test_meta_count_equals_cpu_count(arch, kind):
    cfg = get_smoke(arch)
    meta = counting.trace_step(cfg, kind, 2, 48, "meta")
    cpu = _cpu_count(cfg, kind, 2, 48)
    assert meta["flops"] == cpu["flops"] > 0
    assert abs(meta["bytes accessed"] / cpu["bytes accessed"] - 1) <= TOL_BYTES
    # the same program: the ops outside the kernels' wrappers agree
    assert meta["ops"] - meta["kernel ops"] == cpu["ops"] - cpu["kernel ops"]
    for key in meta:
        if key.startswith(("kernel.", "attn_term.")):
            assert meta[key] == cpu[key], key


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_xlstm_extrapolation_equals_a_direct_trace(kind):
    """xLSTM in chunks of 4 tokens, 3 repeats of its pattern: counted at 2, 3, 4 chunks and 1, 2 repeats, extrapolated to 5 chunks
    and 3 repeats: flops and bytes equal to the direct trace, the temp
    peak within TOL_XLSTM_TEMP."""
    cfg = dataclasses.replace(get_smoke("xlstm-1.3b"), attn_chunk=4,
                              n_layers=6)
    got = counting.count_step(cfg, kind, 2, 20, "meta")
    assert "extrapolated to 5 chunks" in got["method"]
    want = counting.trace_step(cfg, kind, 2, 20, "meta")
    for key in ("flops", "bytes accessed"):
        assert got[key] == want[key], key
    assert abs(got["temp peak bytes"] / want["temp peak bytes"] - 1) <= \
        TOL_XLSTM_TEMP


def test_adamw_chunk_shortcut_equals_a_direct_trace(monkeypatch):
    monkeypatch.setattr(adamw, "CHUNK_ELEMS", 8000)
    cfg = dataclasses.replace(get_smoke("smollm-360m"), opt_dtype="int8")
    fast = counting.trace_step(cfg, "train", 2, 16, "meta")
    slow = counting.trace_step(cfg, "train", 2, 16, "meta",
                               chunk_shortcut=False)
    assert fast["ops"] < slow["ops"]
    for key in ("flops", "bytes accessed", "temp peak bytes"):
        assert fast[key] == slow[key], key


def test_model_flops_formula():
    for arch in list_archs():
        n_act = jget_config(arch).active_param_count() - \
            jget_config(arch).vocab * jget_config(arch).d_model
        cfg = get_config(arch)
        assert dryrun.model_flops(cfg, SHAPES["train_4k"]) == \
            6.0 * n_act * 256 * 4096
        assert dryrun.model_flops(cfg, SHAPES["prefill_32k"]) == \
            2.0 * n_act * 32 * 32768
        assert dryrun.model_flops(cfg, SHAPES["decode_32k"]) == \
            2.0 * n_act * 128


ROOFLINE_KEYS = {"flops_per_dev", "hbm_bytes_per_dev", "coll_bytes_per_dev",
                 "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                 "step_time_lb_s"}


def test_run_cell_records(tmp_path):
    for arch, shape, mesh in (("smollm-360m", "decode_32k", "card"),
                              ("smollm-360m", "decode_32k", "pod"),
                              ("glm-higgs", "epoch", "multipod")):
        rec = json.loads(json.dumps(dryrun.run_cell(arch, shape, mesh,
                                                    tmp_path)))
        assert rec == json.loads(
            (tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
        assert rec["status"] == "ok"
        assert {"memory_analysis", "raw_roofline", "roofline",
                "counting"} <= set(rec)
        assert set(rec["raw_roofline"]) == ROOFLINE_KEYS
        assert set(rec["roofline"]) >= ROOFLINE_KEYS | {
            "model_flops_per_dev", "model_over_hlo"}
        assert {"argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes"} <= set(rec["memory_analysis"])
    assert rec["roofline"]["t_h2d_s"] > 0 and rec["counting"]["coll"] > 0
    card = json.loads((tmp_path / "smollm-360m__decode_32k__card.json")
                      .read_text())
    pod = json.loads((tmp_path / "smollm-360m__decode_32k__pod.json")
                     .read_text())
    assert card["counting"]["flops"] == 256 * pod["counting"]["flops"]
    assert card["counting"]["coll_method"] == "none: one device"
    assert pod["counting"]["coll_method"] == dryrun.COLL_NOT_MODELED
    skipped = dryrun.run_cell("smollm-360m", "long_500k", "card", tmp_path)
    assert skipped["status"] == "skipped"


def test_failing_cell_is_recorded_and_exits_1(tmp_path, monkeypatch):
    def boom(*a):
        raise RuntimeError("no count")
    monkeypatch.setattr(dryrun, "global_count", boom)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--mesh", "card", "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__card.json")
                     .read_text())
    assert rec["status"] == "error" and "no count" in rec["error"]
