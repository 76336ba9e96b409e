"""Tile variants of B5's tensor-core kernel at the served LMs' prefills.

    python3 tools/fa_tc_variants.py [--variant 128x128=3,4,0 ...]
                                    [--configs internlm2-20b,...]
                                    [--reps 20] [--out FILE]

Builds the port's kernels, then one library for each `--variant`,
with the same nvcc flags: `HQxHV=NC,STAGES,PW` (padded widths =
consumer warpgroups, K/V ring stages, producer warp 1 or 0) builds a
copy of `csrc/flash_attention_tc.cu` whose `Tile` line for that pair
says so; a path to a `.cu` file builds another version of the source
(say, the parent commit's) and times it at every pair it instantiates.  Prints ptxas's
registers and spills of every tensor-core instantiation.

At each config's first B5 launch shape (bf16 inputs drawn from a seed;
MLA's q and k concatenated and its v a slice of the kv tensor, as
`models/attention.py` makes them) it holds the kernel and each variant
that covers the widths to the plain version (every entry within rtol
2e-2 / atol 1e-2, error RMS at most 1 % of the plain output's), then
times in turns, CUDA events over `--reps` launches after one warm-up:
the kernel, each variant, the CUDA-core kernel on the same bf16 inputs
and `scaled_dot_product_attention(is_causal=True)` (SDPA, the
yardstick; the port never calls it).  Prints one JSON line per config
and the card's name and power limit; needs one CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.contracts import NVCC_FLAGS  # noqa: E402

#: the served configs' prefill batch and prompt (chip_smoke.py LM_RUNS)
RUNS = {"internlm2-20b": (1, 2048), "granite-20b": (1, 2048),
        "kimi-k2-1t-a32b": (1, 2048), "deepseek-v2-lite-16b": (2, 2048),
        "minicpm3-4b": (2, 2048), "recurrentgemma-2b": (2, 4096),
        "smollm-360m": (4, 2048)}
TOL = (2e-2, 1e-2)
RMS = 0.01
TILE_RE = (r"template <> struct Tile<{hq}, {hv}> : "
           r"TileOf<\d+, \d+, \w+> \{{\}};")


def inputs(name: str, gen):
    """(q, k, v, kind, window) of the config's first B5 launch."""
    cfg = get_config(name)
    B, S = RUNS[name]
    H = cfg.n_heads
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    if cfg.attention == "mla":
        nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kv = rnd(B, S, H, nd + vd)
        q = rnd(B, S, H, nd + rd)
        k = torch.cat([kv[..., :nd], rnd(B, S, 1, rd).expand(B, S, H, rd)],
                      dim=-1)
        return q, k, kv[..., nd:], "causal", 0
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    kind = "local" if cfg.attention == "local" else "causal"
    return (rnd(B, S, H, hd), rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd), kind,
            cfg.window if kind == "local" else 0)


def build_variants(specs: list[str]) -> list[dict]:
    """Each 'HQxHV=NC,STAGES,PW' -> {"spec", "pair", "fn", "smem",
    "ptxas"}, the builds run in parallel."""
    out = build.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src0 = (build.CSRC / "flash_attention_tc.cu").read_text()
    todo = []
    for i, spec in enumerate(specs):
        if spec.endswith(".cu"):        # another version of the source
            src, pairs = pathlib.Path(spec).read_text(), None
        else:
            pair, tile = spec.split("=")
            hq, hv = map(int, pair.split("x"))
            nc, stages, pw = map(int, tile.split(","))
            line = (f"template <> struct Tile<{hq}, {hv}> : TileOf<{nc}, "
                    f"{stages}, {'true' if pw else 'false'}> {{}};")
            src, n = re.subn(TILE_RE.format(hq=hq, hv=hv), line, src0)
            if n != 1:
                raise SystemExit(f"no Tile<{hq}, {hv}> line in the source")
            pairs = [(hq, hv)]
        tiles = {(int(a), int(b)): (int(c), int(d))
                 for a, b, c, d in re.findall(TILE_RE.replace(
                     r"\d+, \d+, \w+", r"(\d+), (\d+), \w+").format(
                         hq=r"(\d+)", hv=r"(\d+)"), src)}
        cu, lib = out / f"fa_tc_{i}.cu", out / f"libfa_tc_{i}.so"
        cu.write_text(src)
        proc = subprocess.Popen([build._nvcc(), *NVCC_FLAGS, "-I",
                                 str(build.CSRC), "-o", str(lib), str(cu)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo.append((spec, pairs or list(tiles), tiles, lib, proc))
    built = []
    for spec, pairs, tiles, lib, proc in todo:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {spec} failed to build:\n{log}")
        fn = ctypes.CDLL(str(lib)).flash_attention_tc_launch
        fn.argtypes, fn.restype = fa._fn_tc().argtypes, ctypes.c_int
        smem = {(hq, hv): 2 * (64 * nc * hq + st * 64 * (hq + hv)) + 1152
                for (hq, hv), (nc, st) in tiles.items()}
        built.append({"spec": spec, "pairs": pairs, "fn": fn, "smem": smem,
                      "ptxas": build.ptxas_report(log)})
    return built


def run_variant(var: dict, q, k, v, kind: str, window: int):
    """One launch of a variant's library, as `fa._launch_tc` launches
    the kernel."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    strides = [s for t in (q, k, v) for s in fa._tma_strides(t)]
    o = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    err = var["fn"](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, B, Sq, Sk, H, Hkv, hd, hd_v, fa.KINDS[kind], window,
                    hd ** -0.5 * fa.LOG2E, (ctypes.c_longlong * 9)(*strides),
                    var["smem"][fa.tc_widths(hd, hd_v)],
                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant {var['spec']}: CUDA error {err}")
    return o


def check(what: str, got, want) -> dict:
    err = (got.float() - want.float()).abs()
    bad = bool((err > TOL[1] + TOL[0] * want.float().abs()).any())
    ratio = float(err.square().mean().sqrt()
                  / want.float().square().mean().sqrt())
    if bad or not ratio <= RMS or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: max abs err {float(err.max())}, "
                             f"error RMS {ratio:.4%} of the plain output's")
    return {"max_abs_err": float(err.max()), "err_rms_ratio": ratio}


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--configs", default=",".join(RUNS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fa_tc_variants: no CUDA device")
    import torch.nn.functional as F
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build.build_all()
    lines = [{"ptxas": "flash_attention_tc.cu", "instantiations":
              build.ptxas_report(build.build_log.get(
                  "flash_attention_tc", ""))}]
    variants = build_variants(a.variant)
    lines += [{"ptxas": v["spec"], "instantiations": v["ptxas"]}
              for v in variants]
    for line in lines:
        print(json.dumps(line), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name in a.configs.split(","):
        q, k, v, kind, window = inputs(name, gen)
        hd, hd_v = q.shape[-1], v.shape[-1]
        pair = fa.tc_widths(hd, hd_v)
        plain = fa.flash_attention_plain(q, k, v, kind=kind, window=window)
        calls = {"kernel": lambda: fa.flash_attention_kernel(
            q, k, v, kind=kind, window=window)}
        rec = {"config": name, "q": list(q.shape), "k": list(k.shape),
               "v": list(v.shape), "v_strides": list(v.stride()),
               "kind": kind, "window": window, "pair": list(pair),
               "tile": list(fa.TC_HEAD_DIMS[pair])}
        rec["kernel"] = check(f"{name} kernel", calls["kernel"](), plain)
        for var in variants:
            if pair in var["pairs"]:
                f = (lambda var=var: run_variant(var, q, k, v, kind, window))
                rec[var["spec"]] = check(f"{name} {var['spec']}", f(), plain)
                calls[var["spec"]] = f
        del plain
        calls["cuda_cores"] = lambda: fa._launch_core(q, k, v, kind, window)
        if kind == "causal":
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        order = list(calls)
        ms = {n: [] for n in order}
        for turn in (order, order[::-1]):
            for n in turn:
                ms[n].append(cuda_ms(calls[n], a.reps if n != "cuda_cores"
                                     else max(2, a.reps // 10)))
        rec["ms"] = {n: min(t) for n, t in ms.items()}
        rec["ms_turns"] = ms
        rec["nvidia_smi"] = smi
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del q, k, v, calls
        torch.cuda.empty_cache()
    print(smi, flush=True)
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text(
            "\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
