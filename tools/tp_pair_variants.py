"""The dense tensor-parallel pair's designs, timed side by side at the
process mesh's shape.

    python3 tools/tp_pair_variants.py [--parent OTHER.cu] [--d-loc 1000,500]
                                      [--variant LABEL=STEP.cu ...]
                                      [--trace] [--reps 50] [--out FILE]

Builds the port's kernels and, with ``--parent``, another version of
`csrc/sdca_bucket_tp.cu` that exports the two-kernel pair
(`sdca_bucket_tp_partials_launch`, `sdca_bucket_tp_solve_launch`; say
the parent commit's, unpacked by `git archive` under `build/`), with
the same nvcc flags.  At one worker and one lane of d_loc rows, B 16,
for each objective, on inputs drawn from a seed, it holds one bucket of
each design to the plain version (`chip_smoke.TOL_TP`) and times it in
turns (each design twice, in mirrored order) with `chip_smoke.cuda_ms`,
the timer `chip_smoke.py` reads its kernels with:

  * ``fused``: one launch of the step, bucket b's solve and bucket b+1's
    partials (what `ops.sdca_bucket_tp_subepoch` runs);
  * ``split``: the same kernel twice a bucket, the solve alone then the
    next bucket's partials alone (two kernels, each with the tile
    staged in shared memory); bitwise the fused step; ``solve`` and
    ``partials``: each of the two alone;
  * ``parent``: the other source's partials, then its solve;
  * ``plain``: the plain bucket (`core.sdca.tp_partials`, the lane sum,
    `tp_solve`); ``cublas``: `x^T [v | x]` on a prebuilt operand, the
    partials' [m0 | G] in one cuBLAS call (TF32 off; the port never
    calls it).

Each ``--variant`` builds another version of the step's source (one
that exports `sdca_bucket_tp_step_launch` with the same arguments; its
headers are looked up in `csrc/` too) and times its fused step, solve
and partials beside the port's, held to the plain version likewise.  A
variant whose layout differs exports `sdca_bucket_tp_step_smem(B)`; one
that exports `tp_trace_read(long long*, int)` (clock64 stamps of its
last launch) has them printed after one fused step.  ``--trace`` adds
such a variant, ``trace``: a copy of the step's source with clock64
stamps of block 0 at the points `TRACE_POINTS` names (the stage points
for the first 5 stages), printed as cycles since the block's start.

Prints the ptxas report of each build, one JSON line per (d_loc,
objective) and the card's name and power limit; needs one CUDA GPU and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import sdca  # noqa: E402
from repro_torch.core.objectives import get_objective  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sdca_bucket as kd  # noqa: E402
from repro_torch.kernels.contracts import NVCC_FLAGS  # noqa: E402

B = 16
NB = 4                      # buckets of the drawn tiles (b 0 and 1 run)
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_parent(src: pathlib.Path) -> tuple[dict, list]:
    """The other source's two entries, built beside the port's kernels
    (its headers from its own directory)."""
    out = build.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libsdca_bucket_tp_parent.so"
    proc = subprocess.run([build._nvcc(), *NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{src} failed to build:\n{proc.stdout}"
                         f"{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    fns = {"partials": so.sdca_bucket_tp_partials_launch,
           "solve": so.sdca_bucket_tp_solve_launch}
    fns["partials"].argtypes = [P, P, P, I, I, I, I, I, I, P]
    fns["solve"].argtypes = [P] * 6 + [I] * 6 + [F, F, I, P]
    for f in fns.values():
        f.restype = ctypes.c_int
    return fns, build.ptxas_report(proc.stdout + proc.stderr)


#: where the ``--trace`` copy stamps the clock: (lines of the source the
#: stamp goes after, or before when the flag is set; the stamp's index;
#: who stamps; what it marks)
TRACE_POINTS = (
    ("  __syncthreads();\n", False, "0", "threadIdx.x == 0", "start"),
    ("  __syncwarp();\n  bucket_recursion", True, "1", "lane == 0",
     "chain: [m0 | G], a, y staged"),
    ("  for (int i = lane; i < B; i += 32)\n    p.a_out", True, "2",
     "lane == 0", "chain: recursion done"),
    ("    mbar_arrive_expect_tx(sm.full + s, bytes);\n", False, "100 + q",
     "q < 60", "producer: item q issued (100 + q)"),
    ("  mbar_wait(sm.full + q % kSlots, (q / kSlots) & 1);\n", False,
     "3 + q", "threadIdx.x == 64 && q < 60",
     "compute: item q landed (3 + q)"),
    ("  // 2. per stage: bucket b's rows update v, bucket nxt's rows take "
     "m0\n", False, "70", "ct == 0", "compute: G formed"),
    ("  if (have_b) bar_sync(kBarDeltas, 32 + kComputeThreads);\n", False,
     "71", "ct == 0", "compute: deltas in"),
    ("      vb = vn;\n", False, "150 + 3 * k", "ct == 0 && k < 5",
     "compute: stage k's v rows updated (150 + 3k)"),
    ("      if (have_n) bar_sync(kBarCompute, kComputeThreads);\n", False,
     "151 + 3 * k", "ct == 0 && k < 5", "compute: stage k's barrier"),
    ("        vr += kComputeWarps;\n      }\n", False, "152 + 3 * k",
     "ct == 0 && k < 5", "compute: stage k's m0 (152 + 3k)"),
    ("    q += have_b + have_n;\n", False, "72 + k", "ct == 0 && k < 20",
     "compute: stage k done (72 + k)"),
    ("      out[(size_t)j * ld] = s;\n    }\n  }\n", False, "95",
     "ct == 0", "compute: m0 written"),
)


def trace_source() -> pathlib.Path:
    """A copy of the step's source that stamps `TRACE_POINTS` (block 0)
    into a device array and exports `tp_trace_read`."""
    src = (build.CSRC / "sdca_bucket_tp.cu").read_text()
    for anchor, before, idx, who, _ in TRACE_POINTS:
        if src.count(anchor) != 1:
            raise SystemExit(f"--trace: {anchor!r} is not one place of "
                             f"the source")
        at = src.index(anchor) + (0 if before else len(anchor))
        src = (src[:at] + f"  if (blockIdx.x == 0 && ({who})) "
               f"g_trace[{idx}] = clock64();\n" + src[at:])
    src = src.replace("namespace {\n\nconstexpr",
                      "__device__ long long g_trace[256];\n\nnamespace {"
                      "\n\nconstexpr", 1)
    src += ('\nextern "C" int tp_trace_read(long long* out, int n) {\n'
            "  static const long long zero[256] = {};\n"
            "  n = n < 256 ? n : 256;\n"
            "  cudaMemcpyFromSymbol(out, g_trace, n * sizeof(long long));\n"
            "  cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));\n"
            "  return n;\n}\n")
    out = build.build_dir() / "variants" / "sdca_bucket_tp_trace.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def build_variant(label: str, src: pathlib.Path) -> dict:
    """Another version of the step's source -> {"entry", "smem",
    "trace", "ptxas"}."""
    out = build.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libsdca_bucket_tp_{label}.so"
    proc = subprocess.run([build._nvcc(), *NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {label} failed to build:\n"
                         f"{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    entry = so.sdca_bucket_tp_step_launch
    entry.argtypes = [P] * 7 + [I] * 7 + [F, F, I, I, P]
    entry.restype = ctypes.c_int
    smem = kd.tp_step_smem_bytes
    if hasattr(so, "sdca_bucket_tp_step_smem"):
        smem = so.sdca_bucket_tp_step_smem
        smem.argtypes, smem.restype = [I], ctypes.c_int
    trace = getattr(so, "tp_trace_read", None)
    if trace is not None:
        trace.argtypes, trace.restype = [P, I], ctypes.c_int
    return {"label": label, "entry": entry, "smem": smem, "trace": trace,
            "ptxas": build.ptxas_report(proc.stdout + proc.stderr)}


@functools.lru_cache(maxsize=None)
def port_design() -> dict:
    return {"label": "port", "entry": kd.c_entry(
        "sdca_bucket_tp", "ppppppp" "iiiiiii" "ff" "ii" "p",
        "sdca_bucket_tp_step_launch"), "smem": kd.tp_step_smem_bytes,
        "trace": None}


def step_raw(obj, total, xb, yb, ab, v, b: int, nxt: int, lam_n, sig,
             design=None):
    """One launch of a design's step kernel with an explicit (b, nxt):
    -1 for no solve or no partials (the wrapper always forms b + 1's)."""
    design = design or port_design()
    entry = design["entry"]
    W, nb, d_loc, _ = xb.shape
    a = torch.empty((W, 1, B), device=xb.device) if b >= 0 else None
    parts = (torch.empty((W, 1, B, B + 1), device=xb.device)
             if nxt >= 0 else None)
    ptr = (lambda t: t.data_ptr() if t is not None else None)  # noqa: E731
    err = entry(ptr(total), xb.data_ptr(), yb.data_ptr(), ab.data_ptr(),
                v.data_ptr(), ptr(a), ptr(parts), W, 1, nb, b, nxt, d_loc,
                B, lam_n, sig, kd.OBJ_CODES[obj.name], design["smem"](B),
                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{design['label']} step (b {b}, nxt {nxt}): "
                           f"CUDA error {err}")
    return a, parts


def parent_bucket(fns, obj, xb, yb, ab, v, b: int, lam_n, sig):
    """The other source's bucket: its partials, then its solve."""
    W, nb, d_loc, _ = xb.shape
    s = torch.cuda.current_stream().cuda_stream
    parts = torch.empty((W, 1, B, B + 1), device=xb.device)
    err = fns["partials"](xb.data_ptr(), v.data_ptr(), parts.data_ptr(), W,
                          1, nb, b, d_loc, B, s)
    total = parts[:, 0].contiguous()
    a = torch.empty((W, 1, B), device=xb.device)
    err = err or fns["solve"](
        total.data_ptr(), xb.data_ptr(), yb.data_ptr(), ab.data_ptr(),
        v.data_ptr(), a.data_ptr(), W, 1, nb, b, d_loc, B, lam_n, sig,
        kd.OBJ_CODES[obj.name], s)
    if err:
        raise RuntimeError(f"parent pair: CUDA error {err}")
    return a


def one_case(d_loc: int, name: str, rng, fns, reps: int,
             variants=()) -> dict:
    dev = torch.device("cuda")
    obj = get_objective(name)
    xb = torch.as_tensor((rng.standard_normal((1, NB, d_loc, B))
                          / np.sqrt(d_loc)).astype(np.float32), device=dev)
    v0 = torch.as_tensor(0.1 * rng.standard_normal((1, d_loc)).astype(
        np.float32), device=dev)
    y, a = chip_smoke._check_inputs(rng, 1, NB * B, name, dev)
    yb, ab = y.reshape(1, NB, B), a.reshape(1, NB, B)
    lam_n, sig = 1e-3 * 4 * NB * B, 4.0
    lam_t, sig_t = (torch.tensor(x, device=dev) for x in (lam_n, sig))
    tol = chip_smoke.TOL_TP
    # bucket 0 from v0, then bucket 1's partials: every design against
    # the plain version
    X0 = xb[:, 0].reshape(1, 1, d_loc, B)
    total = sdca.lane_ordered_sum(sdca.tp_partials(X0, v0[:, None]))
    deltas, v_p = sdca.tp_solve(obj, total, X0, ab[:, 0], yb[:, 0],
                                v0[:, None], lam_t, sig_t)
    a_p = ab[:, 0] + deltas
    parts_p = sdca.tp_partials(xb[:, 1].reshape(1, 1, d_loc, B), v_p)
    total = kd.sdca_bucket_tp_step(obj, None, xb, yb, ab, v0.clone(), -1,
                                   lam_n, sig, model_lanes=1)[1][:, 0]
    total = total.contiguous()
    rec = {"d_loc": d_loc, "B": B, "objective": name}
    v_f = v0.clone()
    a_f, parts_f = step_raw(obj, total, xb, yb, ab, v_f, 0, 1, lam_n, sig)
    v_s = v0.clone()
    a_s, _ = step_raw(obj, total, xb, yb, ab, v_s, 0, -1, lam_n, sig)
    _, parts_s = step_raw(obj, None, xb, yb, ab, v_s, -1, 1, lam_n, sig)
    if not (torch.equal(a_f, a_s) and torch.equal(v_f, v_s)
            and torch.equal(parts_f, parts_s)):
        raise AssertionError(f"{name} d_loc {d_loc}: split != fused")
    rec["fused_max_abs_err"] = max(
        chip_smoke._within(f"fused {name}", k, p, tol)
        for k, p in ((a_f[:, 0], a_p), (v_f, v_p[:, 0]),
                     (parts_f, parts_p)))
    calls = {
        "fused": lambda: step_raw(obj, total, xb, yb, ab, v_f, 0, 1, lam_n,
                                  sig),
        "split": lambda: (step_raw(obj, total, xb, yb, ab, v_s, 0, -1,
                                   lam_n, sig),
                          step_raw(obj, None, xb, yb, ab, v_s, -1, 1, lam_n,
                                   sig)),
        "solve": lambda: step_raw(obj, total, xb, yb, ab, v_s, 0, -1,
                                  lam_n, sig),
        "partials": lambda: step_raw(obj, None, xb, yb, ab, v_s, -1, 1,
                                     lam_n, sig),
        "plain": lambda: sdca.tp_solve(
            obj, sdca.lane_ordered_sum(sdca.tp_partials(X0, v0[:, None])),
            X0, ab[:, 0], yb[:, 0], v0[:, None], lam_t, sig_t)}
    if fns is not None:
        v_q = v0.clone()
        a_q = parent_bucket(fns, obj, xb, yb, ab, v_q, 0, lam_n, sig)
        rec["parent_max_abs_err"] = max(
            chip_smoke._within(f"parent {name}", k, p, tol)
            for k, p in ((a_q[:, 0], a_p), (v_q, v_p[:, 0])))
        calls["parent"] = lambda: parent_bucket(fns, obj, xb, yb, ab, v_q,
                                                0, lam_n, sig)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for var in variants:
        lab, v_v = var["label"], v0.clone()
        buf = (ctypes.c_longlong * 256)()
        if var["trace"] is not None:          # clears the earlier stamps
            var["trace"](ctypes.cast(buf, P), 256)
        a_v, parts_v = step_raw(obj, total, xb, yb, ab, v_v, 0, 1, lam_n,
                                sig, var)
        rec[f"{lab}_max_abs_err"] = max(
            chip_smoke._within(f"{lab} {name}", k, p, tol)
            for k, p in ((a_v[:, 0], a_p), (v_v, v_p[:, 0]),
                         (parts_v, parts_p)))
        if var["trace"] is not None:
            torch.cuda.synchronize()
            n = var["trace"](ctypes.cast(buf, P), 256)
            rec[f"{lab}_trace"] = {i: buf[i] - buf[0] for i in range(n)
                                   if buf[i]}
        calls[f"{lab}_fused"] = (
            lambda var=var, v_v=v_v: step_raw(obj, total, xb, yb, ab, v_v,
                                              0, 1, lam_n, sig, var))
        calls[f"{lab}_solve"] = (
            lambda var=var, v_v=v_v: step_raw(obj, total, xb, yb, ab, v_v,
                                              0, -1, lam_n, sig, var))
        calls[f"{lab}_partials"] = (
            lambda var=var, v_v=v_v: step_raw(obj, None, xb, yb, ab, v_v,
                                              -1, 1, lam_n, sig, var))
    x = xb[0, 1]
    xv = torch.cat([v0[0, :, None], x], dim=1).contiguous()
    calls["cublas"] = lambda: torch.matmul(x.mT, xv)
    order = list(calls)
    ms = {k: [] for k in order}
    try:
        for k in order + order[::-1]:
            calls[k]()
            ms[k].append(chip_smoke.cuda_ms(calls[k], 3 if k == "plain"
                                            else reps))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rec.update({f"{k}_ms": sum(v) / len(v) for k, v in ms.items()})
    rec.update({f"{k}_ms_readings": v for k, v in ms.items()})
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--d-loc", default="1000,500")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tp_pair_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build.build_all()
    lines = [{"ptxas": "sdca_bucket_tp.cu", "instantiations":
              build.ptxas_report(build.build_log.get("sdca_bucket_tp", ""))}]
    fns = None
    if a.parent is not None:
        fns, rep = build_parent(a.parent)
        lines.append({"ptxas": str(a.parent), "instantiations": rep})
    variants = [build_variant(*spec.split("=", 1)) for spec in a.variant]
    if a.trace:
        variants.append(build_variant("trace", trace_source()))
        print(json.dumps({"trace_points": {
            idx: name for *_, idx, _, name in TRACE_POINTS}}), flush=True)
    for var in variants:
        print(json.dumps({"ptxas": var["label"],
                          "instantiations": var["ptxas"]}), flush=True)
    rng = np.random.default_rng(29)
    for d_loc in map(int, a.d_loc.split(",")):
        for name in ("logistic", "ridge", "hinge"):
            lines.append(one_case(d_loc, name, rng, fns, a.reps, variants))
            print(json.dumps(lines[-1]), flush=True)
    lines.append({"nvidia_smi": smi})
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text(
            "\n".join(json.dumps(x) for x in lines) + "\n")
    print(json.dumps(lines[0]))
    if fns is not None:
        print(json.dumps(lines[1]))
    print(smi)


if __name__ == "__main__":
    main()
