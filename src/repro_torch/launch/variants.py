"""The flash-attention variant of a dry-run record.

The reference's `launch/variants.py` replaces the attention term its
HLO count measured by a closed form of the flash kernel's cost.  In the
port the count's `attn_term.*` already is B5's own cost, call by call
(`kernels/costs.py`, forward and backward), so the substitution is a
comparison: the record keeps the per-call count (`attn_measured.*`)
beside `flash_analytic`'s closed form (`attn_flash.*`), and the
roofline with the closed form in place of the per-call count.

    PYTHONPATH=src python -m repro_torch.launch.variants \\
        --arch minicpm3-4b --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.configs import get_config
from repro_torch.launch.cost_analysis import Roofline
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.launch.specs import SHAPES

DRYRUN = pathlib.Path(__file__).resolve().parents[3] / "experiments"

# train = fwd + bwd (~2.5x fwd, flash recomputes p) for flops; bytes:
# fwd reads q, k, v writes o; bwd reads q, k, v, o, do writes dq, dk, dv
_TRAIN_FLOP_MULT = 3.5
_TRAIN_BYTE_MULT = 3.0


def flash_analytic(cfg, shape, chips: int) -> dict:
    """Per-device closed-form flops / bytes of every flash-attention
    call in one step (self-attention of every layer; cross-attention
    left out), the reference's formula."""
    B, S = shape.batch, shape.seq
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.attention == "mla":
        hd_qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        hd_v = cfg.v_head_dim
    else:
        hd_qk = hd_v = cfg.head_dim
    n_attn = cfg.n_layers
    if cfg.block_pattern:
        per = sum(k in ("attn", "attn_local")
                  for k in cfg.block_pattern)
        n_attn = cfg.n_layers * per // len(cfg.block_pattern)

    # effective kv length per query: causal -> S/2; local -> window
    if cfg.attention == "local":
        s_eff = min(cfg.window, S)
    else:
        s_eff = S / 2
    flops_fwd = 2.0 * B * S * s_eff * H * (hd_qk + hd_v) * n_attn
    bytes_fwd = (B * S * H * hd_qk + 2 * B * S * Hkv * hd_qk
                 + B * S * H * hd_v) * 2.0 * n_attn
    mult_f = _TRAIN_FLOP_MULT if shape.kind == "train" else 1.0
    mult_b = _TRAIN_BYTE_MULT if shape.kind == "train" else 1.0
    return {"flops": flops_fwd * mult_f / chips,
            "bytes accessed": bytes_fwd * mult_b / chips}


def flash_variant(arch: str, shape_name: str, mesh: str = "pod",
                  base_dir: str = "dryrun_torch") -> dict:
    """Read `<base_dir>/<arch>__<shape>__<mesh>.json`, write the record
    with `roofline_flash` and `flash_substitution` beside it
    (`..__flash.json`) and return it."""
    src = DRYRUN / base_dir / f"{arch}__{shape_name}__{mesh}.json"
    rec = json.loads(src.read_text())
    cnt = rec["counting"]
    fa = flash_analytic(get_config(arch), SHAPES[shape_name], rec["chips"])
    out = {}
    for key in ("flops", "bytes accessed"):
        attn = cnt.get(f"attn_term.{key}", 0.0)
        out[key] = cnt[key] - attn + fa[key]
        out[f"attn_measured.{key}"] = attn
        out[f"attn_flash.{key}"] = fa[key]
    rl = Roofline(flops=out["flops"], hbm_bytes=out["bytes accessed"],
                  coll_bytes=cnt["coll"], peak_flops=PEAK_FLOPS,
                  hbm_bw=HBM_BW, link_bw=LINK_BW)
    result = dict(rec, roofline_flash=rl.as_dict(), flash_substitution=out)
    src.with_name(src.stem + "__flash.json").write_text(
        json.dumps(result, indent=1))
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--base-dir", default="dryrun_torch")
    args = ap.parse_args()
    r = flash_variant(args.arch, args.shape, args.mesh, args.base_dir)
    base = r.get("roofline", r["raw_roofline"])
    opt = r["roofline_flash"]
    print(f"{args.arch} {args.shape}:")
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "bottleneck"):
        print(f"  {k:16s} base={base[k]!s:>10} flash={opt[k]!s:>10}")


if __name__ == "__main__":
    main()
