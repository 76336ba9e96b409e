"""Input shapes, applicability rules and input specs of the dry run.

The reference's `launch/specs.py`: every dry-run cell is (architecture
x input shape x mesh).  This module owns the four LM shapes, the skip
rule (long_500k only for the sub-quadratic families), and the records
of every model input, each an `InputSpec` (global shape, dtype,
partition over the mesh's axes) in place of the reference's
ShapeDtypeStructs.  Nothing is allocated: `shard_shape` gives a
record's per-device shape on an `launch.mesh.AbstractMesh`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.glm import InputSpec
from repro_torch.models import lm
from repro_torch.models.layers import tree_map
from repro_torch.sharding import keep_axes

BATCH = ("pod", "data")      # batch axes (pod absent on a one-pod mesh)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq: int
    batch: int
    kind: str                # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}

# Architectures whose every token attends over the whole context have
# no sub-quadratic path, so the 524k decode cell is run only for these.
_SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def applicable(cfg, shape: ShapeCfg) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC_FAMILIES:
        return False, ("pure full-attention arch: no sub-quadratic path at "
                       "524k context (skip noted in DESIGN.md S4)")
    return True, ""


def clean_pspec(mesh, spec) -> tuple:
    """Drop axis names absent from `mesh` (so BATCH works on both
    meshes)."""
    return keep_axes(spec, mesh.axis_names)


def shard_shape(shape, partition, mesh) -> tuple:
    """The per-device shape of a (shape, partition) record on `mesh`:
    each dimension divided by the sizes of the axes it is split over
    (partition entries past the shape's rank, or missing, replicate)."""
    out = []
    for i, size in enumerate(shape):
        e = partition[i] if i < len(partition) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        k = math.prod(mesh.shape.get(a, 1) for a in axes)
        if size % k:
            raise ValueError(f"dimension {size} of {tuple(shape)} does not "
                             f"split over {axes} ({k} shards)")
        out.append(size // k)
    return tuple(out)


def spec_bytes(spec: InputSpec, mesh=None) -> int:
    """Bytes of one record: global, or per device on `mesh`."""
    shape = spec.shape if mesh is None else shard_shape(
        spec.shape, spec.partition, mesh)
    return math.prod(shape) * spec.dtype.itemsize


def _spec(mesh, shape, dtype, partition) -> InputSpec:
    return InputSpec(tuple(shape), dtype, clean_pspec(mesh, partition))


def cache_pspec(shape: tuple, mdiv: int, bdiv: int,
                stacked: bool = False) -> tuple:
    """The partition of one decode-cache tensor.

    Batch (dim 0 after any stacking dim) splits over ('pod', 'data')
    when divisible.  One feature-ish dim splits over 'model': the
    heads / latent dim (index 2+) before the last dim; never the
    sequence dim of a (B, S, ...) cache; a 2-D (B, feat) cache splits
    feat."""
    lead = (None,) if stacked else ()
    shp = shape[1:] if stacked else shape
    entries = [BATCH if shp[0] % bdiv == 0 else None] + \
        [None] * (len(shp) - 1)
    candidates = list(range(2, len(shp))) if len(shp) > 2 else \
        ([1] if len(shp) == 2 else [])
    for i in candidates:
        if shp[i] % mdiv == 0 and shp[i] >= mdiv:
            entries[i] = "model"
            break
    return lead + tuple(entries)


def cache_specs(cfg, mesh, batch: int, max_seq: int) -> dict:
    """The decode caches' records, in the reference's stacked layout
    ("head" and "tail" lists, "blocks" one dict of n_rep-stacked
    leaves)."""
    shapes = lm.cache_shapes(cfg, batch, max_seq, stacked=True)
    mdiv = mesh.shape.get("model", 1)
    bdiv = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)

    def map_tree(tree, stacked):
        return tree_map(lambda s: _spec(mesh, s.shape, s.dtype, cache_pspec(
            tuple(s.shape), mdiv, bdiv, stacked)), tree)

    return {
        "head": [map_tree(c, False) for c in shapes["head"]],
        "blocks": map_tree(shapes["blocks"], True),
        "tail": [map_tree(c, False) for c in shapes["tail"]],
    }


def input_specs(cfg, shape: ShapeCfg, mesh) -> dict:
    """-> the records of one (arch x shape) cell's inputs.

    train:   {tokens, labels [, frames | patches]}
    prefill: {tokens [, frames | patches]}
    decode:  {tokens (B, 1), cache, pos}   (cross caches hold the
             encoder's state, so no frames)"""
    B, S = shape.batch, shape.seq
    baxes = cfg.batch_axes if shape.kind == "train" else BATCH
    bdiv = math.prod(mesh.shape.get(a, 1) for a in baxes)
    bspec = baxes if B % bdiv == 0 else None   # batch-1 cells replicate

    def tok(b, s):
        return _spec(mesh, (b, s), torch.int32, (bspec, None))

    def frames():
        return _spec(mesh, (B, cfg.enc_seq, cfg.d_model), torch.float32,
                     (bspec, None, None))

    def patches():
        return _spec(mesh, (B, cfg.n_patches, cfg.d_model), torch.float32,
                     (bspec, None, None))

    if shape.kind in ("train", "prefill"):
        s_tok = S - cfg.n_patches if cfg.frontend == "vision" else S
        out = {"tokens": tok(B, s_tok)}
        if shape.kind == "train":
            out["labels"] = tok(B, s_tok)
        if cfg.frontend == "vision":
            out["patches"] = patches()
        if cfg.frontend == "audio":
            out["frames"] = frames()
        return out
    return {"tokens": tok(B, 1), "cache": cache_specs(cfg, mesh, B, S),
            "pos": InputSpec((), torch.int32, ())}
