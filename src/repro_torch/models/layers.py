"""Shared building blocks: param specs, norms, MLPs, RoPE.

Mirrors the reference's `models/layers.py` on tensors.  Two places
where PyTorch's defaults differ from JAX's, kept as the reference has
them: GELU is the tanh approximation (`jax.nn.gelu`'s default; the
exact erf form differs by up to 5e-4 per element), and RoPE rotates
split halves, not interleaved pairs.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Shape and dtype of one decode-cache leaf (the reference's
    `jax.ShapeDtypeStruct`)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def tree_map(fn, tree, *rest):
    """Apply `fn` to the leaves of nested dicts and lists (the port's
    parameter and cache trees), pairing leaves of `rest` by position."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts and lists, in insertion order."""
    out = []
    tree_map(out.append, tree)
    return out


def _fields(tree):
    """A named tuple's field names, else None."""
    return getattr(tree, "_fields", None) if isinstance(tree, tuple) \
        else None


def tree_items(tree, path: tuple = ()):
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, lists and tuples in order, a named tuple's fields in order
    with the path entry ``.<name>`` (how JAX prints it); `None` is an
    empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif _fields(tree) is not None:
        for f, v in zip(tree._fields, tree):
            yield from tree_items(v, path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    elif tree is not None:
        yield path, tree


def tree_map_path(fn, tree, *rest, path: tuple = ()):
    """`tree` with each leaf replaced by fn(path, leaf, *whatever `rest`
    holds at the same place, a subtree there passed whole); containers,
    their types and key order kept, paths as `tree_items` gives them."""
    if isinstance(tree, dict):
        return {k: tree_map_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    if _fields(tree) is not None:
        return type(tree)(*(tree_map_path(fn, v, *(r[i] for r in rest),
                                          path=path + (f".{f}",))
                            for i, (f, v) in enumerate(zip(tree._fields,
                                                           tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_path(fn, v, *(r[i] for r in rest),
                                        path=path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree, *rest)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape, dtype and initializer of one parameter, and its partition
    on a mesh: `pspec`, one entry a dimension, each None (replicated),
    an axis name or a tuple of names (split over them, the first the
    major), as `launch.glm.InputSpec.partition` reads it; () is
    replicated.  The dry run's spec transforms (`launch/steps.py`) read
    it; the one-card train and serve paths do not."""
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"       # normal | zeros | ones
    scale: float | None = None  # stddev; default 1/sqrt(fan_in)
    pspec: tuple = ()

    def initializer(self, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        """Draw the parameter on `device` from `gen` (a generator on that
        device): normal in f32 times 1/sqrt(fan_in) unless `scale` is
        set, then cast to `dtype`.  The draws are not JAX's.  The scale
        is applied in place, so a leaf's draw peaks at 1.5x its f32
        bytes (the f32 draw and the cast), not 2.5x: kimi-k2's expert
        leaves are 22.5 GB each in f32."""
        return self.draw(gen, device).to(self.dtype)

    def draw(self, gen: torch.Generator,
             device: torch.device) -> torch.Tensor:
        """`initializer`'s draw before its cast to `dtype` (f32 for the
        normal init): the cast is elementwise, so a slice cast alone
        equals the slice of the cast whole."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        std = self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(std)


def materialize(specs, gen: torch.Generator, device: torch.device):
    """Tree of ParamSpec -> tree of tensors, drawn in leaf order from
    `gen`."""
    return tree_map(lambda s: s.initializer(gen, device), specs)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * scale) * gamma.float()).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def mlp_specs(d: int, ff: int, *, gated: bool = True,
              dtype=torch.bfloat16) -> dict:
    """SwiGLU (gated) or plain 2-layer MLP."""
    sp = {"w_up": ParamSpec((d, ff), dtype, pspec=(None, "model")),
          "w_down": ParamSpec((ff, d), dtype, pspec=("model", None))}
    if gated:
        sp["w_gate"] = ParamSpec((d, ff), dtype, pspec=(None, "model"))
    return sp


def mlp_apply(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = act_fn(act)
    if "w_gate" in p:
        h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = a(x @ p["w_up"])
    return h @ p["w_down"]


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    # theta stays a Python scalar: a 0-d tensor made from it on the card
    # is a blocking host-to-device copy, which stalls every decode step
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / torch.pow(theta, ex)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer.  Split-half
    rotation: [x1 cos - x2 sin, x1 sin + x2 cos]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
