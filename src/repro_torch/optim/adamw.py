"""AdamW with f32, bf16 or int8 moments: the reference's `optim/adamw.py`
on tensors.

The state's dtype is the config's `opt_dtype` (`launch.steps.
make_opt_cfg`): f32 for fidelity, bf16 to halve the moments' bytes, or
"int8", 8-bit-Adam-style moments with one f32 scale per row of the last
axis (`QMoment`), requantised from fresh f32 values every step so that
quantisation noise does not accumulate beyond one step.  The ZeRO
state specs (how a mesh splits the moments) are `launch/steps.py`
`opt_state_specs`; on a process mesh `apply` updates this rank's
shards (`shards=`).

Three places where the numbers depend on how the reference writes it,
kept as it writes them:

  * weight decay applies to a leaf of the reference's rank >= 2.  The
    reference stacks every leaf of a repeated block with a leading n_rep
    axis, so the norm gains and biases of repeated blocks, (n_rep, d),
    are decayed there while those of head, tail and encoder blocks, (d,),
    are not.  The port keeps one dict per superblock, so a leaf under
    a `STACKED` top-level key ("blocks") counts one axis more than it
    has;
  * the bias corrections are 1 - b ** step in f32, not in Python
    doubles;
  * the int8 scale is max(amax, 1e-30) / 127, a division (the source's
    and eager JAX's; XLA rewrites a jitted division by the constant
    into a multiply by its reciprocal, so a jitted reference step can
    round a scale one ulp apart; `optim/compression.py`'s wire, which
    matches the jitted GLM programs, multiplies and is not used here).

The update runs with no graph (`torch.no_grad`) and writes the
parameters and moments IN PLACE (the reference's train loop donates
both to its jitted step), so a train step holds one copy of the
optimizer state; a leaf of two or more axes is updated a chunk of whole
rows at a time (`CHUNK_ELEMS`; a row's int8 scale needs the row), so
its f32 working copies stay small, with the whole leaf's bits
(recurrentgemma-2b's 3-step run on an H100 peaks at 48.32 GB so, at
61.43 GB with each leaf taken whole).  The step counter is a 0-d int32
tensor on the parameters' device, so a step needs no transfer from the
host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.layers import tree_items, tree_map_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Any = torch.float32     # torch.float32 | torch.bfloat16 | "int8"
    grad_clip: float = 1.0


class QMoment(NamedTuple):
    """int8 moment with per-row (last-axis) f32 scales (q's shape with the
    last axis 1)."""
    q: torch.Tensor
    scale: torch.Tensor


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any


def _f32(value: float, device) -> torch.Tensor:
    """A 0-d f32 tensor on `device`, filled there (no host copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _quant(x: torch.Tensor, row_max=None) -> QMoment:
    amax = x.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:       # a row split over ranks: its shards' max
        amax = row_max(amax)
    # a 0-d tensor divisor: PyTorch runs a CUDA division by a Python
    # scalar as a multiply by its reciprocal
    scale = torch.clamp_min(amax, 1e-30) / _f32(127.0, x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QMoment(q, scale)


def _dequant(m) -> torch.Tensor:
    if isinstance(m, QMoment):
        return m.q.float() * m.scale
    return m.float()


#: elements of a leaf that one chunk of `apply`'s f32 working copies
#: covers (256 MiB a copy; recurrentgemma-2b's embedding of 655M
#: entries would hold each working copy at 2.6 GB)
CHUNK_ELEMS = 1 << 26


def _row_chunks(p: torch.Tensor) -> list:
    """Slices of p's first axis of at most CHUNK_ELEMS elements each
    (whole rows; one slice for a leaf of fewer than two axes)."""
    if p.dim() < 2 or p.numel() <= CHUNK_ELEMS:
        return [slice(None)]
    per = max(1, CHUNK_ELEMS // (p.numel() // p.shape[0]))
    return [slice(i, i + per) for i in range(0, p.shape[0], per)]


def _rows(m, sl):
    return QMoment(m.q[sl], m.scale[sl]) if isinstance(m, QMoment) else m[sl]


def _store(dst, x32: torch.Tensor, sl, row_max=None) -> None:
    """x32 into rows `sl` of a moment in its own form (the cast of a
    copy rounds to nearest even, as `.to` does)."""
    if isinstance(dst, QMoment):
        q = _quant(x32, row_max)
        dst.q[sl] = q.q
        dst.scale[sl] = q.scale
    else:
        dst[sl] = x32


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in `cfg.state_dtype` (int8: zero q, scales 1e-30)
    and step 0, on the parameters' device."""
    dev = None

    def z(_path, p):
        nonlocal dev
        dev = p.device
        if cfg.state_dtype == "int8":
            return QMoment(torch.zeros(p.shape, dtype=torch.int8,
                                       device=p.device),
                           torch.full(tuple(p.shape[:-1]) + (1,), 1e-30,
                                      dtype=torch.float32, device=p.device))
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    mu = tree_map_path(z, params)
    nu = tree_map_path(z, params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)


#: the top-level keys of an LM's parameters whose leaves the reference
#: stacks with a leading n_rep axis (the port keeps a list of dicts)
STACKED = ("blocks",)


def ref_ndim(path: tuple, p: torch.Tensor) -> int:
    """The rank the reference's leaf at `path` has: one more under a
    `STACKED` top-level key."""
    return p.dim() + (1 if path and path[0] in STACKED else 0)


@torch.no_grad()
def apply(params, grads, state: AdamWState, cfg: AdamWConfig, *,
          shards=None):
    """One AdamW step, written into `params` and the state's moments in
    place.  Returns (params, the new state, {"grad_norm"}).

    The gradient norm sums each leaf's f32 sum of squares in the
    reference's leaf order; the clip scale is min(1, clip / max(gnorm,
    1e-12)).

    On a process mesh `params`, `grads` and the moments are this rank's
    update shards and `shards` (a `sharding.layout.LMLayout`) holds the
    rest of the model: the squares' global sum (`shards.sq_norm`: each
    leaf's shards in rank order, a replicated shard counted once, then
    the leaves in order) and an int8 row's amax over the shards its
    last axis is split over (`shards.row_max`, a max: the same bits on
    every shard)."""
    if shards is None:
        sq = None
        for _, g in tree_items(grads):
            s = torch.sum(torch.square(g.float()))
            sq = s if sq is None else sq + s
    else:
        items = list(tree_items(grads))
        sq = shards.sq_norm([p for p, _ in items],
                            [torch.sum(torch.square(g.float()))
                             for _, g in items])
    gnorm = torch.sqrt(sq)
    dev = gnorm.device
    if cfg.grad_clip:
        scale = torch.clamp_max(
            _f32(cfg.grad_clip, dev) / torch.clamp_min(gnorm, 1e-12), 1.0)
    else:
        scale = _f32(1.0, dev)
    step = state.step + 1
    stepf = step.float()
    b1c = 1 - _f32(cfg.b1, dev) ** stepf
    b2c = 1 - _f32(cfg.b2, dev) ** stepf

    def upd(path, p, g, m, v):
        decay = ref_ndim(path, p) >= 2   # decoupled, matrices only
        rmax = None if shards is None else (
            lambda a: shards.row_max(path, a))
        for sl in _row_chunks(p):
            gs = g[sl].float() * scale
            m32 = _dequant(_rows(m, sl)) * cfg.b1 + (1 - cfg.b1) * gs
            v32 = _dequant(_rows(v, sl)) * cfg.b2 + (1 - cfg.b2) * gs * gs
            u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
            pf = p[sl].float()
            if decay:
                u = u + cfg.weight_decay * pf
            p[sl] = pf - cfg.lr * u
            _store(m, m32, sl, rmax)
            _store(v, v32, sl, rmax)

    tree_map_path(upd, params, grads, state.mu, state.nu)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm}
