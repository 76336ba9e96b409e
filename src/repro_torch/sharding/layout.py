"""The LM on a process mesh: where each parameter, moment and activation
lives on a `launch.mesh.DistMesh`, and the collectives that move them.

`LMLayout(cfg, mesh)` reads the reference's partitions from the dry
run's spec transforms (`launch.steps.model_param_specs`,
`opt_state_specs`, the stacked layout), each leaf's entry for a
superblock dropped of its leading n_rep axis, and gives every leaf a
`Placement`: its global shape and, per dimension, the mesh axes (of size
> 1) it is split over.  Two layouts (`cfg.layout`):

  * "tp": tensor parallelism over 'model' by the reference's pspecs
    (`wq`, `wk`, `wv`, `w_up`, `w_gate` column-parallel, `wo`, `w_down`
    row-parallel, `embed` split along d, `lm_head` vocab-parallel), the
    batch over `cfg.batch_axes`; a rank runs attention on its own heads.
    Where 'model' does not divide the kv heads (or there are fewer of
    them than model ranks), `wk` and `wv` are all-gathered over 'model'
    and a rank computes the kv heads its q heads use.  `n_heads` that
    'model' does not divide is refused (the reference pads there);
  * "fsdp": no tensor parallelism, the batch over every axis, each
    weight all-gathered over the axes it is split on right before use.

Under ZeRO-3 (`zero="zero3"`) a weight is also split over 'data' and
gathered before use; under ZeRO-1 the moments and the update are split
over 'data' (`update_views`), the gradient reduce-scattered there
before the update and the updated shard all-gathered after it.  A
gradient is summed over the batch axes its weight is not gathered over
(the gather's reduce-scatter sums the others), in rank order.

Expert parallelism is a third kind of split.  The routed experts'
leaves (`w_gate`, `w_up`, `w_down` of a MoE block) are split over
'data' along E, as the reference's `moe_specs` puts them, and over
'model' along d; 'data' is their `Placement.ep` axis: they stay
resident on their owners and the tokens move to them (`models.moe`'s
all-to-all), so `gather` never gathers them, `sync_grads` never sums
their gradients over 'data' (every data rank's tokens reached the
owner) and ZeRO-1 splits them no further.  MLA runs column-parallel by
whole heads (`wq` / `wq_b`, `wkv_b`; `wo` row-parallel) with its latent
projections (`wkv_a`, `kv_norm`, `wq_a`, `q_norm`) replicated: the
column-parallel seam (`col_in`) sits on the latent and the normed q
latent, after the replicated part, so their gradients are whole on
every model rank.

The decoders with full attention or MLA, dense or MoE ("tp" layout;
MoE under "fsdp" is refused), run on a mesh; local attention, the
recurrent blocks, the encoder-decoder and the vision stub are later
slices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import rank_coords
from repro_torch.models.layers import (tree_items, tree_map,
                                       tree_map_path)
from repro_torch.optim import adamw
from . import collectives as coll


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's global shape and, per dimension, the live mesh axes it is
    split over (() whole), in mesh order, the first the major; `ep` the
    axes among them that are expert-parallel (the leaf stays resident
    there: never gathered, its gradient never summed over them)."""
    shape: tuple
    part: tuple
    ep: tuple = ()

    @property
    def axes(self) -> tuple:
        return tuple(a for e in self.part for a in e)


#: the routed experts' leaves of a MoE block (E leading)
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _check_supported(cfg) -> None:
    later = []
    if cfg.attention not in ("full", "mla"):
        later.append(f"{cfg.attention} attention")
    if cfg.block_pattern:
        later.append("the recurrent blocks")
    if cfg.is_encoder_decoder or cfg.frontend:
        later.append("the encoder-decoder and the vision stub")
    if later:
        raise NotImplementedError(
            f"{cfg.name} on a process mesh: {', '.join(later)} wait for a "
            f"later slice; the mesh runs the decoders with full attention "
            f"or MLA, dense or MoE")
    if cfg.n_experts and cfg.layout == "fsdp":
        raise NotImplementedError(
            f"{cfg.name}: MoE in the \"fsdp\" layout (the batch over "
            f"'model' too) is used by no config; expert parallelism runs "
            f"in the \"tp\" layout")


def _is_expert(path) -> bool:
    """Whether a leaf path is a routed expert's weight (not the router's,
    not a shared expert's)."""
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in EXPERT_LEAVES


class LMLayout:
    """`cfg`'s LM on `mesh` (a `DistMesh`)."""

    def __init__(self, cfg, mesh):
        from repro_torch.launch.steps import (model_param_specs,
                                              opt_state_specs)
        _check_supported(cfg)
        self.cfg, self.mesh = cfg, mesh
        self.tp_axes = (("model",) if cfg.layout == "tp" and mesh.model > 1
                        else ())
        self.tp = mesh.model if self.tp_axes else 1
        if cfg.n_heads % self.tp:
            raise ValueError(
                f"{cfg.name}: {cfg.n_heads} heads do not split over "
                f"'model' = {self.tp} (the reference pads the heads; the "
                f"port refuses)")
        self.batch_axes = mesh.live_axes(cfg.batch_axes)
        self.batch_div = mesh.group_size(self.batch_axes)
        #: the experts' axis: E split over 'data', tokens exchanged there
        self.ep_axes = mesh.live_axes("data") if cfg.n_experts else ()
        self.params = self._port(model_param_specs(cfg, mesh))
        self.opt = self._port(opt_state_specs(cfg, mesh))
        self._opt_at = dict(tree_items(self.opt))
        self._param_at = dict(tree_items(self.params))
        self._acfg: dict = {}

    # -- placements ------------------------------------------------------

    def _place(self, shape, pspec, expert: bool = False) -> Placement:
        entries = tuple(pspec) + (None,) * (len(shape) - len(pspec))
        part = tuple(self.mesh.live_axes(
            () if e is None else (e,) if isinstance(e, str) else e)
            for e in entries)
        for n, axes in zip(shape, part):
            if axes and n % self.mesh.group_size(axes):
                raise ValueError(f"{self.cfg.name}: dimension {n} of "
                                 f"{tuple(shape)} does not split over "
                                 f"{axes}")
        return Placement(tuple(shape), part, self.ep_axes if expert else ())

    def _port(self, stacked) -> dict:
        """The stacked specs' partitions on the port's tree (a dict a
        superblock under "blocks")."""
        from repro_torch.models import lm
        port = lm.param_specs(self.cfg)
        out = {}
        for key, sub in port.items():
            if key != "blocks":
                out[key] = tree_map_path(
                    lambda path, p, s: self._place(p.shape, s.pspec,
                                                   _is_expert(path)),
                    sub, stacked[key])
                continue

            def per(path, p, s):
                lead = s.pspec[0] if s.pspec else None
                if lead is not None:
                    raise NotImplementedError(
                        f"{self.cfg.name}: a partition of the stacked "
                        f"layer axis ({s.pspec})")
                return self._place(p.shape, tuple(s.pspec[1:]),
                                   _is_expert(path))

            out[key] = [tree_map_path(per, blk, stacked["blocks"])
                        for blk in sub]
        return out

    def local(self, t: torch.Tensor, pl: Placement) -> torch.Tensor:
        """This rank's shard of the global `t` (a copy of its own)."""
        for dim, axes in enumerate(pl.part):
            if axes:
                t = coll.chunk(t, self.mesh, axes, dim)
        return t.clone(memory_format=torch.contiguous_format)

    def full(self, t: torch.Tensor, pl: Placement) -> torch.Tensor:
        """The global tensor from this rank's shard `t` (no gradient)."""
        for dim, axes in enumerate(pl.part):
            if axes:
                t = coll.all_gather(t.contiguous(), self.mesh, axes, dim,
                                    "checkpoint")
        return t

    # -- the forward -------------------------------------------------------

    def gather(self, w: torch.Tensor, pl: Placement) -> torch.Tensor:
        """`w` gathered over the axes it is split on that are neither
        tensor- nor expert-parallel (FSDP / ZeRO-3): all-gather forward,
        ordered reduce-scatter of the gradient backward."""
        for dim, axes in enumerate(pl.part):
            g = tuple(a for a in axes
                      if a not in self.tp_axes and a not in pl.ep)
            if not g:
                continue
            if g != axes:
                raise NotImplementedError(f"dimension {dim} split over "
                                          f"{axes}: tensor-parallel and "
                                          f"gathered at once")
            w = coll.gather_weight(w, self.mesh, g, dim)
        return w

    def gather_tree(self, tree, places):
        return tree_map(self.gather, tree, places)

    def col_in(self, x, kind: str = "sum"):
        """A column-parallel input: identity forward, ordered sum over
        'model' backward."""
        return (coll.copy_in(x, self.mesh, self.tp_axes, kind)
                if self.tp > 1 else x)

    def row_out(self, y, kind: str = "sum"):
        """A row-parallel output: ordered sum over 'model' forward."""
        return (coll.sum_out(y, self.mesh, self.tp_axes, kind)
                if self.tp > 1 else y)

    def _local_cfg(self, heads: int, kv: int):
        key = (heads, kv)
        if key not in self._acfg:
            self._acfg[key] = dataclasses.replace(self.cfg, n_heads=heads,
                                                  n_kv_heads=kv)
        return self._acfg[key]

    def kv_heads(self) -> list:
        """The kv heads this rank computes, in order: its own split when
        'model' divides them, else those its q heads use (each once when
        its q heads are whole groups or one group's part, else one per q
        head)."""
        cfg, M = self.cfg, self.tp
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        Hl, m = H // M, self.mesh.group_index("model") if M > 1 else 0
        if Hkv % M == 0:
            return list(range(m * Hkv // M, (m + 1) * Hkv // M))
        G = H // Hkv
        used = [(m * Hl + j) // G for j in range(Hl)]
        if Hl % G == 0 or G % Hl == 0:
            return sorted(set(used))
        return used

    def attn_params(self, pa: dict):
        """(the attention's parameters as this rank runs them, the config
        of its local heads).  MLA: its own shards as they are (whole
        heads of `wq` / `wq_b` and `wkv_b`, rows of `wo`, the latent
        projections replicated) and n_heads / M heads."""
        cfg, M = self.cfg, self.tp
        if M == 1:
            return pa, cfg
        if cfg.attention == "mla":
            return pa, self._local_cfg(cfg.n_heads // M, cfg.n_heads // M)
        kv = self.kv_heads()
        if cfg.n_kv_heads % M == 0:
            return pa, self._local_cfg(cfg.n_heads // M, len(kv))
        hd = cfg.head_dim
        runs = []                      # contiguous runs of kv heads
        for h in kv:
            if runs and runs[-1][1] == h:
                runs[-1][1] = h + 1
            else:
                runs.append([h, h + 1])
        out = dict(pa)
        for name in ("wk", "wv"):
            w = coll.gather_weight(pa[name], self.mesh, self.tp_axes, 1,
                                   "kv_gather")
            parts = [w[:, a * hd:b * hd] for a, b in runs]
            out[name] = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        return out, self._local_cfg(cfg.n_heads // M, len(kv))

    def cache_cfg(self):
        """The config whose `lm.cache_shapes` are this rank's caches (its
        batch is the caller's; MLA's latent caches are whole on every
        model rank)."""
        if self.tp == 1:
            return self.cfg
        return self._local_cfg(self.cfg.n_heads // self.tp,
                               len(self.kv_heads()))

    def vocab_start(self, v_local: int) -> int:
        return (self.mesh.group_index("model") * v_local if self.tp > 1
                else 0)

    def loss(self, logits, labels):
        """This rank's part of the mean next-token cross-entropy: the sum
        of its tokens' losses over the global token count, in f32.  Under
        tensor parallelism the logits are vocab-parallel: the row max is
        the max over the shards, the sum of exp an ordered sum over
        'model', and the label's logit comes from the shard that owns
        it.  The ranks' parts add up to `lm.lm_loss` of the whole batch
        within rounding."""
        lf = logits.float()
        n = labels.numel() * self.batch_div
        lab = labels.long()
        if self.tp == 1:
            logz = torch.logsumexp(lf, dim=-1)
            ll = torch.gather(lf, -1, lab[..., None])[..., 0]
        else:
            V = lf.shape[-1]
            mx = coll.ordered_max(lf.detach().amax(dim=-1), self.mesh,
                                  self.tp_axes)
            se = torch.exp(lf - mx[..., None]).sum(dim=-1)
            logz = torch.log(coll.sum_out(se, self.mesh, self.tp_axes)) + mx
            loc = lab - self.vocab_start(V)
            own = (loc >= 0) & (loc < V)
            got = torch.gather(lf, -1, loc.clamp(0, V - 1)[..., None])[..., 0]
            ll = coll.sum_out(torch.where(own, got, torch.zeros_like(got)),
                              self.mesh, self.tp_axes)
        return (logz - ll).sum() / n

    def argmax(self, logits):
        """The greedy token of (B, V_local) logits, as `torch.argmax` over
        the whole vocab: the max over the shards, the lowest global
        index among ties."""
        idx = torch.argmax(logits, dim=-1)
        if self.tp == 1:
            return idx
        V = logits.shape[-1]
        val = torch.gather(logits, -1, idx[:, None])[:, 0]
        vals = torch.stack(coll.gather_list(val, self.mesh, self.tp_axes,
                                            "argmax"))
        idxs = torch.stack(coll.gather_list(idx + self.vocab_start(V),
                                            self.mesh, self.tp_axes,
                                            "argmax"))
        first = torch.argmax((vals == vals.amax(dim=0)).to(torch.int8),
                             dim=0)
        return torch.gather(idxs, 0, first[None])[0]

    def batch_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (dimension 0)."""
        return coll.chunk(t, self.mesh, self.batch_axes, 0) \
            if self.batch_axes else t

    def batch_gather(self, t: torch.Tensor) -> torch.Tensor:
        return coll.all_gather(t.contiguous(), self.mesh, self.batch_axes, 0,
                               "batch") if self.batch_axes else t

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """An ordered sum over the batch axes (a loss's parts)."""
        return coll.ordered_sum(t, self.mesh, self.batch_axes, "loss") \
            if self.batch_axes else t

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it."""
        coll.gather_list(torch.zeros(1, device=self.mesh.device), self.mesh,
                         None, "barrier")

    # -- the update --------------------------------------------------------

    def _zero(self, path):
        """(dimension, axes) the update splits a leaf's shard over beyond
        its parameter's own (ZeRO-1), or None; never for an expert leaf,
        which is split over 'data' already (`launch.steps.fsdp_spec`
        skips it too)."""
        pp, op = self._param_at[path], self._opt_at[path]
        if pp.ep:
            return None
        for dim, (a, b) in enumerate(zip(pp.part, op.part)):
            extra = tuple(x for x in b if x not in a)
            if extra:
                if tuple(x for x in b if x in a) != a:
                    raise NotImplementedError(f"{path}: update split {b} "
                                              f"around {a}")
                return dim, extra
        return None

    def update_views(self, params):
        """The parameters' shards the update writes (ZeRO-1: this rank's
        chunk over 'data' of its shard, a view), as a tree."""

        def view(path, p):
            z = self._zero(path)
            if z is None:
                return p
            dim, axes = z
            L = self.mesh.group_size(axes)
            n = p.shape[dim] // L
            return p.narrow(dim, self.mesh.group_index(axes) * n, n)

        return tree_map_path(view, params)

    def grad_sum_axes(self, path) -> list:
        """The batch axes a leaf's gradient is summed over: those its
        weight is neither gathered over (the gather's reduce-scatter
        sums those) nor expert-parallel on."""
        pl = self._param_at[path]
        kept = set(self.tp_axes) | set(pl.ep)
        gathered = {a for a in pl.axes if a not in kept}
        return [a for a in self.batch_axes
                if a not in gathered and a not in pl.ep]

    def sync_grads(self, grads, zero: bool = True):
        """Autograd's gradients (each rank's part) -> the gradient of the
        global loss on each update shard: reduce-scattered over the
        ZeRO-1 axes (`zero`; else on each parameter shard), then summed
        in rank order over the batch axes the weight is neither gathered
        over nor expert-parallel on (an expert's owner already holds the
        gradient of every data rank's tokens)."""

        def one(path, g):
            rest = self.grad_sum_axes(path)
            z = self._zero(path) if zero else None
            if z is not None:
                dim, axes = z
                g = coll.reduce_scatter(g.contiguous(), self.mesh, axes, dim,
                                        "zero_reduce_scatter")
                rest = [a for a in rest if a not in axes]
            if rest:
                g = coll.ordered_sum(g.contiguous(), self.mesh, tuple(rest),
                                     "grad_sum")
            return g

        return tree_map_path(one, grads)

    def zero_gather(self, params, views) -> None:
        """The updated ZeRO-1 chunks all-gathered into each rank's
        parameter shard, in place."""

        def one(path, p, v):
            z = self._zero(path)
            if z is not None:
                dim, axes = z
                p.copy_(coll.all_gather(v.contiguous(), self.mesh, axes, dim,
                                        "zero_gather"))
            return p

        tree_map_path(one, params, views)

    def sq_norm(self, paths, sqs) -> torch.Tensor:
        """The global sum of squares from each leaf's local one (in the
        reference's leaf order): each leaf's distinct shards summed in
        rank order, a shard replicated over an axis counted once, then
        the leaves in order.  The same bits on every rank."""
        local = torch.stack([s.float().reshape(()) for s in sqs])
        world = torch.stack(coll.gather_list(local, self.mesh, None,
                                             "grad_norm"))
        total = None
        for i, path in enumerate(paths):
            keep = self._opt_at[path].axes
            rep = [j for j, a in enumerate(("pod", "data", "model"))
                   if a not in keep]
            s = None
            for r in range(self.mesh.size):
                c = rank_coords(r, self.mesh.shape)
                if any(c[j] for j in rep):
                    continue
                s = world[r, i] if s is None else s + world[r, i]
            total = s if total is None else total + s
        return total

    def row_max(self, path, amax):
        """An int8 moment's row amax over the shards its last axis is
        split over (a max: the same bits on every shard)."""
        axes = self._opt_at[path].part[-1]
        return coll.ordered_max(amax.contiguous(), self.mesh, axes,
                                "row_max") if axes else amax

    # -- checkpoints -------------------------------------------------------

    def state_places(self, opt_state):
        """Placements of the AdamW state's leaves (an int8 moment's scale
        whole along its last axis)."""

        def mom(m, pl):
            if isinstance(m, adamw.QMoment):
                return adamw.QMoment(pl, Placement(
                    pl.shape[:-1] + (1,), pl.part[:-1] + ((),)))
            return pl

        return adamw.AdamWState(Placement((), ()),
                                _map_moments(mom, opt_state.mu, self.opt),
                                _map_moments(mom, opt_state.nu, self.opt))

    def _map_state(self, fn, params, opt_state):
        """fn(leaf, placement) over (params, opt_state)."""
        places = self.state_places(opt_state)
        return tree_map(fn, params, self.params), adamw.AdamWState(
            fn(opt_state.step, places.step),
            _map_pairs(fn, opt_state.mu, places.mu),
            _map_pairs(fn, opt_state.nu, places.nu))

    def state_full(self, params, opt_state):
        """(params, opt_state) of the whole model from this rank's shards
        (every rank gets them, a leaf at a time)."""
        return self._map_state(self.full, params, opt_state)

    def state_targets(self, params, opt_state):
        """Meta tensors of the global shapes and dtypes of (params,
        opt_state): what `checkpoint.restore_tree` reads into."""
        return self._map_state(lambda t, pl: torch.empty(
            pl.shape, dtype=t.dtype, device="meta"), params, opt_state)

    def state_local(self, params, opt_state, device):
        """This rank's shards of a whole (params, opt_state), on
        `device`."""
        return self._map_state(lambda t, pl: self.local(t, pl).to(device),
                               params, opt_state)


def _map_moments(fn, moments, places):
    """`fn(moment, placement)` over a moment tree whose leaves may be
    `QMoment`s (kept whole), paired with the placements' tree."""
    if isinstance(moments, adamw.QMoment) or not isinstance(
            moments, (dict, list)):
        return fn(moments, places)
    if isinstance(moments, dict):
        return {k: _map_moments(fn, v, places[k]) for k, v in moments.items()}
    return [_map_moments(fn, v, places[i]) for i, v in enumerate(moments)]


def _map_pairs(fn, moments, places):
    """`fn(tensor, placement)` over a moment tree and its placements,
    into a `QMoment`'s two leaves."""

    def one(m, pl):
        if isinstance(m, adamw.QMoment):
            return adamw.QMoment(fn(m.q, pl.q), fn(m.scale, pl.scale))
        return fn(m, pl)

    return _map_moments(one, moments, places)
