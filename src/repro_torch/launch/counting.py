"""Counting a step's work as it is dispatched: the dry run's counter.

The reference counts a step from XLA's cost analysis of compiled HLO
(and corrects it for loop bodies counted once).  The port runs eagerly,
so `CountingMode`, a `TorchDispatchMode`, counts every aten op as it is
dispatched:

  * flops: the products, as `torch.utils.flop_counter` counts them (2
    per multiply-add of a matmul, bmm, addmm, convolution ...);
  * bytes accessed: every op's input and output bytes (views, aliases
    and bare allocations move nothing and are left out).  An eager
    program sends every op's operands through HBM, so this is its
    traffic, not an estimate of a fused program's;
  * the live bytes of the storages the step allocates: each new
    storage's bytes are added when an op creates it and subtracted when
    it is freed (`weakref.finalize` on the storage), and the peak is the
    step's temp size (its outputs made during the step among them).

A hand-written kernel counts by its own cost (`kernels/costs.py`):
while a wrapper decorated by `costs.counted` runs, the mode records the
wrapper's cost under `kernel.<name>.*` (attention's, forward and
backward, also under `attn_term.*`) and counts none of the ops inside,
so the CPU (plain versions), the card (kernels) and `meta` (shapes
only, `flash_attention`'s and `rglru`'s meta route) count one program
alike.

`count_step` counts one (config, shape) step on the `meta` device,
where nothing is allocated: parameters, optimizer state and inputs at
their full global sizes, any depth.  Two loops are identical at every
trip and too slow to trace at full length: xLSTM's sLSTM (a Python loop
a token) and its chunkwise mLSTM (a loop a chunk of `attn_chunk`
tokens).  An xLSTM train or prefill step is counted at two lengths, one
and two chunks, and extrapolated linearly in the chunks, which is exact
for every count since each chunk's ops are the same (the reference's
analytic `_ssm_scan_flops_correction` is not carried over; this
replaces it).  `method` names what was done.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import costs

aten = torch.ops.aten

#: ops that move no data: allocations without a write, and views that
#: the schema does not mark as aliasing
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten._unsafe_view.default,
               aten.lift_fresh.default, aten.detach.default,
               aten.alias.default}

#: kernels whose cost is also the attention term
_ATTN_KERNELS = ("flash_attention", "flash_attention_bwd")

#: the keys every count carries
COUNT_KEYS = ("flops", "bytes accessed")


def _tensors(x, out: list) -> list:
    """The tensors of nested args (lists, tuples, dicts), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for e in x:
            _tensors(e, out)
    elif isinstance(x, dict):
        for e in x.values():
            _tensors(e, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=None)
def _op_info(func) -> tuple:
    """(composite, moves data, makes new storages, its flop formula or
    None) of an aten overload.  A composite op (a CompositeImplicit
    kernel, reached here under `torch.inference_mode`, where no autograd
    key decomposes it first) is counted by the ops it decomposes into;
    a view, an op whose result aliases an input (in place, out=) or one
    of `_NO_TRAFFIC` makes no storage."""
    composite = torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    aliases = func.is_view or any(r.alias_info is not None
                                  for r in func._schema.returns)
    moves = not (func.is_view or func in _NO_TRAFFIC)
    return composite, moves, not (aliases or func in _NO_TRAFFIC), \
        flop_registry.get(func._overloadpacket)


class CountingMode(TorchDispatchMode):
    """Counts the aten ops dispatched inside it (see the module's
    docstring).  `result()` gives the counts; `ops` the number of ops
    dispatched, `kernel_ops` of those inside a kernel's wrapper."""

    def __init__(self):
        super().__init__()
        self.counts = collections.defaultdict(float)
        self.ops = 0
        self.kernel_ops = 0
        self.live = 0
        self.peak = 0
        self._in_kernel = 0
        self._born: dict[int, int] = {}
        self.repeat = 1          # the ops now dispatched stand for this many

    def __enter__(self):
        costs._COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            costs._COUNTERS.remove(self)

    @contextlib.contextmanager
    def kernel(self, name: str, cost_fn):
        """Record `cost_fn()` under `name` and count no op until the
        block ends (a kernel called inside another's wrapper counts with
        it)."""
        if self._in_kernel == 0:
            cost = cost_fn()
            for key in COUNT_KEYS:
                self.counts[key] += cost[key]
                self.counts[f"kernel.{name}.{key}"] += cost[key]
                if name in _ATTN_KERNELS:
                    self.counts[f"attn_term.{key}"] += cost[key]
            self.counts[f"kernel.{name}.calls"] += 1
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1

    def _free(self, key: int) -> None:
        self.live -= self._born.pop(key, 0)

    def _track(self, outs: list) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._born:
                continue
            self._born[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        if self.live > self.peak:
            self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        composite, moves, makes, flops = _op_info(func)
        if composite:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if makes:
            self._track(_tensors(out, []))
        self.ops += 1
        if self._in_kernel:
            self.kernel_ops += 1
            return out
        if moves:
            self.counts["bytes accessed"] += self.repeat * sum(
                map(_nbytes, _tensors(out, _tensors(kwargs, _tensors(args,
                                                                     [])))))
        if flops is not None:
            self.counts["flops"] += self.repeat * flops(*args, **kwargs,
                                                        out_val=out)
        return out

    def result(self) -> dict:
        out = {k: float(self.counts.get(k, 0.0)) for k in COUNT_KEYS}
        out.update({k: float(v) for k, v in sorted(self.counts.items())
                    if k not in out})
        out["temp peak bytes"] = float(self.peak)
        out["ops"] = float(self.ops)
        out["kernel ops"] = float(self.kernel_ops)
        return out


# ---------------------------------------------------------------------------
# One step of a (config, shape) cell, traced
# ---------------------------------------------------------------------------

def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def step_inputs(cfg, kind: str, batch: int, seq: int, device="meta"):
    """(params, opt_state or None, batch dict) of one step on `device`:
    the port's layout, parameters, inputs and caches zeros (no value
    changes what is dispatched; on `meta` nothing is allocated), the
    AdamW state as `adamw.init` makes it.  Tokens are int32, as the
    loader's; a decode step's cache is sized for `seq` positions and
    its one token sits at `seq - 1`."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    dev = torch.device(device)
    params = tree_map(lambda s: _zeros(s.shape, s.dtype, dev),
                      lm.param_specs(cfg))
    opt_state = None
    if kind == "train":
        opt_state = adamw.init(params, steps_lib.make_opt_cfg(cfg))
    B, S = batch, seq
    if kind == "decode":
        cache = tree_map(lambda s: _zeros(s.shape, s.dtype, dev),
                         lm.cache_shapes(cfg, B, S))
        return params, None, {"tokens": _zeros((B, 1), torch.int32, dev),
                              "cache": cache, "pos": S - 1}
    s_tok = S - cfg.n_patches if cfg.frontend == "vision" else S
    b = {"tokens": _zeros((B, s_tok), torch.int32, dev)}
    if kind == "train":
        b["labels"] = _zeros((B, s_tok), torch.int32, dev)
    if cfg.frontend == "vision":
        b["patches"] = _zeros((B, cfg.n_patches, cfg.d_model),
                              torch.float32, dev)
    if cfg.frontend == "audio":
        b["frames"] = _zeros((B, cfg.enc_seq, cfg.d_model), torch.float32,
                             dev)
    return params, opt_state, b


@contextlib.contextmanager
def adamw_chunk_shortcut(mode: CountingMode):
    """Inside: AdamW updates one chunk of each run of equal chunks of a
    leaf (`adamw._row_chunks`: whole rows, every chunk but a ragged last
    one the same size, so the same ops), and `mode` counts its ops once
    for each chunk of the run.  kimi-k2's 1.03 T parameters are ~15,000
    chunks, which would take minutes to trace one by one."""
    from repro_torch.optim import adamw
    whole = adamw._row_chunks

    def runs(p):
        chunks = whole(p)
        sizes = [len(range(*sl.indices(p.shape[0]))) if p.dim() else 1
                 for sl in chunks]
        i = 0
        while i < len(chunks):
            j = i
            while j < len(chunks) and sizes[j] == sizes[i]:
                j += 1
            mode.repeat = j - i
            yield chunks[i]
            i = j
        mode.repeat = 1

    adamw._row_chunks = runs
    try:
        yield
    finally:
        adamw._row_chunks = whole
        mode.repeat = 1


def run_step(cfg, kind: str, params, opt_state, batch):
    """One step of `kind` as the port runs it: the train step under
    autograd, prefill and decode under `torch.inference_mode` (as
    `launch.serve` serves)."""
    from repro_torch.launch import steps as steps_lib
    step = steps_lib.step_for(cfg, kind)
    if kind == "train":
        return step(params, opt_state, batch)
    with torch.inference_mode():
        return step(params, batch)


def trace_step(cfg, kind: str, batch: int, seq: int, device="meta", *,
               chunk_shortcut: bool = True) -> dict:
    """Count one step of `kind` at (batch, seq) on `device` (inputs made
    outside the count; `adamw_chunk_shortcut` unless told not to)."""
    params, opt_state, b = step_inputs(cfg, kind, batch, seq, device)
    mode = CountingMode()
    with mode, (adamw_chunk_shortcut(mode) if chunk_shortcut
                else contextlib.nullcontext()):
        out = run_step(cfg, kind, params, opt_state, b)
    del out
    return mode.result()


def _line(c1: dict, c2: dict, x: float) -> dict:
    """The count at x of a count linear in x, given it at 1 and 2."""
    return {k: c1[k] + (x - 1) * (c2[k] - c1[k]) for k in c1
            if isinstance(c1[k], float)}


def _quadratic(c: list, x: float) -> dict:
    """The count at x of a count quadratic in x, given it at 2, 3, 4
    (Lagrange's form)."""
    w = ((x - 3) * (x - 4) / 2, -(x - 2) * (x - 4), (x - 2) * (x - 3) / 2)
    return {k: sum(wi * ci[k] for wi, ci in zip(w, c)) for k in c[0]}


#: the chunk counts an xLSTM step is traced at: the first and the last
#: chunk differ from the others (the carry in, the state out), so the
#: counts are polynomial in the chunks from 2 on
XLSTM_CHUNKS = (2, 3, 4)


def count_step(cfg, kind: str, batch: int, seq: int,
               device="meta") -> dict:
    """The counts of one step of `kind` at (batch, seq), global (the
    whole batch on one device), with `method`.

    An xLSTM train or prefill step longer than `XLSTM_CHUNKS[-1]` chunks
    is traced at 2, 3 and 4 chunks of `attn_chunk` tokens, with one and
    two repeats of its block pattern, and extrapolated: linearly in the
    repeats (every repeat runs the same ops) and quadratically in the
    chunks (a train step's backward of each token's and chunk's slice
    writes a gradient the size of the whole sequence, so its bytes grow
    with the square of the length; its flops and a prefill's counts
    grow linearly).  Both are exact for flops and bytes; the temp peak
    follows the same polynomials at smoke size (`tests/
    test_torch_dryrun.py` holds all three to a direct trace)."""
    from repro_torch.models.lm import layer_layout
    chunk = cfg.attn_chunk or 256
    n = seq // chunk
    if not (cfg.family == "ssm" and kind in ("train", "prefill")
            and seq % chunk == 0 and n > XLSTM_CHUNKS[-1]):
        out = trace_step(cfg, kind, batch, seq, device)
        out["method"] = f"{device}-trace"
        return out
    head, pat, n_rep, tail = layer_layout(cfg)
    fixed = len(head) + len(tail)
    per_n = []
    for m in XLSTM_CHUNKS:
        if n_rep > 2:
            reps = [trace_step(dataclasses.replace(
                cfg, n_layers=fixed + r * len(pat)), kind, batch, m * chunk,
                device) for r in (1, 2)]
            per_n.append(_line(*reps, n_rep))
        else:
            per_n.append({k: v for k, v in trace_step(
                cfg, kind, batch, m * chunk, device).items()
                if isinstance(v, float)})
    out = _quadratic(per_n, n)
    out["method"] = (f"{device}-trace at {XLSTM_CHUNKS} chunks of {chunk} "
                     f"tokens" + (f" and 1, 2 of {n_rep} repeats" if n_rep > 2
                                  else "")
                     + f", extrapolated to {n} chunks")
    return out


def per_device(count: dict, chips: int) -> dict:
    """`count` (global) as one device's share of `chips`: its flops,
    bytes (kernel and attention terms among them) and temp peak divided
    by `chips`; op counts stay the global program's."""
    if chips == 1:
        return dict(count)
    keep = ("method", "ops", "kernel ops")
    out = {k: (v if k in keep or k.endswith(".calls") else v / chips)
           for k, v in count.items()}
    out["method"] = f"{count['method']}, global / {chips} chips"
    return out
