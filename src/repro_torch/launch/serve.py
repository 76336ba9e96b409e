"""Batched serving: LM decode, and GLM batch prediction.

LM path (prefill a prompt batch, then decode greedily):

    python -m repro_torch.launch.serve --arch smollm-360m [--smoke] \
        [--batch 4] [--prompt-len 32] [--gen 16] [--device cuda]

GLM path: `glm_predict_batch` predicts through a fitted
`repro_torch.api` estimator (the estimator is the serving unit), dense,
scipy sparse or padded-CSR input, on the estimator's device.  The
reference's `glm_predict_streamed` and `serve_glm` read the bucket-tile
cache, so they wait on ROADMAP A7 (and stay in A13).  Runs on the card
unless `device="cpu"`; there the kernels' plain versions run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.models.layers import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# GLM batch prediction
# ---------------------------------------------------------------------------


def glm_predict_batch(est, X, *, batch: int = 8192,
                      proba: bool = False) -> np.ndarray:
    """Predict in fixed-size batches through a fitted estimator.

    ``X`` is sklearn-layout dense ``(n, d)``, a scipy sparse matrix, or
    an engine padded-CSR ``(idx, val)`` pair.  Batching bounds the
    host-side copies a request makes at `batch` rows, whatever its
    size; each batch's rows go to the estimator's device.
    """
    pair = isinstance(X, (tuple, list))
    n = X[0].shape[0] if pair else X.shape[0]
    fn = est.predict_proba if proba else est.predict
    outs = []
    for s in range(0, n, batch):
        sl = ((X[0][s:s + batch], X[1][s:s + batch]) if pair
              else X[s:s + batch])
        outs.append(np.asarray(fn(sl)))
    return np.concatenate(outs) if outs else np.empty((0,))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def widen_cache(cache: dict, cfg, batch: int, max_seq: int) -> dict:
    """Prefill caches -> `lm.cache_shapes(cfg, batch, max_seq)`: each
    leaf zero-padded at the end of every axis and cast to the spec's
    dtype (real deployments allocate at max_seq)."""
    def widen(c, s):
        if tuple(c.shape) == s.shape:
            return c.to(s.dtype)
        out = torch.zeros(s.shape, dtype=s.dtype, device=c.device)
        out[tuple(slice(0, n) for n in c.shape)] = c
        return out

    return tree_map(widen, cache, lm.cache_shapes(cfg, batch, max_seq))


@torch.inference_mode()
def generate(params, tokens, cfg, gen: int, *, stats: dict | None = None):
    """Prefill `tokens` (B, P), widen the caches to P + gen, then take
    gen - 1 greedy decode steps.  Returns the (B, gen) generated ids; with
    `stats`, writes into it the prefill and decode seconds (the host
    clock around work that ends in a device synchronize) and the largest
    |logit| of the prefill (inf or NaN if any logit is not finite)."""
    dev = tokens.device
    B, P = tokens.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.forward(params, tokens, cfg, mode="prefill")
    cache = widen_cache(cache, cfg, B, P + gen)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    if stats is not None:       # NaN propagates through amax / amin
        stats["prefill_logits_absmax"] = float(torch.maximum(
            logits.amax().float().abs(), logits.amin().float().abs()))
    del logits

    decode = steps_lib.make_decode_step(cfg)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, cache = decode(params, {"tokens": tok, "cache": cache,
                                     "pos": P + i})
        tok = tok[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    if stats is not None:
        stats.update(prefill_s=t_prefill, decode_s=t_decode,
                     decode_tok_per_s=(gen - 1) * B / max(t_decode, 1e-9))
    return torch.cat(out, dim=1)


@torch.inference_mode()
def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device="cuda", verbose: bool = True,
          stats: dict | None = None):
    """Random weights of `cfg` (seeded), a random prompt batch
    (`np.random.default_rng(seed)`, as the reference draws it), prefill,
    then greedy decode.  Returns the (batch, gen) generated token ids.
    `stats`, when given, receives setup / prefill / decode seconds,
    decode tokens per second and the parameters' bytes."""
    dev = resolve_device(device)
    _sync(dev)
    t0 = time.perf_counter()
    params = steps_lib.init_params(cfg, seed, dev)
    _sync(dev)
    t_setup = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                             dtype=torch.int64, device=dev)
    st = {} if stats is None else stats
    ids = generate(params, tokens, cfg, gen, stats=st)
    st.update(setup_s=t_setup, param_bytes=sum(
        t.numel() * t.element_size() for t in tree_leaves(params)))
    if verbose:
        print(f"prefill {prompt_len} toks x{batch}: {st['prefill_s']:.2f}s; "
              f"decode {gen - 1} steps: {st['decode_s']:.2f}s "
              f"({st['decode_tok_per_s']:.1f} tok/s)")
    return ids


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    ids = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device)
    print("generated token ids:\n", ids.cpu().numpy())


if __name__ == "__main__":
    main()
