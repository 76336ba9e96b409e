"""Batched serving: LM decode, and GLM prediction.

LM path (prefill a prompt batch, then decode greedily):

    python -m repro_torch.launch.serve --arch smollm-360m [--smoke] \
        [--batch 4] [--prompt-len 32] [--gen 16] [--device cuda]

GLM path: the `repro_torch.api` estimator is the serving unit.
`glm_predict_batch` predicts in fixed-size batches (dense, scipy sparse
or padded-CSR input), `glm_predict_streamed` out of core off the
bucket-tile cache, and `serve_glm` is the one-command demo (registry
dataset -> tile cache -> load or fit an estimator -> streamed predict):

    python -m repro_torch.launch.serve --glm higgs [--glm-ckpt DIR] \
        [--glm-epochs 10] [--glm-batch 8192] [--glm-cache-dir DIR] \
        [--device cuda]

Runs on the card unless `device="cpu"`; there the kernels' plain
versions run.
"""
from __future__ import annotations

import argparse
import dataclasses
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


def glm_predict_streamed(est, cache, *, gbuckets: int = 512,
                         return_margins: bool = False,
                         verify_tiles: bool = False) -> np.ndarray:
    """Out-of-core inference: stream bucket tiles off the mmap'd cache,
    never holding more than `gbuckets` tiles in host memory, through
    the estimator's own margin path on its device.

    Returns predictions (or raw margins) for the TRUE examples — the
    cache's inert padding rows are trimmed via ``meta.n_examples``.
    With ``gbuckets * bucket`` = `estimators.PREDICT_ROWS` (8,192) each
    group is one prediction block, so the margins equal
    `glm_predict_batch`'s on the same rows elementwise.
    ``verify_tiles`` crc-checks each tile group against the cache's
    per-tile sidecar before serving from it (raising
    `data.cache.TileCorruptionError` rather than emitting predictions
    from corrupt bytes); default off.
    """
    est._check_fitted()
    m = cache.meta
    out = []
    for start in range(0, m.n_buckets, gbuckets):
        bids = np.arange(start, min(start + gbuckets, m.n_buckets))
        if verify_tiles:
            cache.verify_tiles(bids)
        data, _y = cache.gather_buckets(bids)
        # sklearn's row layout, as `predict` takes it
        rows = tuple(data) if m.kind == "sparse" else data.T
        out.append(est.decision_function(rows))
    mg = np.concatenate(out)[:m.n_examples]
    if return_margins or not getattr(est, "_classifier", False):
        return mg
    return np.asarray(est.classes_)[(mg > 0).astype(int)]


def serve_glm(dataset: str, *, ckpt=None, epochs: int = 10,
              batch: int = 8192, cache_dir=None, bucket: int = 8,
              device="cuda", verbose: bool = True):
    """Registry dataset -> (load or fit) estimator -> streamed predict.

    Materializes the bucket-tile cache, restores an `est.save`
    checkpoint of either package when given (else runs a quick fit on
    `device`), then serves the whole dataset out of core and reports
    throughput and training-set accuracy.  Returns (predictions,
    accuracy).
    """
    from repro_torch.api import LogisticRegression, load as load_estimator
    from repro_torch.api.session import _pad_multiple
    from repro_torch.data import registry

    if ckpt is not None:
        est = load_estimator(ckpt, device=device)
    else:
        est = LogisticRegression(max_epochs=epochs, bucket=bucket,
                                 lanes=4, partition="dynamic",
                                 device=device)
    # pad to the estimator's training topology so est.fit(cache) divides
    # for any raw-file n (the cache path cannot re-pad)
    cache = registry.materialize(
        dataset, cache_dir, bucket=est.bucket,
        pad_multiple=_pad_multiple(est.engine_config(), est.bucket))
    if ckpt is None:
        est.fit(cache)
    t0 = time.perf_counter()
    preds = glm_predict_streamed(est, cache,
                                 gbuckets=max(batch // bucket, 1))
    dt = time.perf_counter() - t0
    y = np.ascontiguousarray(
        cache.arrays["y"]).reshape(-1)[:cache.meta.n_examples]
    labels = np.asarray(est.classes_)[(y > 0).astype(int)]
    acc = float(np.mean(preds == labels))
    if verbose:
        print(f"glm-serve {dataset}: {preds.shape[0]} rows in {dt:.3f}s "
              f"({preds.shape[0] / max(dt, 1e-9):,.0f} rows/s), "
              f"train-acc {acc:.4f}")
    return preds, acc


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
def generate(params, tokens, cfg, gen: int, *, stats: dict | None = None,
             enc_out=None, mesh=None):
    """Prefill `tokens` (B, P), widen the caches to P + gen, then take
    gen - 1 greedy decode steps.  `enc_out`: an encoder-decoder's
    encoder output (`lm.encoder_fwd`).  Returns the (B, gen) generated
    ids; with `stats`, writes into it the prefill and decode seconds (the
    host clock around work that ends in a device synchronize) and the
    largest |logit| of the prefill (inf or NaN if any logit is not
    finite).  On a process mesh (`mesh`, every rank calling this) the
    parameters and `tokens` are this rank's shards and rows, the caches
    its own, and the ids its rows'; with `stats`, "prefill_logits" is
    this rank's slice of the prefill's last-position logits."""
    dev = tokens.device
    B, P = tokens.shape
    decode = steps_lib.make_decode_step(cfg, mesh=mesh)
    lay = None if mesh is None else steps_lib.layout_for(cfg, mesh)
    _sync(dev)
    t0 = time.perf_counter()
    if lay is None:
        logits, cache = lm.forward(params, tokens, cfg, mode="prefill",
                                   enc_out=enc_out)
        cache = widen_cache(cache, cfg, B, P + gen)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    else:
        logits, cache = steps_lib.make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": tokens})
        tok = lay.argmax(logits[:, -1])[:, None]
        cache = widen_cache(cache, lay.cache_cfg(), B, P + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    if stats is not None:       # NaN propagates through amax / amin
        stats["prefill_logits_absmax"] = float(torch.maximum(
            logits.amax().float().abs(), logits.amin().float().abs()))
        if lay is not None:
            stats["prefill_logits"] = logits[:, -1].float().cpu()
    del logits

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
          stats: dict | None = None, mesh=None):
    """Random weights of `cfg` (seeded), a random prompt batch
    (`np.random.default_rng(seed)`, as the reference draws it), prefill,
    then greedy decode.  An audio config's frames are drawn first from
    the same generator, (batch, enc_seq, d_model) standard normal, and
    encoded before the prefill's clock starts, as the reference does; a
    vision config is served on tokens only, as the reference's `serve`
    passes no patches.  Returns the (batch, gen) generated token ids.
    `stats`, when given, receives setup / encode (audio) / prefill /
    decode seconds, decode tokens per second and the parameters'
    bytes.

    With `mesh` (a `DistMesh`; every rank calls this) each rank holds
    its shards of the same weights and its rows of the same prompts, and
    serving runs tensor-parallel over 'model' whatever `cfg.layout` says
    (the reference's serving specs put the batch over (pod, data));
    every rank returns the whole (batch, gen) ids, and `stats` holds
    this rank's seconds and bytes (decode tok/s counts its rows)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and cfg.layout != "tp":
        cfg = dataclasses.replace(cfg, layout="tp")
    _sync(dev)
    t0 = time.perf_counter()
    params = steps_lib.init_params(cfg, seed, dev) if mesh is None else \
        steps_lib.init_params(cfg, seed, dev, mesh=mesh)
    _sync(dev)
    t_setup = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    st = {} if stats is None else stats
    enc_out = None
    if cfg.frontend == "audio":
        frames = torch.as_tensor(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), np.float32), device=dev)
        t0 = time.perf_counter()
        enc_out = lm.encoder_fwd(params, frames, cfg)
        _sync(dev)
        st["encode_s"] = time.perf_counter() - t0
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                             dtype=torch.int64, device=dev)
    if mesh is None:
        ids = generate(params, tokens, cfg, gen, stats=st, enc_out=enc_out)
    else:
        lay = steps_lib.layout_for(cfg, mesh)
        ids = lay.batch_gather(generate(params, lay.batch_slice(tokens), cfg,
                                        gen, stats=st, mesh=mesh))
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
    ap.add_argument("--glm", default=None, metavar="DATASET",
                    help="serve GLM predictions for a registry dataset "
                         "(streamed from the tile cache) instead of the "
                         "LM decode path")
    ap.add_argument("--glm-ckpt", default=None,
                    help="estimator checkpoint dir (from est.save); "
                         "without it a quick fit runs first")
    ap.add_argument("--glm-epochs", type=int, default=10)
    ap.add_argument("--glm-batch", type=int, default=8192)
    ap.add_argument("--glm-cache-dir", default=None)
    args = ap.parse_args()
    if args.glm:
        serve_glm(args.glm, ckpt=args.glm_ckpt, epochs=args.glm_epochs,
                  batch=args.glm_batch, cache_dir=args.glm_cache_dir,
                  device=args.device)
        return
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    ids = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device)
    print("generated token ids:\n", ids.cpu().numpy())


if __name__ == "__main__":
    main()
