"""LM parameter initialisation, the train step and the prefill / decode
steps.

Mirrors the reference's `launch/steps.py` on one card: `make_opt_cfg`,
`loss_fn` and `make_train_step` (autograd's gradient, then
`optim.adamw.apply`), `make_prefill_step` and `make_decode_step`.  The
reference's FSDP and ZeRO spec transforms (`fsdp_spec`,
`model_param_specs(mesh=)`, `opt_state_specs`, `abstract_*`) have no
counterpart: they only matter on a mesh (ROADMAP).  Parameters are
drawn on their device from a seeded `torch.Generator` following each
`ParamSpec`; they are not JAX's draws.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import materialize, tree_leaves, tree_map
from repro_torch.optim import adamw


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """Random parameters of `cfg` on `device` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return materialize(lm.param_specs(cfg), gen, dev)


def _full_forward(params, batch, cfg, mode):
    """The modality stubs resolved: an audio config's `batch["frames"]`
    (B, enc_seq, d) through the encoder, a vision config's
    `batch["patches"]` (B, n_patches, d) ahead of the tokens."""
    enc_out = extra = None
    if cfg.frontend == "audio":
        enc_out = lm.encoder_fwd(params, batch["frames"], cfg)
    if cfg.frontend == "vision":
        extra = batch["patches"]
    return lm.forward(params, batch["tokens"], cfg, mode=mode,
                      enc_out=enc_out, extra_embeds=extra)


def make_opt_cfg(cfg) -> adamw.AdamWConfig:
    """AdamW's defaults with the config's moment dtype (`opt_dtype`)."""
    state_dtype = {"bf16": torch.bfloat16, "int8": "int8"}.get(
        cfg.opt_dtype, torch.float32)
    return adamw.AdamWConfig(state_dtype=state_dtype)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy of `batch` ({"tokens", "labels"}
    (B, S)[, "frames" | "patches"]); a vision config's logits are cut to
    the token positions that predict a label, `logits[:, P - 1:-1]`."""
    logits, _ = _full_forward(params, batch, cfg, "train")
    if cfg.frontend == "vision" and cfg.n_patches:
        logits = logits[:, cfg.n_patches - 1:-1]
    return lm.lm_loss(logits, batch["labels"])


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig | None = None):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}): the loss's gradient with respect to every parameter
    by autograd (on the card attention and RG-LRU run B5 and B6 forward
    and their backward kernels), then one AdamW step, which writes the
    parameters and moments IN PLACE and returns them (the reference's
    train loop donates both to its jitted step): a step holds one copy
    of the optimizer state."""
    opt_cfg = opt_cfg or make_opt_cfg(cfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        tracked = tree_map(lambda _p: next(it), params)
        loss = loss_fn(tracked, batch, cfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        # a leaf the loss never reads gets zeros, as jax.grad gives it
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(live, grads))
        grads = tree_map(lambda _p: next(it), params)
        params, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                                 opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg):
    """(params, {"tokens": (B, S)[, "frames" | "patches"]}) ->
    (last-position logits (B, 1, V), caches)."""
    def prefill_step(params, batch):
        logits, cache = _full_forward(params, batch, cfg, "prefill")
        return logits[:, -1:], cache

    return prefill_step


def make_decode_step(cfg):
    """(params, {"tokens": (B, 1), "cache", "pos": int}) -> (greedy next
    token (B,), caches).  The attention caches are written in place."""
    def decode_step(params, batch):
        logits, cache = lm.forward(params, batch["tokens"], cfg,
                                   mode="decode", cache=batch["cache"],
                                   pos=batch["pos"])
        return torch.argmax(logits[:, -1], dim=-1), cache

    return decode_step
