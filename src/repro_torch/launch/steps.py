"""LM parameter initialisation and the prefill / decode steps.

Mirrors the inference half of the reference's `launch/steps.py`: no
train step, optimizer or ZeRO/FSDP specs (the port runs on one card;
the train step is ROADMAP A16 step 4).  Parameters are drawn on their
device from a seeded `torch.Generator` following each `ParamSpec`; they
are not JAX's draws.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import materialize


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
