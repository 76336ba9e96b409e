"""ArchConfig: one dataclass describes every architecture.

A copy of the reference's `configs/base.py` with `dtype` a
`torch.dtype`, without its cost-counting switch `unroll_layers` (the
port counts a step on the `meta` device, `launch/counting.py`).  The
mesh fields (`fsdp`, `zero`, `shard_resid`, `layout`, and the
`batch_axes` and `zero_stage` they give) are kept: the dry run's spec
transforms (`launch/steps.py` `model_param_specs`, `opt_state_specs`)
and input specs (`launch/specs.py`) read them, while the one-card train
and serve paths do not.  Every one of the reference's ten
architectures is registered: GQA / local attention, MLA, MoE, RG-LRU
and xLSTM blocks, the encoder-decoder and the vision frontend's stub.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

#: the reference registry's architectures that are not ported yet, and
#: what each waits on: none
UNPORTED: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|hybrid|ssm|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    attention: str = "full"      # full | mla | local
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    use_rope: bool = True
    window: int = 2048           # local attention window

    # MLA
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_capacity: float = 1.25

    # hybrid / ssm
    block_pattern: Tuple[str, ...] = ()
    rglru_dim: int = 0

    # encoder-decoder
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1536

    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    n_patches: int = 576

    # misc
    act: str = "silu"
    norm: str = "rmsnorm"
    gated_mlp: bool = True
    learned_pos: bool = False
    max_seq: int = 8192
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True           # train: checkpoint each superblock
    fsdp: bool = False           # deprecated alias for zero="zero3"
    zero: str = ""               # "" | "zero1" | "zero3" (launch/steps)
    opt_dtype: str = "f32"       # AdamW moment dtype: f32 | bf16 | int8
    shard_resid: bool = False    # shard the residual's d over 'model'
    layout: str = "tp"           # "tp": TP over 'model', DP over the
                                 # rest; "fsdp": batch over every axis,
                                 # weights ZeRO-3-gathered per layer
    attn_chunk: int = 512        # KV chunk of the blocked attention

    @property
    def batch_axes(self) -> tuple:
        return ("pod", "data", "model") if self.layout == "fsdp" \
            else ("pod", "data")

    @property
    def zero_stage(self) -> str:
        if self.zero:
            return self.zero
        return "zero3" if self.fsdp else "none"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding / lm_head rows padded to 512, as the reference pads
        them (labels never hit the pad)."""
        return -(-self.vocab // 512) * 512

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head), from the port's
        own specs."""
        from repro_torch.models import lm
        from repro_torch.models.layers import tree_leaves
        return sum(math.prod(s.shape)
                   for s in tree_leaves(lm.param_specs(self)))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared), the
        reference's formula."""
        full = self.param_count()
        if not self.n_experts:
            return full
        expert_params = (self.n_layers - self.first_dense_layers) * \
            self.n_experts * 3 * self.d_model * self.moe_d_ff
        active_expert = expert_params * self.top_k / self.n_experts
        return int(full - expert_params + active_expert)


_REGISTRY: dict = {}


def register(cfg: ArchConfig, smoke_fn) -> None:
    _REGISTRY[cfg.name] = (cfg, smoke_fn)


def _lookup(name: str):
    _ensure_loaded()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet: {UNPORTED[name]}")
    raise KeyError(f"unknown architecture {name!r}; the port serves "
                   f"{list_archs()}")


def get_config(name: str) -> ArchConfig:
    return _lookup(name)[0]


def get_smoke(name: str) -> ArchConfig:
    return _lookup(name)[1]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from . import (deepseek_v2_lite, granite_20b,  # noqa: F401
                   internlm2_20b, kimi_k2, minicpm3_4b, phi3_vision,
                   recurrentgemma_2b, smollm_360m, whisper_base, xlstm_1_3b)
