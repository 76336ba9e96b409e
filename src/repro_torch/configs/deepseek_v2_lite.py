"""deepseek-v2-lite-16b [moe]: MLA + fine-grained MoE.  [arXiv:2405.04434]

27L d_model=2048 16H d_ff=10944 (the dense first layer) vocab=102400.
64 routed experts (ff 1408), top-6, and 2 shared.  MLA: qk_nope=128,
qk_rope=64, v_head=128, kv_lora=512, no q-LoRA.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400,
    attention="mla", kv_lora_rank=512, q_lora_rank=0,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1,
    zero="zero1", shard_resid=True,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256,
        attention="mla", kv_lora_rank=32, q_lora_rank=0,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=48,
        first_dense_layers=1, remat=False,
    )


register(CONFIG, smoke)
