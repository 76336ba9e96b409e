"""minicpm3-4b [dense]: dense transformer with MLA.  [hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H d_ff=6400 vocab=73448.  MLA: qk_nope=64,
qk_rope=32, v_head=64, kv_lora=256, q_lora=768.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448,
    attention="mla", kv_lora_rank=256, q_lora_rank=768,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    shard_resid=True,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256,
        attention="mla", kv_lora_rank=32, q_lora_rank=48,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, remat=False,
    )


register(CONFIG, smoke)
