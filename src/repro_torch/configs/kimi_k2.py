"""kimi-k2-1t-a32b [moe]: trillion-parameter MoE.  [arXiv:2501.kimi2]

61L d_model=7168 64H (GQA kv=8, head width 112) d_ff=2048 vocab=163840,
384 routed experts (ff 2048), top-8, 1 shared, the first layer dense:
61 x 384 x 3 x 7168 x 2048 ~= 1.03T expert parameters, ~32B active.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=1,
    rope_theta=5e4, zero="zero1", opt_dtype="int8", shard_resid=True,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=256,
        n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=96,
        first_dense_layers=1, remat=False,
    )


register(CONFIG, smoke)
