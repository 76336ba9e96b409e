"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427 (Griffin)]

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.  Pattern
("rec","rec","attn") x 8 + 2 trailing rec layers (26 = 3*8+2).  Local
attention window 2048; RG-LRU width = d_model.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000,
    attention="local", window=2048,
    block_pattern=("rec", "rec", "attn"), rglru_dim=2560,
    act="gelu",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab=256,
        attention="local", window=16,
        block_pattern=("rec", "rec", "attn"), rglru_dim=64,
        act="gelu", remat=False,
    )


register(CONFIG, smoke)
