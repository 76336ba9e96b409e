"""smollm-360m [dense]: llama-arch small model.  [hf:HuggingFaceTB/SmolLM]

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_ff=256,
        vocab=256, remat=False,
    )


register(CONFIG, smoke)
