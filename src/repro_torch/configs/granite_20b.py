"""granite-20b [dense]: code model, MQA (kv=1).  [arXiv:2405.04324]

52L d_model=6144 48H (kv=1, head width 128) d_ff=24576 vocab=49152,
llama-arch: RoPE, RMSNorm and a gated SiLU MLP.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152,
    zero="zero1", layout="fsdp",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-20b-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=1, d_ff=384,
        vocab=256, remat=False,
    )


register(CONFIG, smoke)
