"""internlm2-20b [dense]: GQA llama-arch.  [arXiv:2403.17297]

48L d_model=6144 48H (GQA kv=8, head width 128) d_ff=16384 vocab=92544.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544,
    rope_theta=1e6, zero="zero1", shard_resid=True,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab=256, remat=False,
    )


register(CONFIG, smoke)
