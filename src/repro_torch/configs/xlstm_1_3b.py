"""xlstm-1.3b [ssm]: alternating mLSTM / sLSTM blocks.  [arXiv:2405.04517]

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0: no separate
MLP (the xLSTM block's projections are the FFN).
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    use_rope=False,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
        vocab=256,
        block_pattern=("mlstm", "slstm"),
        use_rope=False, remat=False,
    )


register(CONFIG, smoke)
