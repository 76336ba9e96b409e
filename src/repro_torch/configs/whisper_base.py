"""whisper-base [audio]: encoder-decoder, conv frontend stubbed
(precomputed frame embeddings), 6 encoder + 6 decoder layers.
[arXiv:2212.04356]

6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.  Learned positions,
LayerNorm, GELU, a non-gated MLP, no RoPE.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865,
    is_encoder_decoder=True, n_enc_layers=6, enc_seq=1500,
    frontend="audio",
    norm="layernorm", act="gelu", gated_mlp=False,
    use_rope=False, learned_pos=True, max_seq=32768 + 8,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-base-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128,
        is_encoder_decoder=True, n_enc_layers=2, enc_seq=24,
        frontend="audio",
        norm="layernorm", act="gelu", gated_mlp=False,
        use_rope=False, learned_pos=True, max_seq=64, remat=False,
    )


register(CONFIG, smoke)
