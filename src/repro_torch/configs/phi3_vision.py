"""phi-3-vision-4.2b [vlm]: the phi-3-mini backbone behind a CLIP
frontend stub.  [hf:microsoft/Phi-3-vision-128k-instruct]

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.  The vision tower
is a stub: the prefill step takes precomputed patch embeddings
(batch, n_patches, d_model), put ahead of the token embeddings.
"""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064,
    frontend="vision", n_patches=576,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256,
        frontend="vision", n_patches=16, remat=False,
    )


register(CONFIG, smoke)
