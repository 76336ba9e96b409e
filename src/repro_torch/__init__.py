"""PyTorch/CUDA port of the parallel GLM solver (bucketed SDCA).

A second package beside the JAX reference `repro`: the same layout
(`core/`, `kernels/`, `data/`, `api/`), plain functions on tensors, and
hand-written CUDA kernels for Hopper in place of the Pallas TPU
kernels.  It never imports `jax` or `repro`.
"""
