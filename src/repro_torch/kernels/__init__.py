"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

sdca_bucket        — dense bucketed SDCA sub-epoch, every worker in one
                     launch (one thread block per worker).
sdca_sparse_bucket — the padded-CSR twin, bitwise equal to the plain
                     scan of `core.sdca`.

Each kernel module keeps its plain PyTorch version beside the kernel
and a `launches` counter; `ops` pads, unscales and checks misfits;
`build` compiles `csrc/*.cu` with nvcc at first use.
"""
