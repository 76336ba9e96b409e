"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

sdca_bucket        — dense bucketed SDCA sub-epoch, every worker in one
                     launch (one thread block per worker).
sdca_sparse_bucket — the padded-CSR twin, bitwise equal to the plain
                     scan of `core.sdca`; and the feature-sharded pair
                     (`sdca_sparse_gather_bucket` over every worker,
                     `sdca_sparse_sharded_bucket` over every (worker,
                     model lane) block), one launch each per bucket.

Each kernel keeps its plain PyTorch version beside it and a launch
counter; `ops` pads, lays out, unscales and checks misfits; `build`
compiles `csrc/*.cu` with nvcc at first use.
"""
