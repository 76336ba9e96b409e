"""Kernel contract registry: every CUDA entry point and its guard rails.

Each hand-written kernel registers its source under `csrc/`, the C
entry point the wrapper calls through ctypes, the extra `nvcc` flags its
build needs, the misfit predicate that decides whether the kernel can
take a shape, the shared-memory model that places its buffers, and the
TPU kernel of the reference package it replaces.  `kernels.build`
compiles exactly the sources listed here.  References are lazy
``"module:attr"`` strings so this module imports nothing.
"""
from __future__ import annotations

__all__ = ["KERNEL_CONTRACTS", "SMEM_OPTIN_BYTES", "NVCC_FLAGS"]

#: Dynamic shared memory one thread block may opt in to on an H100
#: (227 KB of the SM's 256 KB; above 48 KB only after
#: cudaFuncAttributeMaxDynamicSharedMemorySize).
SMEM_OPTIN_BYTES = 232_448

#: Flags every kernel source is built with (no fast math anywhere).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

KERNEL_CONTRACTS: dict[str, dict] = {
    # dense bucket kernel: a chain warp walks each (d, B) tile's Gram
    # recursion (the logistic bisection as a tree) while producer warps
    # stage the next tile and its Gram; placed by `smem_layout`
    "sdca_bucket.sdca_bucket_kernel": {
        "source": "csrc/sdca_bucket.cu",
        "entry": "sdca_bucket_launch",
        "nvcc_extra": (),
        "misfit": "repro_torch.kernels.ops:dense_kernel_misfit",
        "smem_estimate": "repro_torch.kernels.sdca_bucket:smem_layout",
        "replaces": "src/repro/kernels/sdca_bucket.py:102",
    },
    # dense tensor-parallel pair, one launch a bucket: bucket b's
    # recursion on the lanes' summed [m0 | G] (after the caller's
    # lane-ordered sum over 'model') with each lane's update of its rows
    # of v, and bucket b+1's partials; B1's recursion
    # (csrc/dense_recursion.cuh), built with the common flags as B1 is.
    # The lane's rows stream through shared-memory slots; placed by
    # `tp_step_smem_bytes`, which the launcher requires.
    "sdca_bucket.sdca_bucket_tp_step": {
        "source": "csrc/sdca_bucket_tp.cu",
        "entry": "sdca_bucket_tp_step_launch",
        "nvcc_extra": (),
        "misfit": "repro_torch.kernels.ops:dense_kernel_misfit",
        "smem_estimate": "repro_torch.kernels.sdca_bucket:tp_step_smem_bytes",
        "replaces": "src/repro/kernels/sdca_bucket.py:102",
    },
    # sparse replicated kernel: v replicas in global memory, two stages
    # of a bucket's links and working set in shared memory (in global
    # memory for a bucket too large for it); the chain's row of products
    # stays in shared memory, so a row past 58,112 nonzeros is a misfit
    # (`row_fits_smem`).  -fmad=false keeps every
    # multiply and add separate: the kernel is bitwise equal to the
    # plain scan, which has no fused operations.
    "sdca_sparse_bucket.sdca_sparse_bucket_kernel": {
        "source": "csrc/sdca_sparse_bucket.cu",
        "entry": "sdca_sparse_bucket_launch",
        "nvcc_extra": ("-fmad=false",),
        "misfit": "repro_torch.kernels.ops:sparse_kernel_misfit",
        "smem_estimate":
            "repro_torch.kernels.sdca_sparse_bucket:smem_bytes",
        "replaces": "src/repro/kernels/sdca_sparse_bucket.py:242",
    },
    # feature-sharded pair, one launch each per bucket: the gather of
    # each worker's exchanged working set from its lanes' slices (one
    # load per entry, no arithmetic, so no flags beyond the common
    # ones), then the recursion and owned scatter on it over every
    # (worker, lane) block.  The tiles, the working set and the scratch
    # live in global memory; the recursion places one row's operands in
    # dynamic shared memory (in a global scratch row for a row too wide
    # for it), and is built with -fmad=false as the replicated kernel
    # is (the pair is bitwise equal to the scan).  The gather uses no
    # shared memory (a static size of 0).
    "sdca_sparse_bucket.sdca_sparse_gather_bucket": {
        "source": "csrc/sdca_sparse_gather_bucket.cu",
        "entry": "sdca_sparse_gather_bucket_launch",
        "nvcc_extra": (),
        "misfit": "repro_torch.kernels.ops:sparse_kernel_misfit",
        "smem_estimate": None,
        "replaces": "src/repro/kernels/sdca_sparse_bucket.py:424",
    },
    "sdca_sparse_bucket.sdca_sparse_sharded_bucket": {
        "source": "csrc/sdca_sparse_sharded_bucket.cu",
        "entry": "sdca_sparse_sharded_bucket_launch",
        "nvcc_extra": ("-fmad=false",),
        "misfit": "repro_torch.kernels.ops:sparse_kernel_misfit",
        "smem_estimate":
            "repro_torch.kernels.sdca_sparse_bucket:sharded_smem_bytes",
        "replaces": "src/repro/kernels/sdca_sparse_bucket.py:453",
    },
    # LM serving, f32 inputs (and bf16 at widths no tensor-core
    # instantiation covers): online-softmax attention, one block per
    # (64-row q tile, batch x head), f32 math on the CUDA cores; its
    # Q/K/V/P tiles are placed in dynamic shared memory by `smem_bytes`.
    "flash_attention.flash_attention_kernel": {
        "source": "csrc/flash_attention.cu",
        "entry": "flash_attention_launch",
        "nvcc_extra": (),
        "misfit": None,
        "smem_estimate": "repro_torch.kernels.flash_attention:smem_bytes",
        "replaces": "src/repro/kernels/flash_attention.py:93",
    },
    # LM serving, bf16 inputs (every served config's widths): the same
    # function on the bf16 tensor cores, built at five padded (q/k, v)
    # width pairs, one block of two to four consumer warpgroups per (q
    # tile, batch x head) (`flash_attention.TC_HEAD_DIMS`); wgmma exists
    # only for sm_90a, which NVCC_FLAGS target.  Its Q tile and K/V ring
    # are placed by `smem_bytes_tc(hd, hd_v)`.
    "flash_attention.flash_attention_tc": {
        "source": "csrc/flash_attention_tc.cu",
        "entry": "flash_attention_tc_launch",
        "nvcc_extra": (),
        "misfit": None,
        "smem_estimate":
            "repro_torch.kernels.flash_attention:smem_bytes_tc",
        "replaces": "src/repro/kernels/flash_attention.py:93",
    },
    # LM training: B5's backward (dq with the rows' lse and D, then dk and
    # dv a kv tile and kv head a block, the group's heads in a fixed
    # order; f32 math on the CUDA cores, f32 or bf16 inputs); its Q, dO,
    # K, V and dS tiles are placed in dynamic shared memory by
    # `bwd_smem_bytes`, which the launcher requires.
    "flash_attention.flash_attention_bwd": {
        "source": "csrc/flash_attention_bwd.cu",
        "entry": "flash_attention_bwd_launch",
        "nvcc_extra": (),
        "misfit": None,
        "smem_estimate":
            "repro_torch.kernels.flash_attention:bwd_smem_bytes",
        "replaces": "src/repro/kernels/flash_attention.py:93",
    },
    # LM training, bf16 at the padded width pairs (64, 64) and (256, 256):
    # B5's backward on the bf16 tensor cores (wgmma, as the forward's
    # kernel, which gives it each row's lse): dq a q tile a block, then dk
    # and dv a kv tile a block in the transposed frame, the heads of a
    # GQA group split over blocks and summed in order where the kv tiles
    # alone are too few; no atomics.  Its fixed pair of tiles, the ring of
    # the other pair and their lse and D are placed by
    # `bwd_tc_smem_bytes`, which the launcher requires.
    "flash_attention.flash_attention_bwd_tc": {
        "source": "csrc/flash_attention_bwd_tc.cu",
        "entry": "flash_attention_bwd_tc_launch",
        "nvcc_extra": (),
        "misfit": None,
        "smem_estimate":
            "repro_torch.kernels.flash_attention:bwd_tc_smem_bytes",
        "replaces": "src/repro/kernels/flash_attention.py:93",
    },
    # LM training: B6's backward in four launches: the gates of every
    # step in parallel, the two chains (one warp of channels a block,
    # their operands staged by cp.async through a ring in dynamic shared
    # memory, placed by `bwd_smem_bytes`), the gradients in parallel, and
    # d a_log summed over t from the end on the same ring; -fmad=false
    # as the forward, so each operation rounds as the plain version's.
    "rglru.rglru_bwd": {
        "source": "csrc/rglru_bwd.cu",
        "entry": "rglru_bwd_launch",
        "nvcc_extra": ("-fmad=false",),
        "misfit": None,
        "smem_estimate": "repro_torch.kernels.rglru:bwd_smem_bytes",
        "replaces": "src/repro/kernels/rglru.py:67",
    },
    # RG-LRU recurrence, one thread per (batch row, channel); -fmad=false
    # keeps each multiply and add rounding as the plain version's
    # separate elementwise operations do.  Its a and b rings are static
    # shared memory (2 x kStages x kStageFloats floats, 32 KiB).
    "rglru.rglru_kernel": {
        "source": "csrc/rglru.cu",
        "entry": "rglru_launch",
        "nvcc_extra": ("-fmad=false",),
        "misfit": None,
        "smem_estimate": None,
        "replaces": "src/repro/kernels/rglru.py:67",
    },
}
