"""Bucketing: the paper's cache-line locality optimization, for Hopper.

On CPU the paper groups consecutive training examples into buckets sized
by the cache line (8-16 examples) so that the model vector alpha is
accessed with cache-line locality and the per-epoch shuffle permutes
n/B bucket ids instead of n example ids.  On Hopper the dense bucket
kernel stages one (d_pad x B) tile in a block's shared memory and uses
it three times (margins, Gram, v update); the bucket recursion is
EXACTLY sequential SDCA over the bucket's coordinates.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.contracts import SMEM_OPTIN_BYTES

# The paper disables bucketing when the model vector (n entries) fits the
# last-level cache (~500k entries).  Same cut-off, same spirit.
LLC_ENTRIES = 500_000
# Bytes one bucket tile may claim: the shared memory a block can opt in
# to on an H100 (the dense kernel keeps its tile there when it fits).
TILE_BUDGET_BYTES = SMEM_OPTIN_BYTES


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    n: int                  # number of examples (padded)
    bucket: int             # examples per bucket (1 = bucketing off)
    n_buckets: int

    @property
    def enabled(self) -> bool:
        return self.bucket > 1


def choose_bucket_size(n: int, d: int, *, dtype_bytes: int = 4,
                       force: int | None = None,
                       llc_entries: int = LLC_ENTRIES) -> int:
    """Run-time bucket-size heuristic (paper S3, adapted to shared memory).

    force=B overrides; force=1 disables.  Otherwise: disabled when alpha
    fits the 'LLC' threshold, else the largest B in {8, 16, 32, 64} whose
    (d x B) tile fits the tile budget.
    """
    if force is not None:
        return max(1, force)
    if n <= llc_entries:
        return 1
    for b in (64, 32, 16, 8):
        if d * b * dtype_bytes <= TILE_BUDGET_BYTES:
            return b
    return 8


def make_plan(n: int, d: int, **kw) -> BucketPlan:
    b = choose_bucket_size(n, d, **kw)
    if n % b:
        raise ValueError(f"n={n} not divisible by bucket={b}; pad the data")
    return BucketPlan(n=n, bucket=b, n_buckets=n // b)
