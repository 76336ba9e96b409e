"""Bucket-to-worker partitioning schedules (integer-exact vs the reference).

Schemes:
  * static      — bucket b is owned by lane (b * K) // nb forever.
  * dynamic     — a fresh permutation of bucket ids every epoch; lane k
                  takes the k-th slice (the paper's contribution).
  * hierarchical— static split across pods x dynamic within each pod
                  (the paper's NUMA scheme).
  * rotation    — lane k takes the block of lane (k + epoch) % K,
                  shuffled locally (convergence-equivalent to static).
  * alltoall    — every epoch each lane shuffles its buckets, splits
                  them K ways and exchanges them in one balanced
                  all-to-all (`redeal_frac` of them).

Schedules are pure functions of (seed, epoch), drawn from the numpy
threefry port `core.prng`, so they equal `repro.core.partition`'s
schedules integer for integer.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from . import prng

Mode = Literal["static", "dynamic", "hierarchical", "rotation",
               "alltoall"]


def _permute_each(keys: np.ndarray, n: int) -> np.ndarray:
    """permutation(k, n) for every key of a (..., 2) stack."""
    flat = keys.reshape(-1, 2)
    perms = np.stack([prng.permutation(k, n) for k in flat])
    return perms.reshape(keys.shape[:-1] + (n,))


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    n_buckets: int          # global bucket count (divisible by pods*lanes)
    pods: int               # outer (static) axis, paper's NUMA nodes
    lanes: int              # inner (dynamic) axis, paper's threads
    mode: Mode = "hierarchical"
    seed: int = 0
    # alltoall only: fraction of each lane's buckets exchanged per epoch
    redeal_frac: float = 1.0

    def __post_init__(self):
        if self.n_buckets % (self.pods * self.lanes):
            raise ValueError(
                f"n_buckets={self.n_buckets} must divide by pods*lanes="
                f"{self.pods * self.lanes}")

    @property
    def per_lane(self) -> int:
        return self.n_buckets // (self.pods * self.lanes)

    def schedule(self, epoch: int) -> np.ndarray:
        """Bucket ids per worker for one epoch: (pods, lanes, per_lane) int32."""
        nb, P, K = self.n_buckets, self.pods, self.lanes
        epoch = int(epoch)
        per_pod = nb // P
        base = np.arange(nb, dtype=np.int32).reshape(P, per_pod)
        if self.mode == "static":
            return base.reshape(P, K, self.per_lane)
        key = prng.fold_in(prng.PRNGKey(self.seed), epoch)
        if self.mode == "dynamic":
            # one global shuffle: buckets may migrate across pods too
            return prng.permutation(key, nb).reshape(P, K, self.per_lane)
        if self.mode == "rotation":
            blocks = np.roll(base.reshape(P, K, self.per_lane),
                             -(epoch % K), axis=1)
            perms = _permute_each(prng.split(key, P * K).reshape(P, K, 2),
                                  self.per_lane)
            return np.take_along_axis(blocks, perms, axis=2)
        if self.mode == "alltoall":
            # iterate the (local shuffle -> balanced transpose) re-deal
            # `epoch+1` times; a pure function of (seed, epoch)
            if self.per_lane % K:
                raise ValueError(f"alltoall needs per_lane % lanes == 0,"
                                 f" got {self.per_lane} % {K}")
            blocks = base.reshape(P, K, self.per_lane)
            exch = int(self.per_lane * self.redeal_frac) // K * K
            exch = max(exch, K) if self.redeal_frac > 0 else 0
            for r in range(epoch + 1):
                rk = prng.fold_in(prng.PRNGKey(self.seed), r)
                perms = _permute_each(
                    prng.split(rk, P * K).reshape(P, K, 2), self.per_lane)
                sh = np.take_along_axis(blocks, perms, axis=2)
                if exch == 0:
                    blocks = sh
                    continue
                # exchange the first `exch` buckets of each lane: split
                # K ways, transpose across lanes (= all_to_all)
                head = sh[:, :, :exch].reshape(P, K, K, exch // K)
                head = head.swapaxes(1, 2).reshape(P, K, exch)
                blocks = np.concatenate([head, sh[:, :, exch:]], axis=2)
            return blocks
        # hierarchical: shuffle independently inside each pod's static range
        perms = _permute_each(prng.split(key, P), per_pod)
        ids = np.take_along_axis(base, perms, axis=1)
        return ids.reshape(P, K, self.per_lane)
