"""Numpy port of jax 0.9.0's threefry key operations.

Every schedule the engine draws (bucket-to-worker deals, re-deal
permutations, visit orders) comes from `jax.random` in the reference
package.  The port holds those schedules to the reference integer for
integer, so it reimplements the four key operations it uses, bit for
bit, on numpy uint32 arrays:

  * `PRNGKey(seed)`      -> key [seed >> 32, seed & 0xFFFFFFFF] of the
                            int32-truncated seed (jax's x32 default);
  * `fold_in(key, data)` -> threefry2x32(key, [0, uint32(data)]);
  * `split(key, num)`    -> the partitionable ("foldlike") split:
                            threefry2x32(key, hi=0, lo=arange(num));
  * `permutation(key, n)`-> ceil(3 ln n / ln(2^32 - 1)) rounds of a
                            stable sort of arange(n) keyed on 32 random
                            bits, each round on a fresh subkey.

`jax_threefry_partitionable=True` (the 0.9.0 default) is mirrored: the
random bits of an array of shape s are threefry2x32 over the 64-bit
iota of s split into (hi, lo) words, xor-ed together.

A key is a (2,) uint32 array; a stack of keys is (..., 2).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["PRNGKey", "fold_in", "split", "random_bits", "permutation",
           "threefry2x32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds), elementwise and broadcasting
    over the key words (k0, k1) and the counter words (x0, x1)."""
    k0 = np.asarray(k0, _U32)
    k1 = np.asarray(k1, _U32)
    x0, x1 = np.broadcast_arrays(np.asarray(x0, _U32),
                                 np.asarray(x1, _U32), k0)[:2]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r)
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0.astype(_U32), x1.astype(_U32)


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a Python int seed (x32 mode: the
    seed is truncated to int32, whose logical shift by 32 is 0)."""
    lo = np.int64(seed).astype(np.int32).view(np.uint32)
    return np.array([0, lo], _U32)


def fold_in(key, data) -> np.ndarray:
    """jax.random.fold_in over a key or a stack of keys (..., 2);
    `data` is an int (or int array broadcasting against the stack)."""
    key = np.asarray(key, _U32)
    data = np.asarray(data, np.int64).astype(np.int32).view(np.uint32)
    h0, h1 = threefry2x32(key[..., 0], key[..., 1], _U32(0), data)
    return np.stack([h0, h1], axis=-1)


def split(key, num: int) -> np.ndarray:
    """jax.random.split(key, num) -> (num, 2) (partitionable split)."""
    key = np.asarray(key, _U32)
    lo = np.arange(num, dtype=np.uint64)
    b0, b1 = threefry2x32(key[0], key[1], (lo >> np.uint64(32)).astype(_U32),
                          (lo & np.uint64(0xFFFFFFFF)).astype(_U32))
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of `shape` (partitionable layout)."""
    key = np.asarray(key, _U32)
    size = math.prod(shape)
    if size == 0:
        return np.zeros(shape, _U32)
    it = np.arange(size, dtype=np.uint64)
    b0, b1 = threefry2x32(key[0], key[1], (it >> np.uint64(32)).astype(_U32),
                          (it & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (b0 ^ b1).reshape(shape)


def permutation(key, n: int) -> np.ndarray:
    """jax.random.permutation(key, n) as int32 (the sort-based shuffle)."""
    x = np.arange(n, dtype=np.int32)
    uint32max = np.iinfo(np.uint32).max
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
    key = np.asarray(key, _U32)
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = np.argsort(random_bits(sub, (n,)), kind="stable")
        x = x[order]
    return x
