"""Deterministic 32-bit hashing shared by host oracle and device kernels.

The reference's RDSE builds its bucket->bits map imperatively with NuPIC's
portable RNG (SURVEY.md C1/C15). Here the map is a pure hash function so the
encoder is table-free and computable on-device with no host state. This numpy
copy feeds the synthetic generator (data/synthetic.py); the port's device
twin is ops/hashing.py, bit-identical to it.

The mixer is MurmurHash3's 32-bit finalizer (public domain), keyed by seed.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """MurmurHash3 fmix32 finalizer over uint32 arrays (vectorized)."""
    h = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= _C1
        h ^= h >> np.uint32(13)
        h *= _C2
        h ^= h >> np.uint32(16)
    return h


def hash_u32_np(key: np.ndarray, seed: int) -> np.ndarray:
    """hash(seed, key) -> uint32. key may be any integer array (cast mod 2^32)."""
    k = np.asarray(key).astype(np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        mixed = k * _GOLDEN + np.uint32(seed)
    return fmix32_np(mixed)


def hash_bits_np(keys: np.ndarray, seed: int, n: int) -> np.ndarray:
    """Map integer keys to bit indices in [0, n). Used by the RDSE."""
    return (hash_u32_np(keys, seed) % np.uint32(n)).astype(np.int32)
