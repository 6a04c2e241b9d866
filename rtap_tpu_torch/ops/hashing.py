"""MurmurHash3 fmix32 over 32-bit lanes, in int64 tensors.

Port of the JAX package's ``ops/hashing_tpu.py``: bit-identical uint32
arithmetic. torch has no uint32 shift or ``%``, so every value lives in
int64 masked to 32 bits. A product of two 32-bit values overflows int64, so
:func:`_mul32` splits the constant factor into 16-bit halves: no
intermediate passes 2^48.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) int64 and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)  # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16  # only the low 16 bits survive the shift
    return (lo + hi) & _MASK


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 fmix32 finalizer; `h` int64 in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_u32(key: torch.Tensor, seed) -> torch.Tensor:
    """hash(seed, key) -> int64 in [0, 2^32); `key` any integer tensor (taken
    mod 2^32 like the uint32 cast), `seed` an int or int64 tensor."""
    k = key.to(torch.int64) & _MASK
    return fmix32((_mul32(k, _GOLDEN) + seed) & _MASK)


def hash_bits(keys: torch.Tensor, seed, n: int) -> torch.Tensor:
    """Map integer keys to bit indices in [0, n) -> int64."""
    return hash_u32(keys, seed) % n
