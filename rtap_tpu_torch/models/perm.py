"""Permanence arithmetic domains: f32 reference semantics or fixed-point.

A copy of the JAX package's ``models/perm.py`` (the port imports nothing of
that package). Permanence tensors dominate per-stream device memory (the
cluster preset's TM `syn_perm` + SP `perm` are ~76% of state bytes), so the
storage dtype is the highest-leverage memory lever. `perm_bits` on
SPConfig/TMConfig selects the domain:

- ``0``  — f32 permanences in [0, 1], the NuPIC-faithful reference semantics.
- ``16`` — uint16 fixed-point quanta on the grid 1/(2^16 - 1). Every
  configured rate/threshold is converted once at trace/init time
  (``round(v * 65535)``, floored at 1 quantum so a configured-nonzero rate
  can never silently become a no-op); all updates are exact integer
  arithmetic. The deviation from f32 semantics is only the one-time rounding
  of the configured constants (worst case 1/131070 relative on a rate).
- ``8``  — uint8 quanta on 1/255, for maximum stream density. Coarse: e.g.
  a predicted_segment_decrement of 0.001 becomes 1/255 ≈ 0.0039 (4x). The
  quality impact is measured, not assumed — the JAX package's fault eval
  compares domains.

Parity stays bit-for-bit in every domain: integer arithmetic and
integer-valued f32 arithmetic (quanta are < 2^24, exactly representable)
agree exactly. The port's plain code widens to int32/f32 and stores back
in the storage dtype; the CUDA kernel reads and writes the storage dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rtap_tpu_torch.config import SPConfig, TMConfig


@dataclass(frozen=True)
class PermDomain:
    """Resolved constants for one permanence tensor family.

    ``one`` is the clip ceiling (1.0 or 2^bits - 1); rates/thresholds are
    pre-converted to the domain so oracle and kernel share one expression
    shape. Types: f32 domain -> np.float32 scalars; quantized -> python ints
    (numpy weak promotion keeps int32 compute exact).
    """

    bits: int  # 0 = f32

    @property
    def scale(self) -> int:
        return (1 << self.bits) - 1

    @property
    def dtype(self):
        """Storage dtype of the permanence tensors."""
        return {0: np.float32, 8: np.uint8, 16: np.uint16}[self.bits]

    @property
    def compute_dtype(self):
        """Intermediate dtype for update arithmetic: f32, or int32 so a
        quantized add can never wrap before the clip. (The device TM kernel
        instead computes on integer-VALUED f32 — quanta < 2^24 are exact —
        which agrees bit-for-bit with int32.)"""
        return np.float32 if self.bits == 0 else np.int32

    @property
    def one(self):
        return np.float32(1.0) if self.bits == 0 else self.scale

    @property
    def zero(self):
        return np.float32(0.0) if self.bits == 0 else 0

    def threshold(self, v: float):
        """Comparison constant (connected permanence): plain round."""
        return np.float32(v) if self.bits == 0 else int(round(v * self.scale))

    def rate(self, v: float):
        """Additive constant (inc/dec/bump/initial): rounds, but a nonzero
        configured rate is floored at 1 quantum — quantization must never
        turn a learning rule off."""
        if self.bits == 0:
            return np.float32(v)
        return max(1, int(round(v * self.scale))) if v > 0.0 else 0

    def quantize_init(self, perm_f32: np.ndarray) -> np.ndarray:
        """Quantize a freshly-initialized f32 permanence array to storage."""
        if self.bits == 0:
            return perm_f32.astype(np.float32)
        return np.round(perm_f32 * self.scale).astype(self.dtype)


def sp_domain(cfg: SPConfig) -> PermDomain:
    return PermDomain(cfg.perm_bits)


def tm_domain(cfg: TMConfig) -> PermDomain:
    return PermDomain(cfg.perm_bits)
