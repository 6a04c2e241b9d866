"""Record encoder: uniform RDSE + date bits, batched over a stream group.

Port of the JAX package's ``ops/encoders_tpu.py`` (``encode_device``'s
uniform RDSE branch and ``bind_offsets``), with the vmapped stream axis
written out as a leading G axis. One record per stream is (values [G, F]
f32, ts [G] int); the output is a bool [G, input_size] SDR built by scatter.
NaN/inf field values contribute no bits: their indices point one past the
SDR and that column is dropped.

Arithmetic order matches the JAX package exactly: the bucket is an f32
divide, round-half-even (``torch.round`` like ``jnp.round``), then the clip
to +-RDSE_BUCKET_CLAMP, then the integer cast.
"""

from __future__ import annotations

import torch

from rtap_tpu_torch.config import RDSE_BUCKET_CLAMP, ModelConfig
from rtap_tpu_torch.ops.hashing import hash_bits

SECONDS_PER_DAY = 86400
_EPOCH_WEEKDAY_SHIFT = 3  # 1970-01-01 was a Thursday; weekday = (days+3) % 7


def bind_offsets(values: torch.Tensor, enc_offset: torch.Tensor,
                 enc_bound: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bind each field's RDSE offset at its first finite value (a leading NaN
    must not poison the stream) -> (new_offset, new_bound). Any shape."""
    bind = ~enc_bound & torch.isfinite(values)
    return torch.where(bind, values, enc_offset), enc_bound | bind


def encode(cfg: ModelConfig, values: torch.Tensor, ts_unix: torch.Tensor,
           enc_offset: torch.Tensor, enc_resolution: torch.Tensor) -> torch.Tensor:
    """Encode one record per stream -> bool [G, input_size].

    `values`, `enc_offset`, `enc_resolution` are [G, F] f32 and `ts_unix` is
    [G] integer. Layout: [field0 | field1 | ... | time-of-day ring |
    weekend], as ``cfg.field_layout()`` gives it."""
    if cfg.composite is not None:
        raise NotImplementedError(
            "composite encoders are not ported yet (ROADMAP.md, port queue A: "
            "composite/scalar/categorical encoders)")
    if cfg.scalar is not None:
        raise NotImplementedError(
            "the classic scalar encoder is not ported yet (ROADMAP.md, port "
            "queue A: composite/scalar/categorical encoders)")
    G, F = values.shape
    R = cfg.field_size
    n_in = cfg.input_size
    dev = values.device
    finite = torch.isfinite(values)
    v = torch.where(finite, values, torch.zeros((), dtype=torch.float32, device=dev))

    w = cfg.rdse.active_bits
    bucket = torch.round((v - enc_offset) / enc_resolution.to(torch.float32))
    bucket = bucket.clamp(-RDSE_BUCKET_CLAMP, RDSE_BUCKET_CLAMP).to(torch.int64)
    keys = bucket[:, :, None] + torch.arange(w, device=dev)  # [G, F, w]
    # per-field hash stream: seed + 0x1000 * field (mod 2^32, like uint32)
    seeds = (cfg.rdse.seed + 0x1000 * torch.arange(F, device=dev)) & 0xFFFFFFFF
    bits = hash_bits(keys, seeds[None, :, None], R)
    idx = bits + (torch.arange(F, device=dev) * R)[None, :, None]
    idx = torch.where(finite[:, :, None], idx, n_in)  # missing field -> dropped
    idx = idx.reshape(G, -1)

    parts = [idx]
    base = F * R
    ts = ts_unix.to(torch.int64)
    if cfg.date.time_of_day_width:
        # integer floor((s/86400) * ring_size), Python floor/mod semantics
        center = torch.div(torch.remainder(ts, SECONDS_PER_DAY) * cfg.date.time_of_day_size,
                           SECONDS_PER_DAY, rounding_mode="floor")
        tod = torch.remainder(
            center[:, None]
            + torch.arange(cfg.date.time_of_day_width, device=dev)
            - cfg.date.time_of_day_width // 2,
            cfg.date.time_of_day_size)
        parts.append(base + tod)
        base += cfg.date.time_of_day_size
    if cfg.date.weekend_width:
        days = torch.div(ts, SECONDS_PER_DAY, rounding_mode="floor")
        weekend = torch.remainder(days + _EPOCH_WEEKDAY_SHIFT, 7) >= 5
        widx = base + torch.arange(cfg.date.weekend_width, device=dev)
        parts.append(torch.where(weekend[:, None], widx[None, :], n_in))

    sdr = torch.zeros((G, n_in + 1), dtype=torch.bool, device=dev)
    sdr.scatter_(1, torch.cat(parts, dim=1), True)
    return sdr[:, :n_in]
