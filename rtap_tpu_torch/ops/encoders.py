"""Record encoder: RDSE, classic scalar or composite fields + date bits,
batched over a stream group.

Port of the JAX package's ``ops/encoders_tpu.py`` (``encode_device``'s
three families and ``bind_offsets``), with the vmapped stream axis written
out as a leading G axis. One record per stream is (values [G, F] f32, ts
[G] int); the output is a bool [G, input_size] SDR built by scatter.
NaN/inf field values contribute no bits: their indices point one past the
SDR and that column is dropped.

Arithmetic order matches the JAX package exactly: the bucket is an f32
divide by a per-stream tensor (never by a host scalar, which cuda turns
into a reciprocal multiply), round-half-even (``torch.round`` like
``jnp.round``), then the clip to +-RDSE_BUCKET_CLAMP, then the integer
cast. A record with fewer value columns than the config's fields reads its
last column for the others, as the reference's clamped gather does (a
serve source delivers one value per stream).
"""

from __future__ import annotations

import numpy as np
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


def _field_columns(values: torch.Tensor, F: int) -> torch.Tensor:
    """values [G, F_in] -> [G, F]: field f reads column min(f, F_in - 1),
    the reference's clamped gather."""
    if values.shape[1] == F:
        return values
    cols = torch.arange(F, device=values.device).clamp(max=values.shape[1] - 1)
    return values[:, cols]


def _composite_indices(cfg: ModelConfig, values: torch.Tensor, enc_offset: torch.Tensor,
                       enc_resolution: torch.Tensor, enc_prev: torch.Tensor | None
                       ) -> torch.Tensor:
    """Composite-family scatter indices [G, sum of active bits], field by
    field (rdse / delta / categorical, each with its own geometry); missing
    samples point at n_in (dropped)."""
    n_in = cfg.input_size
    dev = values.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    parts = []
    for f, (spec, (_name, _kind, off, _size)) in enumerate(
            zip(cfg.composite.fields, cfg.field_layout())):
        w = spec.active_bits
        vf = values[:, f]
        res = enc_resolution[:, f].to(torch.float32)
        finite = torch.isfinite(vf)
        v = torch.where(finite, vf, zero)
        ar = torch.arange(w, device=dev)
        if spec.kind == "delta":
            # first difference; a stream's first sample (predecessor NaN)
            # has none: the same drop as a NaN value
            pf = enc_prev[:, f] if enc_prev is not None else torch.full_like(vf, float("nan"))
            finite = finite & torch.isfinite(pf)
            p = torch.where(torch.isfinite(pf), pf, zero)
            bucket = torch.round((v - p) / res).clamp(-RDSE_BUCKET_CLAMP, RDSE_BUCKET_CLAMP)
            keys = bucket.to(torch.int64)[:, None] + ar
        elif spec.kind == "categorical":
            # rounded id, clamped in the f32 bucket domain, then to the
            # field's categorical bound so c * w + k stays inside int32
            b = torch.round(v / res).clamp(-RDSE_BUCKET_CLAMP, RDSE_BUCKET_CLAMP)
            cclamp = spec.categorical_clamp()
            cat = b.to(torch.int64).clamp(-cclamp, cclamp)
            keys = cat[:, None] * w + ar
        else:  # rdse
            bucket = torch.round((v - enc_offset[:, f]) / res)
            bucket = bucket.clamp(-RDSE_BUCKET_CLAMP, RDSE_BUCKET_CLAMP)
            keys = bucket.to(torch.int64)[:, None] + ar
        bits = hash_bits(keys, (spec.seed + 0x1000 * f) & 0xFFFFFFFF, spec.size)
        parts.append(torch.where(finite[:, None], bits + off, n_in))
    return torch.cat(parts, dim=1)


def _uniform_indices(cfg: ModelConfig, values: torch.Tensor, enc_offset: torch.Tensor,
                     enc_resolution: torch.Tensor) -> torch.Tensor:
    """RDSE or classic-scalar scatter indices [G, F * w] for the uniform
    family: every field has the same geometry, field f at offset f * R."""
    G, F = values.shape
    R = cfg.field_size
    dev = values.device
    finite = torch.isfinite(values)
    v = torch.where(finite, values, torch.zeros((), dtype=torch.float32, device=dev))
    if cfg.scalar is not None:
        # classic ScalarEncoder: clipped fixed-range bucket, contiguous run;
        # the scale is one f32 division, done once on the host (correctly
        # rounded, as the reference's constant-folded one)
        sc = cfg.scalar
        lo, hi = np.float32(sc.min_val), np.float32(sc.max_val)
        scale = np.float32(sc.size - sc.width) / (hi - lo)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        vc = torch.clamp(v, f32(lo), f32(hi))
        bucket = torch.round((vc - f32(lo)) * f32(scale)).to(torch.int64)
        bits = bucket[:, :, None] + torch.arange(sc.width, device=dev)
    else:
        w = cfg.rdse.active_bits
        bucket = torch.round((v - enc_offset) / enc_resolution.to(torch.float32))
        bucket = bucket.clamp(-RDSE_BUCKET_CLAMP, RDSE_BUCKET_CLAMP).to(torch.int64)
        keys = bucket[:, :, None] + torch.arange(w, device=dev)  # [G, F, w]
        # per-field hash stream: seed + 0x1000 * field (mod 2^32, like uint32)
        seeds = (cfg.rdse.seed + 0x1000 * torch.arange(F, device=dev)) & 0xFFFFFFFF
        bits = hash_bits(keys, seeds[None, :, None], R)
    idx = bits + (torch.arange(F, device=dev) * R)[None, :, None]
    idx = torch.where(finite[:, :, None], idx, cfg.input_size)  # missing field -> dropped
    return idx.reshape(G, -1)


def _date_indices(cfg: ModelConfig, ts_unix: torch.Tensor, base: int) -> list[torch.Tensor]:
    """The time-of-day ring and weekend bits from bit `base` on, [G, w]
    each; weekday bits off the weekend point at n_in (dropped)."""
    dev = ts_unix.device
    parts = []
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
        parts.append(torch.where(weekend[:, None], widx[None, :], cfg.input_size))
    return parts


def encode(cfg: ModelConfig, values: torch.Tensor, ts_unix: torch.Tensor,
           enc_offset: torch.Tensor, enc_resolution: torch.Tensor,
           enc_prev: torch.Tensor | None = None) -> torch.Tensor:
    """Encode one record per stream -> bool [G, input_size].

    `values` is [G, F_in] f32 (F_in = n_fields, or 1: see the module
    docstring), `enc_offset`, `enc_resolution` (and `enc_prev`, the delta
    fields' predecessor) [G, n_fields] f32 and `ts_unix` [G] integer.
    Layout: [field0 | field1 | ... | time-of-day ring | weekend], as
    ``cfg.field_layout()`` gives it."""
    G = values.shape[0]
    n_in = cfg.input_size
    values = _field_columns(values, cfg.n_fields)
    if cfg.composite is not None:
        idx = _composite_indices(cfg, values, enc_offset, enc_resolution, enc_prev)
        base = cfg.composite.size
    else:
        idx = _uniform_indices(cfg, values, enc_offset, enc_resolution)
        base = cfg.n_fields * cfg.field_size
    parts = [idx, *_date_indices(cfg, ts_unix, base)]
    sdr = torch.zeros((G, n_in + 1), dtype=torch.bool, device=values.device)
    sdr.scatter_(1, torch.cat(parts, dim=1), True)
    return sdr[:, :n_in]
