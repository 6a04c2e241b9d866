"""Fused per-record step for a stream group: encode -> SP -> TM -> raw score.

Port of the JAX package's ``ops/step.py``. ``vmap`` over the group becomes
the leading G axis of every tensor, and ``lax.scan`` over T ticks becomes
the Python loop of :func:`chunk_step` (PyTorch runs eagerly; on the card
each tick enqueues its kernels without waiting on the device).

The learning cadence of the JAX package's ``_tick`` (a ``lax.cond`` on the
group's lockstep ``tm_iter``) becomes a host-side branch on the group's own
tick counter: the caller passes ``tick0`` (the tm_iter of stream 0 at the
start of the chunk, which advances by one per tick), so no tick reads the
device. Without it, :func:`chunk_step` reads it once per chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.ops.encoders import bind_offsets, encode
from rtap_tpu_torch.ops.sp import sp_step
from rtap_tpu_torch.ops.tm import tm_step


def step_stages(cfg: ModelConfig, learn: bool):
    """The fused step as its named stages, in order: each maps (state, x)
    -> (state, x'), from x = (values [G, n_fields] f32, ts_unix [G]) through
    the SDR and the active columns to the raw score f32 [G].
    :func:`_step_impl` runs them all; measurement scripts time or stop at
    one of them."""

    def bind_encode(state, x):
        values, ts_unix = x
        enc_offset, enc_bound = bind_offsets(values, state["enc_offset"], state["enc_bound"])
        state = {**state, "enc_offset": enc_offset, "enc_bound": enc_bound}
        return state, encode(cfg, values, ts_unix, enc_offset, state["enc_resolution"])

    def sp(state, sdr):
        return sp_step(state, sdr, cfg.sp, learn)

    def tm(state, active):
        return tm_step(state, active, cfg.tm, learn)

    return (("bind_encode", bind_encode), ("sp", sp), ("tm", tm))


def _step_impl(state: dict, values: torch.Tensor, ts_unix: torch.Tensor,
               cfg: ModelConfig, learn: bool):
    """One fused record step for G streams -> (new_state, raw f32 [G]).
    `values` is [G, n_fields] f32 (NaN = missing sample), `ts_unix` [G]."""
    x = (values, ts_unix)
    for _, stage in step_stages(cfg, learn):
        state, x = stage(state, x)
    return state, x


def _tick(state: dict, values: torch.Tensor, ts_unix: torch.Tensor, cfg: ModelConfig,
          learn: bool, tick: int | None):
    """One group tick honoring cfg's learning cadence; `tick` is stream 0's
    tm_iter before the tick (completed steps, lockstep across the group)."""
    if learn and cfg.cadence_active:
        learn = bool(cfg.learns_on(tick))
    return _step_impl(state, values, ts_unix, cfg, learn)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.classifier.enabled:
        raise NotImplementedError(
            "the SDR classifier is not ported yet (ROADMAP.md, port queue A)")


def group_step(state: dict, values: torch.Tensor, ts_unix: torch.Tensor, cfg: ModelConfig,
               learn: bool = True, tick: int | None = None):
    """One tick for a group: `values` [G, n_fields] f32, `ts_unix` [G] ->
    (state, raw [G] f32)."""
    _check_supported(cfg)
    if learn and cfg.cadence_active and tick is None:
        tick = int(state["tm_iter"].reshape(-1)[0])
    return _tick(state, values, ts_unix, cfg, learn, tick)


def chunk_step(state: dict, values: torch.Tensor, ts_unix: torch.Tensor, cfg: ModelConfig,
               learn: bool = True, tick0: int | None = None):
    """T ticks for a group: `values` [T, G, n_fields] f32, `ts_unix` [T, G]
    -> (state, raw [T, G] f32). `tick0` is stream 0's tm_iter at the start
    of the chunk (read from the device once when not given and a cadence
    is active)."""
    _check_supported(cfg)
    T, G = values.shape[:2]
    if learn and cfg.cadence_active and tick0 is None:
        tick0 = int(state["tm_iter"].reshape(-1)[0])
    raw = torch.empty((T, G), dtype=torch.float32, device=values.device)
    for t in range(T):
        tick = None if tick0 is None else tick0 + t
        state, raw[t] = _tick(state, values[t], ts_unix[t], cfg, learn, tick)
    return state, raw


def replicate_state_device(state: dict, group_size: int, device) -> dict:
    """Move ONE stream's numpy state to `device` and broadcast it to
    [G, ...] there (one small transfer, whatever G)."""
    out = {}
    for k, v in state.items():
        t = torch.from_numpy(np.array(v, copy=True)).to(device)
        out[k] = t[None].expand(group_size, *t.shape).contiguous()
    return out


def set_state_row(state: dict, fresh: dict, slot: int) -> dict:
    """Overwrite ONE stream's row of a [G, ...] group state with a fresh
    single-stream numpy state, in place (dynamic slot claim)."""
    for k, t in state.items():
        t[slot] = torch.from_numpy(np.array(fresh[k], copy=True)).to(t.device, t.dtype)
    return state
