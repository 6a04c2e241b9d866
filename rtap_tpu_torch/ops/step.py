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

The static ``health`` and ``predict`` flags add the model-side reducers
(ops/health.py, ops/predict.py) after each tick's step, as the JAX
package's ``_tick`` does: ``predict`` updates its own state leaves first,
``health`` reads the state after that, and the predict leaf wraps
outermost, ``(state, (inner, predict_leaf))`` with ``inner`` what health
produced. With both off the step is unchanged.

With ``cfg.classifier.enabled`` the step also runs the SDR classifier
(ops/classifier.py) after the TM and the out becomes ``(raw, prediction,
probability)``, each [G] (each [T, G] from :func:`chunk_step`); the
reducers wrap that tuple as they wrap raw alone. Composite delta fields
advance their predecessor ``enc_prev`` to the last finite value after
encoding.
"""

from __future__ import annotations

import numpy as np
import torch

from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.ops.classifier import classifier_step
from rtap_tpu_torch.ops.encoders import bind_offsets, encode
from rtap_tpu_torch.ops.health import health_reduce
from rtap_tpu_torch.ops.predict import predict_update
from rtap_tpu_torch.ops.sp import sp_step
from rtap_tpu_torch.ops.tm import learn_pass_inputs, tm_step


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
        enc_prev = state.get("enc_prev")  # composite delta fields only
        sdr = encode(cfg, values, ts_unix, enc_offset, state["enc_resolution"], enc_prev)
        if enc_prev is not None:
            # the predecessor advances after encoding (this tick encoded
            # against the one before); NaN gaps keep the pre-gap baseline
            state["enc_prev"] = torch.where(torch.isfinite(values), values, enc_prev)
        return state, sdr

    def sp(state, sdr):
        return sp_step(state, sdr, cfg.sp, learn)

    def tm(state, active):
        return tm_step(state, active, cfg.tm, learn)

    return (("bind_encode", bind_encode), ("sp", sp), ("tm", tm))


def next_learn_pass(cfg: ModelConfig, state: dict, values: torch.Tensor,
                    ts_unix: torch.Tensor):
    """The TM learning pass (a ``LearnPass``) that the step would run on one
    more learning tick of `state` on record (values [G, n_fields], ts_unix
    [G]): the stages before the TM stage, then the TM stage's own prep."""
    x = (values, ts_unix)
    for name, stage in step_stages(cfg, True):
        if name == "tm":
            return learn_pass_inputs(state, x, cfg.tm)
        state, x = stage(state, x)
    raise AssertionError("the step has no TM stage")


def _step_impl(state: dict, values: torch.Tensor, ts_unix: torch.Tensor,
               cfg: ModelConfig, learn: bool):
    """One fused record step for G streams -> (new_state, raw f32 [G]), or
    (new_state, (raw, prediction, probability)) with the classifier.
    `values` is [G, n_fields] f32 (NaN = missing sample), `ts_unix` [G]."""
    pattern_prev = state["prev_active"]  # TM active cells at t - 1
    x = (values, ts_unix)
    for _, stage in step_stages(cfg, learn):
        state, x = stage(state, x)
    if cfg.classifier.enabled:
        state, pred, prob = classifier_step(state, pattern_prev, state["prev_active"],
                                            values[:, 0], cfg, learn)
        return state, (x, pred, prob)
    return state, x


def _tick(state: dict, values: torch.Tensor, ts_unix: torch.Tensor, cfg: ModelConfig,
          learn: bool, tick: int | None, health: bool = False, predict: bool = False):
    """One group tick honoring cfg's learning cadence; `tick` is stream 0's
    tm_iter before the tick (completed steps, lockstep across the group).
    With `health` the out becomes (out, health_leaf); with `predict` the
    predict leaf wraps outermost."""
    if learn and cfg.cadence_active:
        learn = bool(cfg.learns_on(tick))
    state, out = _step_impl(state, values, ts_unix, cfg, learn)
    if predict:
        state, pleaf = predict_update(state, values, cfg, tick)
    if health:
        raw = out[0] if cfg.classifier.enabled else out
        out = (out, health_reduce(state, raw, values, cfg))
    if predict:
        out = (out, pleaf)
    return state, out


def _needs_tick(cfg: ModelConfig, learn: bool, predict: bool) -> bool:
    return (learn and cfg.cadence_active) or predict


def group_step(state: dict, values: torch.Tensor, ts_unix: torch.Tensor, cfg: ModelConfig,
               learn: bool = True, tick: int | None = None, health: bool = False,
               predict: bool = False):
    """One tick for a group: `values` [G, n_fields] f32, `ts_unix` [G] ->
    (state, raw [G] f32), the out wrapped by the reducers' leaves as in
    :func:`_tick`."""
    if tick is None and _needs_tick(cfg, learn, predict):
        tick = int(state["tm_iter"].reshape(-1)[0])
    return _tick(state, values, ts_unix, cfg, learn, tick, health, predict)


def _stack(leaves: list[dict]) -> dict:
    return {k: torch.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}


def chunk_step(state: dict, values: torch.Tensor, ts_unix: torch.Tensor, cfg: ModelConfig,
               learn: bool = True, tick0: int | None = None, health: bool = False,
               predict: bool = False):
    """T ticks for a group: `values` [T, G, n_fields] f32, `ts_unix` [T, G]
    -> (state, raw [T, G] f32), or (state, (raw, prediction, probability))
    each [T, G] with the classifier. `tick0` is stream 0's tm_iter at the
    start of the chunk (read from the device once when not given and a
    cadence or the predictor needs it). With `health`/`predict` the out is
    wrapped as in :func:`_tick`, each leaf stacked over the T ticks."""
    T, G = values.shape[:2]
    if tick0 is None and _needs_tick(cfg, learn, predict):
        tick0 = int(state["tm_iter"].reshape(-1)[0])
    cols = 3 if cfg.classifier.enabled else 1  # raw (, prediction, probability)
    outs = torch.empty((cols, T, G), dtype=torch.float32, device=values.device)
    hleaves, pleaves = [], []
    for t in range(T):
        tick = None if tick0 is None else tick0 + t
        state, out = _tick(state, values[t], ts_unix[t], cfg, learn, tick, health, predict)
        if predict:
            out, pleaf = out
            pleaves.append(pleaf)
        if health:
            out, hleaf = out
            hleaves.append(hleaf)
        if cfg.classifier.enabled:
            for c, o in enumerate(out):
                outs[c, t] = o
        else:
            outs[0, t] = out
    out = tuple(outs) if cfg.classifier.enabled else outs[0]
    if health:
        out = (out, _stack(hleaves))
    if predict:
        out = (out, _stack(pleaves))
    return state, out


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
