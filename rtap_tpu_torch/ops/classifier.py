"""SDR classifier: predicts each stream's next value from its TM cells.

Port of the JAX package's ``ops/classifier_tpu.py`` with the vmapped
stream axis written out as a leading G axis: a softmax regression per
stream from the active-cell pattern [N = C * K] to ``buckets`` value
buckets, trained one step ahead (the pattern at t - 1 toward the bucket of
the value at t), plus a per-bucket EMA of the actual values. The predicted
value for t + 1 is the EMA of the argmax bucket of the pattern at t.

State leaves (models/state.py, present only when cfg.classifier.enabled):
``cls_w`` f32 [G, N, B], ``cls_val`` f32 [G, B], ``cls_cnt`` int32 [G, B].

The pattern-by-weights product is an f32 ``torch.bmm`` (the reference's is
an XLA dot at full f32 precision; TF32 must be off on the card). Its
summation order, and ``exp``, differ between devices and from the
reference, so ``cls_w``, predictions and probabilities agree to a
tolerance; buckets and ``cls_cnt`` are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from rtap_tpu_torch.config import RDSE_BUCKET_CLAMP, ModelConfig


def classifier_bucket(value: torch.Tensor, offset: torch.Tensor, resolution: torch.Tensor,
                      n_buckets: int) -> torch.Tensor:
    """Classifier bucket per stream -> int64 [G]: the RDSE bucket of the
    value (f32, divided by the per-stream resolution tensor), clamped like
    the encoder, non-finite values at relative 0, shifted by n_buckets // 2
    and clipped into [0, n_buckets)."""
    b = torch.round((value - offset) / resolution)
    b = b.clamp(-RDSE_BUCKET_CLAMP, RDSE_BUCKET_CLAMP)  # NaN stays NaN, as jnp.clip
    b = torch.where(torch.isfinite(value) & torch.isfinite(b), b,
                    torch.zeros((), dtype=b.dtype, device=b.device))
    return (b + n_buckets // 2).clamp(0, n_buckets - 1).to(torch.int64)


def _softmax_rows(pattern: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """softmax(pattern @ w) per stream: pattern f32 [G, N], w [G, N, B]."""
    z = torch.bmm(pattern[:, None, :], w)[:, 0]
    z = z - z.max(dim=1, keepdim=True).values
    e = torch.exp(z)
    return e / e.sum(dim=1, keepdim=True)


def classifier_step(state: dict, pattern_prev: torch.Tensor, pattern_now: torch.Tensor,
                    value: torch.Tensor, cfg: ModelConfig, learn: bool):
    """One classifier tick for G streams -> (state, prediction f32 [G],
    probability of the argmax bucket f32 [G]). `pattern_prev` and
    `pattern_now` are the TM's active cells (bool [G, C, K]) at t - 1 and
    t; `value` f32 [G] is the predicted field's value at t."""
    ccfg = cfg.classifier
    B = ccfg.buckets
    G = value.shape[0]
    dev = value.device
    w, act_value, act_count = state["cls_w"], state["cls_val"], state["cls_cnt"]

    bucket = classifier_bucket(value, state["enc_offset"][:, 0],
                               state["enc_resolution"][:, 0], B)
    oh = torch.arange(B, device=dev)[None, :] == bucket[:, None]  # [G, B]
    finite = torch.isfinite(value)

    if learn:
        # actual-value EMA of the observed bucket (its first touch sets it);
        # 1 - a is rounded to f32 once, as the reference's f32 arithmetic
        a = float(np.float32(ccfg.act_value_alpha))
        keep = float(np.float32(1.0) - np.float32(ccfg.act_value_alpha))
        first = torch.where(oh, act_count, 0).sum(dim=1) == 0  # one-hot count probe
        upd = torch.where(first[:, None], value[:, None],
                          keep * act_value + a * value[:, None])
        observed = oh & finite[:, None]
        act_value = torch.where(observed, upd, act_value)
        act_count = act_count + observed.to(act_count.dtype)

        pat = pattern_prev.reshape(G, -1).to(torch.float32)  # [G, N]
        err = oh.to(torch.float32) - _softmax_rows(pat, w)
        do_learn = finite & pattern_prev.reshape(G, -1).any(dim=1)
        rate = torch.where(do_learn, torch.full((), float(np.float32(ccfg.alpha)), device=dev),
                           torch.zeros((), device=dev))
        w = w + rate[:, None, None] * pat[:, :, None] * err[:, None, :]

    p2 = _softmax_rows(pattern_now.reshape(G, -1).to(torch.float32), w)
    best_oh = torch.arange(B, device=dev)[None, :] == p2.argmax(dim=1)[:, None]  # first max
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pred = torch.where(best_oh, act_value, zero).sum(dim=1)
    prob = torch.where(best_oh, p2, zero).sum(dim=1)
    return {**state, "cls_w": w, "cls_val": act_value, "cls_cnt": act_count}, pred, prob
