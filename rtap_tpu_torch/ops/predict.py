"""The predictive-horizon reducer: how well the TM's forward model held.

Port of the JAX package's ``ops/predict_tpu.py::predict_update``. The TM's
active segments name the columns it expects next; the reducer keeps a
k-deep ring of those predicted-active column sets in predictor-owned state
leaves (``pred_ring``, ``pred_miss_ewma``, ``pred_tick0``; models/state.py)
and, each tick t, compares the set captured at t - k with the columns that
actually fired at t. The per-stream leaf it returns (:data:`PREDICT_KEYS`)
is what the host tracker (rtap_tpu_torch/predict/) pages precursors on.

Semantics, per tick t (post-step state):

- ring slot ``t % k`` is read (the prediction captured at t - k), then
  overwritten with this tick's prediction;
- overlap = |old & act| / max(|act|, 1), miss = 1 - overlap;
- a stream scores iff it is live (a finite input field) and
  ``t >= pred_tick0 + k`` (a claimed slot's zeroed ring must not fake a
  divergence);
- the EWMA folds ``miss`` with :data:`PRED_ALPHA` on scored ticks only; the
  first scored tick adopts ``miss`` outright.

The model leaves are only read, so model state and scores are the same
with the reducer on or off. The tick t comes from the host (the caller's
lockstep tick counter, stream 0's ``tm_iter`` before the tick), so no tick
reads the device. All arithmetic is f32 with a power-of-two alpha, and
every division is by a device tensor (PyTorch on cuda turns a division by a
host scalar into a multiplication by its reciprocal), so the card, the CPU
and the JAX package agree bit for bit. Constants are made with
``torch.full`` on the device: a host tensor copied there would wait for the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from rtap_tpu_torch.config import ModelConfig

#: divergence-EWMA step — a power of two, so the fold is exact whatever
#: the order of its multiply and add
PRED_ALPHA = np.float32(0.125)

#: the leaf's key set, in a fixed order (the JAX package's schema): per-
#: stream vectors, so the tracker can page with a stable stream id
PREDICT_KEYS = (
    "overlap",        # f32 [G] predicted(t-k) -> actual(t) column overlap
    #                           (NaN on unscored streams)
    "miss_ewma",      # f32 [G] post-update divergence EWMA (NaN until a
    #                           stream's first scored tick)
    "pred_col_frac",  # f32 [G] predicted-active column fraction (of C)
    "scored",         # bool [G] live AND past the per-stream horizon
)


def predict_update(state: dict, values: torch.Tensor, cfg: ModelConfig,
                   tick: int) -> tuple[dict, dict]:
    """Fold one tick into the predictor leaves -> (state', leaf [G]).

    `state` is the post-step group state, `values` the tick's [G, n_fields]
    inputs (the live-stream mask), `tick` the tick just scored (stream 0's
    ``tm_iter`` before it). Only ``pred_ring`` (in place) and
    ``pred_miss_ewma`` change."""
    tm = cfg.tm
    C, K, S = cfg.sp.columns, tm.cells_per_column, tm.max_segments_per_cell
    ring = state["pred_ring"]
    G, k = ring.shape[0], ring.shape[1]
    dev = ring.device
    f32 = torch.float32

    liv = torch.isfinite(values).any(-1)
    act = state["prev_active"].reshape(G, C, K).any(-1)  # [G, C] this tick
    pred_new = state["active_seg"].reshape(G, C, K * S).any(-1)  # for t+1

    slot = int(tick) % k
    old = ring[:, slot]  # the set captured at t - k (read before the write)
    act_n = act.sum(-1).to(f32)
    ov_n = (old & act).sum(-1).to(f32)
    one = torch.ones((), dtype=f32, device=dev)
    overlap = ov_n / torch.maximum(act_n, one)
    miss = one - overlap

    scored = liv & (state["pred_tick0"].reshape(G) + k <= int(tick))

    ewma = state["pred_miss_ewma"].reshape(G).to(f32)
    folded = torch.where(torch.isnan(ewma), miss, ewma + float(PRED_ALPHA) * (miss - ewma))
    new_ewma = torch.where(scored, folded, ewma)

    ring[:, slot] = pred_new
    state = {**state, "pred_miss_ewma": new_ewma.reshape(state["pred_miss_ewma"].shape)}
    nan = torch.full((), float("nan"), dtype=f32, device=dev)
    leaf = {
        "overlap": torch.where(scored, overlap, nan),
        "miss_ewma": new_ewma,
        "pred_col_frac": pred_new.sum(-1).to(f32) / torch.full((), float(C), dtype=f32, device=dev),
        "scored": scored,
    }
    return state, leaf
