"""Model-health reducers: one small per-group leaf per tick.

Port of the JAX package's ``ops/health_tpu.py::health_reduce``. It reads the
post-step group state and reduces it to a leaf of about 200 bytes
(:data:`HEALTH_KEYS`): segment-pool occupancy, synapse fill and a
permanence sketch, SDR sparsity, the predicted->active hit rate and a
streaming score histogram. The host tracker (obs/health.py) folds it into
per-group scorecards and drift detection. Reads only: model state and
scores are the same with the reducer on or off.

Per-stream fractions are averaged over the LIVE streams of the tick (a
finite input field): pad slots and silent streams do not dilute a
half-full group. Pool-wide quantities are reduced as per-stream fractions,
never as group-wide counts.

The synapse pool is the big read (every slot of every stream, every tick).
Each used slot's permanence bin and connected bit make one code in
[0, 2 * PERM_BINS), an empty slot the code 2 * PERM_BINS; one integer
``index_add_`` over ``stream * (2 * PERM_BINS + 1) + code`` gives every
stream's histogram, connected count and fill in one pass, exact by
construction. (``torch.bincount`` would read its input's maximum back to
the host, which waits for the device.) Divisions are by device tensors:
PyTorch on cuda turns a division by a host scalar into a multiplication by
its reciprocal, which can move a bin edge.
"""

from __future__ import annotations

import torch

from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.perm import tm_domain

#: per-stream segment-pool occupancy histogram bins
OCC_BINS = 8

#: permanence-sketch bins over the [0, 1] domain (per-stream-normalized,
#: then averaged over live streams)
PERM_BINS = 8

#: streaming anomaly-score histogram bins over [0, 1]
SCORE_BINS = 16

#: the leaf's key set, in a fixed order (the JAX package's schema)
HEALTH_KEYS = (
    "occ_hist",        # i32 [OCC_BINS]  live streams per occupancy bin
    "seg_occ_frac",    # f32 []  mean used-segment fraction (live streams)
    "syn_frac",        # f32 []  mean non-empty synapse-slot fraction
    "perm_hist",       # f32 [PERM_BINS] mean normalized permanence sketch
    "perm_conn_frac",  # f32 []  mean connected fraction among non-empty
    "act_col_frac",    # f32 []  mean active-column fraction (of C)
    "pred_cell_frac",  # f32 []  mean predictive-cell fraction (of C*K)
    "hit_num",         # f32 []  sum of (1 - raw) * active_cols (scored)
    "hit_den",         # f32 []  sum of active_cols (scored streams)
    "score_hist",      # i32 [SCORE_BINS] scored streams per raw-score bin
    "scored",          # i32 []  streams scored this tick (live, finite raw)
)


def _hist(bins: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """Count of masked entries per bin of `bins` ([G] ints in [0, n)) -> i32 [n]."""
    hit = (bins[:, None] == torch.arange(n, device=bins.device)) & mask[:, None]
    return hit.sum(0).to(torch.int32)


def health_reduce(state: dict, raw: torch.Tensor, values: torch.Tensor,
                  cfg: ModelConfig) -> dict:
    """Per-group health leaf from the post-step group state: `raw` is the
    tick's [G] raw scores, `values` its [G, n_fields] inputs."""
    tm = cfg.tm
    C, K, S = cfg.sp.columns, tm.cells_per_column, tm.max_segments_per_cell
    G = state["seg_last"].shape[0]
    dev = raw.device
    f32 = torch.float32

    def const(v):
        return torch.full((), float(v), dtype=f32, device=dev)

    liv = torch.isfinite(values).any(-1)  # [G] streams with data this tick
    livf = liv.to(f32)
    n_live = torch.maximum(livf.sum(), const(1.0))

    # -- segment-pool occupancy --
    seg_last = state["seg_last"].reshape(G, -1)
    occ = (seg_last >= 0).sum(-1).to(f32) / const(seg_last.shape[1])  # [G]
    occ_bin = (occ * OCC_BINS).to(torch.int32).clamp(0, OCC_BINS - 1)
    occ_hist = _hist(occ_bin, liv, OCC_BINS)
    seg_occ_frac = (occ * livf).sum() / n_live

    # -- synapse pool + permanence sketch: one counting pass --
    presyn = state["presyn"].reshape(G, -1)
    perm_f = state["syn_perm"].reshape(G, -1).to(f32)
    dom = tm_domain(tm)
    pbin = (perm_f / const(dom.one) * PERM_BINS).to(torch.int32).clamp_(0, PERM_BINS - 1)
    conn_thr = float(dom.threshold(tm.connected_permanence))
    code = pbin + PERM_BINS * (perm_f >= conn_thr).to(torch.int32)
    del perm_f, pbin
    n_codes = 2 * PERM_BINS + 1  # the last: an empty slot
    code = torch.where(presyn >= 0, code, n_codes - 1)
    code += torch.arange(G, device=dev, dtype=torch.int32)[:, None] * n_codes
    flat = code.reshape(-1)
    counts = torch.zeros(G * n_codes, dtype=torch.int32, device=dev).index_add_(
        0, flat, torch.ones(1, dtype=torch.int32, device=dev).expand(flat.numel()))
    del code, flat
    # [G, connected?, bin]
    counts = counts.reshape(G, n_codes)[:, :-1].reshape(G, 2, PERM_BINS).to(f32)
    per_bin = counts.sum(1)  # [G, PERM_BINS]
    syn_used = per_bin.sum(-1)  # [G]
    conn = counts[:, 1].sum(-1)
    syn_frac = (syn_used / const(presyn.shape[1]) * livf).sum() / n_live
    denom = torch.maximum(syn_used, const(1.0))
    perm_hist = (per_bin / denom[:, None] * livf[:, None]).sum(0) / n_live
    perm_conn_frac = (conn / denom * livf).sum() / n_live

    # -- SDR sparsity (post-step prev_active = this tick's active cells;
    #    post-step active_seg = the dendrites predicting t+1) --
    ac = state["prev_active"].reshape(G, C, K).any(-1).sum(-1).to(f32)  # [G]
    act_col_frac = (ac / const(C) * livf).sum() / n_live
    pred_cells = state["active_seg"].reshape(G, C * K, S).any(-1).sum(-1).to(f32)
    pred_cell_frac = (pred_cells / const(C * K) * livf).sum() / n_live

    # -- predicted->active hit rate + streaming score histogram --
    rawc = torch.nan_to_num(raw, nan=0.0).clamp(0.0, 1.0)
    rfin = torch.isfinite(raw) & liv
    rfinf = rfin.to(f32)
    hit_num = (rfinf * (1.0 - rawc) * ac).sum()
    hit_den = (rfinf * ac).sum()
    sbin = (rawc * SCORE_BINS).to(torch.int32).clamp(0, SCORE_BINS - 1)
    score_hist = _hist(sbin, rfin, SCORE_BINS)

    return {
        "occ_hist": occ_hist,
        "seg_occ_frac": seg_occ_frac,
        "syn_frac": syn_frac,
        "perm_hist": perm_hist,
        "perm_conn_frac": perm_conn_frac,
        "act_col_frac": act_col_frac,
        "pred_cell_frac": pred_cell_frac,
        "hit_num": hit_num,
        "hit_den": hit_den,
        "score_hist": score_hist,
        "scored": rfin.sum().to(torch.int32),
    }


def health_pool_bytes(cfg: ModelConfig, group_size: int) -> int:
    """Bytes the reducer must read per (group, tick): every slot's presyn and
    permanence, and every segment's ``seg_last`` (the leaf it writes and the
    small per-stream masks are left out)."""
    tm = cfg.tm
    n_seg = cfg.sp.columns * tm.cells_per_column * tm.max_segments_per_cell
    psz = 2 if cfg.num_cells <= (1 << 15) - 1 else 4
    perm_sz = {0: 4, 8: 1, 16: 2}[tm.perm_bits]
    return group_size * (n_seg * tm.max_synapses_per_segment * (psz + perm_sz) + n_seg * 4)

