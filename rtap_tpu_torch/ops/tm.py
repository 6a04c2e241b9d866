"""Temporal Memory, batched over a stream group.

Port of the JAX package's ``ops/tm_tpu.py::tm_step`` in one formulation:
the decision logic on [G, C, K, S]-scale tensors (column categorization,
learning segments, allocation targets, cell and winner sets, the raw
score), then on learning ticks the TM learning pass of ``ops/tm_learn.py``
(the CUDA kernel on the card), and on inference ticks the plain dendrite
pass. The JAX package's TPU strategy switches (matmul/indexed scatter, flat
layout, compact sweep, forward index) work around TPU gather/scatter and
carry no semantics of their own, so they are not ported; the learning pass
matches the default path and the megakernel bit for bit.

State uses the public layout with a leading G axis (models/state.py). On
learning ticks the pools ``presyn``/``syn_perm`` are updated in place; the
other leaves are new tensors. Tie-breaks are lowest-index everywhere
(``torch.argmax``/``argmin`` return the first index, like numpy and XLA).
"""

from __future__ import annotations

import torch

from rtap_tpu_torch.config import TMConfig
from rtap_tpu_torch.models.perm import tm_domain
from rtap_tpu_torch.ops.tm_learn import LearnPass, learn_pass, presyn_active_packed, tm_learn


def _compact_ids(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first `size` True entries of each row of `mask`
    [G, n], ascending, filled with n -> int32 [G, size]. The top-k form:
    descending top-k of the distinct values n - index is ascending index."""
    G, n = mask.shape
    k = min(size, n)
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    top = torch.topk(torch.where(mask, n - iota, 0), k, dim=-1).values
    ids = torch.where(top > 0, n - top, n).to(torch.int32)
    if k < size:
        ids = torch.cat([ids, torch.full((G, size - k), n, dtype=torch.int32, device=mask.device)], 1)
    return ids


def _pack_active(cells: torch.Tensor, Ac: int):
    """Column-compact form of a [G, C, K] cell set (K <= 32) -> (col_ids
    [G, Ac] int32 ascending with C fills, col_masks [G, Ac] int32 K-bit
    packed cell masks, n_cols [G] total occupied columns)."""
    G, C, K = cells.shape
    col_any = cells.any(-1)
    col_ids = _compact_ids(col_any, Ac)
    # torch sums int32 into int64 and never wraps: fold bit 31 back to the
    # int32 two's-complement value the JAX package holds at K = 32
    packed = (cells.to(torch.int64) << torch.arange(K, device=cells.device)).sum(-1)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(torch.int32)
    packed = torch.cat([packed, torch.zeros((G, 1), dtype=torch.int32, device=cells.device)], 1)
    col_masks = torch.gather(packed, 1, col_ids.to(torch.int64))  # fill id C reads 0
    return col_ids, col_masks, col_any.sum(-1)


def _winner_id_list(winner: torch.Tensor, Ac: int) -> torch.Tensor:
    """Flat cell ids of the winner cells [G, C, K], ascending where valid,
    invalid entries = N -> int32 [G, Ac*K]."""
    G, C, K = winner.shape
    N = C * K
    col_ids = _compact_ids(winner.any(-1), Ac)  # [G, Ac]
    valid = col_ids < C
    rows = torch.gather(winner, 1, col_ids.clamp(max=C - 1).to(torch.int64)[:, :, None].expand(G, Ac, K))
    rows = rows & valid[:, :, None]
    ids = col_ids[:, :, None] * K + torch.arange(K, dtype=torch.int32, device=winner.device)
    return torch.where(rows, ids, N).reshape(G, Ac * K).to(torch.int32)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """First index of the maximum along the last axis (bool cast first:
    torch has no bool argmax)."""
    return torch.argmax(x.to(torch.int32) if x.dtype == torch.bool else x, dim=-1)


def _segment_learning_mask(cfg: TMConfig, active_cols, active_seg, matching_seg, seg_pot,
                           seg_last, have_winners):
    """Categorize columns and pick the per-column learning segments ->
    (predicted_cols, learn_mask, (alloc_col, bn_k, bn_s), winner_extra, burst)."""
    G, C, K, S = active_seg.shape
    dev = active_seg.device
    prev_predictive = active_seg.any(-1)  # [G, C, K]
    predicted_cols = prev_predictive.any(-1)  # [G, C]

    burst = active_cols & ~predicted_cols
    col_matching = matching_seg.reshape(G, C, K * S).any(-1)
    burst_match = burst & col_matching
    burst_new = burst & ~col_matching & have_winners[:, None]

    # (a) predicted columns: every active segment of every predicted cell learns
    mask_pred = active_cols[:, :, None, None] & active_seg

    # (b) burst-matching: best matching segment (max seg_pot, lowest flat index)
    pot = torch.where(matching_seg, seg_pot.to(torch.int32), -1).reshape(G, C, K * S)
    best_flat = _argmax_first(pot)
    bm_k = torch.div(best_flat, S, rounding_mode="floor")
    bm_mask = (torch.arange(K * S, device=dev) == best_flat[:, :, None]) & burst_match[:, :, None]
    bm_mask = bm_mask.reshape(G, C, K, S)

    # (c) burst-new: cell with fewest segments; first free slot else LRU slot
    seg_counts = (seg_last >= 0).sum(-1)  # [G, C, K]
    bn_k = torch.argmin(seg_counts, dim=-1)
    row_last = torch.gather(seg_last, 2, bn_k[:, :, None, None].expand(G, C, 1, S))[:, :, 0]
    any_free = (row_last < 0).any(-1)
    first_free = _argmax_first(row_last < 0)
    lru = torch.argmin(row_last, dim=-1)
    bn_s = torch.where(any_free, first_free, lru)

    kk = torch.arange(K, device=dev)
    winner_extra = (burst_match[:, :, None] & (kk == bm_k[:, :, None])) | (
        (burst & ~col_matching)[:, :, None] & (kk == bn_k[:, :, None])
    )
    alloc_col = torch.where(burst_new, torch.arange(C, device=dev), C)
    return predicted_cols, mask_pred | bm_mask, (alloc_col, bn_k, bn_s), winner_extra, burst


def _dendrite_counts(presyn, syn_perm, acol_ids, acol_masks, p_connected, C, K):
    """conn/pot counts per segment on the full pools (inference ticks),
    in slices of streams so temporaries stay bounded at any G."""
    G = presyn.shape[0]
    per = presyn[0].numel()
    step = max(1, (1 << 26) // max(1, per))
    conn, pot = [], []
    for g0 in range(0, G, step):
        s = slice(g0, g0 + step)
        act = presyn_active_packed(presyn[s], acol_ids[s], acol_masks[s], C, K)
        perm = syn_perm[s].to(torch.float32 if syn_perm.dtype == torch.float32 else torch.int32)
        conn.append((act & (perm >= p_connected)).sum(-1, dtype=torch.int32))
        pot.append(act.sum(-1, dtype=torch.int32))
    return torch.cat(conn), torch.cat(pot)


def _decide(state: dict, active_cols: torch.Tensor, cfg: TMConfig) -> dict:
    """The [C, K, S]-scale decisions of one tick (pure function of the
    previous state and this tick's active columns)."""
    G, C, K, S, M = state["presyn"].shape
    if K > 32:
        raise ValueError("cells_per_column > 32 unsupported (packed cell masks)")
    active_seg = state["active_seg"]
    prev_predictive = active_seg.any(-1)  # [G, C, K]
    prev_pred_cols = prev_predictive.any(-1)
    n_active = active_cols.sum(-1)
    hits = (active_cols & prev_pred_cols).sum(-1)
    raw = torch.where(
        n_active > 0,
        1.0 - hits.to(torch.float32) / n_active.clamp(min=1).to(torch.float32),
        0.0,
    )

    have_winners = state["prev_winner"].reshape(G, -1).any(-1)
    predicted_cols, learn_mask, alloc, winner_extra, burst = _segment_learning_mask(
        cfg, active_cols, active_seg, state["matching_seg"], state["seg_pot"],
        state["seg_last"], have_winners)

    # cell activation / winner selection (pure function of prev state)
    pred_active = (active_cols & predicted_cols)[:, :, None] & prev_predictive
    active_cells = pred_active | burst[:, :, None]
    acol_ids, acol_masks, a_cols = _pack_active(active_cells, cfg.col_cap)
    return dict(raw=raw, have_winners=have_winners, learn_mask=learn_mask, alloc=alloc,
                active_cells=active_cells, winner_cells=pred_active | winner_extra,
                acol_ids=acol_ids, acol_masks=acol_masks, a_cols=a_cols)


def learn_pass_inputs(state: dict, active_cols: torch.Tensor, cfg: TMConfig,
                      d: dict | None = None) -> LearnPass:
    """The learning pass that :func:`tm_step` runs on a learning tick of
    `state` (`d`: this tick's :func:`_decide`, computed when not given)."""
    if d is None:
        d = _decide(state, active_cols, cfg)
    pcol_ids, pcol_masks, p_cols = _pack_active(state["prev_active"], cfg.col_cap)
    return learn_pass(
        cfg, tm_domain(cfg), state["presyn"], state["syn_perm"], state["seg_pot"],
        state["matching_seg"], d["learn_mask"], d["alloc"], active_cols, d["have_winners"],
        pcol_ids, pcol_masks, p_cols, _winner_id_list(state["prev_winner"], cfg.col_cap),
        d["acol_ids"], d["acol_masks"])


def tm_step(state: dict, active_cols: torch.Tensor, cfg: TMConfig, learn: bool = True):
    """One TM step for G streams -> (new_state, raw anomaly score f32 [G]).

    `active_cols` is bool [G, C]. On learning ticks the pools are updated
    in place."""
    G, C, K, S, M = state["presyn"].shape
    Ac = cfg.col_cap
    dom = tm_domain(cfg)
    p_connected = dom.threshold(cfg.connected_permanence)
    p_connected = float(p_connected) if dom.bits == 0 else p_connected

    presyn = state["presyn"]
    syn_perm = state["syn_perm"]
    seg_last = state["seg_last"]
    it = state["tm_iter"] + 1
    d = _decide(state, active_cols, cfg)
    acol_ids, acol_masks, a_cols = d["acol_ids"], d["acol_masks"], d["a_cols"]

    if learn:
        lp = learn_pass_inputs(state, active_cols, cfg, d)
        seg_last, conn_count, pot_count = tm_learn(lp, seg_last, it)
        overflow = lp.overflow
    else:
        overflow = torch.zeros(G, dtype=torch.bool, device=presyn.device)
        conn_count, pot_count = _dendrite_counts(presyn, syn_perm, acol_ids, acol_masks,
                                                 p_connected, C, K)
    # the packed-column truncation applies under inference too — count it always
    tm_overflow = state["tm_overflow"] + (overflow | (a_cols > Ac)).to(torch.int32)

    exists_seg = seg_last >= 0
    active_seg = exists_seg & (conn_count >= cfg.activation_threshold)
    matching_seg = exists_seg & (pot_count >= cfg.min_threshold)
    seg_pot = torch.where(exists_seg, pot_count.to(torch.int16), 0).to(torch.int16)
    if learn:
        # LRU stamp for active segments (NuPIC stamps under learn only)
        seg_last = torch.where(active_seg, it[:, None, None, None], seg_last)

    new_state = {
        **state,
        "presyn": presyn,
        "syn_perm": syn_perm,
        "seg_last": seg_last,
        "active_seg": active_seg,
        "matching_seg": matching_seg,
        "seg_pot": seg_pot,
        "prev_active": d["active_cells"],
        "prev_winner": d["winner_cells"],
        "tm_iter": it,  # advances under inference too
        "tm_overflow": tm_overflow,
    }
    return new_state, d["raw"]

