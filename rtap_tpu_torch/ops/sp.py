"""Spatial Pooler, batched over a stream group.

Port of the JAX package's ``ops/sp_tpu.py`` (``sp_overlap``, ``sp_inhibit``,
``sp_learn``, ``sp_step``) with the vmapped stream axis written out as a
leading G axis. Both pool layouts:

* sparse (the cluster preset's): ``members`` [G, C, P] input indices, -1 =
  empty; overlap gathers the SDR at the members and counts connected hits.
* dense: ``potential`` bool [G, C, n_in]; overlap is a 0/1 f32 product left
  to ``torch.matmul`` (the JAX package leaves it to XLA). Counts stay exact
  integers below 2^24; TF32 would break that, so the product refuses to run
  with ``torch.backends.cuda.matmul.allow_tf32`` on (the entry points turn
  it off: ``StreamGroup`` on cuda, ``chip_smoke.py``).

Inhibition is top-k over the unique score ``overlap*C + (C-1-c)``, so the
winners are those of the JAX package's ``lax.top_k`` exactly. Quantized
permanence domains compute in int32 (torch has no arithmetic or compares on
uint16) and store back in the storage dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from rtap_tpu_torch.config import SPConfig
from rtap_tpu_torch.models.perm import sp_domain

_STORAGE = {np.float32: torch.float32, np.uint16: torch.uint16, np.uint8: torch.uint8}


def _compute(perm: torch.Tensor, dom) -> torch.Tensor:
    """Storage -> compute dtype (f32, or int32 for quantized domains)."""
    return perm.to(torch.float32 if dom.bits == 0 else torch.int32)


def _gather_sdr(pool: torch.Tensor, sdr: torch.Tensor) -> torch.Tensor:
    """SDR bits at each member slot: bool [G, C, P]. Empty slots (-1) read
    index 0 and are masked out by every caller via ``pool >= 0``."""
    G, C, P = pool.shape
    idx = pool.to(torch.int64).clamp_(min=0).reshape(G, C * P)
    return torch.gather(sdr, 1, idx).reshape(G, C, P)


def sp_overlap(perm: torch.Tensor, pool: torch.Tensor, sdr: torch.Tensor,
               cfg: SPConfig) -> torch.Tensor:
    """Overlap per column = |connected potential synapses ∩ active inputs|
    -> int32 [G, C]."""
    dom = sp_domain(cfg)
    thr = dom.threshold(cfg.syn_perm_connected)
    thr = float(thr) if dom.bits == 0 else thr
    if cfg.sparse_pool:
        connected = (_compute(perm, dom) >= thr) & (pool >= 0)
        hit = _gather_sdr(pool, sdr)
        return (connected & hit).sum(-1, dtype=torch.int32)
    if perm.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the dense SP overlap needs exact f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    connected = ((_compute(perm, dom) >= thr) & pool).to(torch.float32)
    ov = torch.matmul(connected, sdr.to(torch.float32)[:, :, None])[:, :, 0]
    return ov.to(torch.int32)


def sp_inhibit(overlap: torch.Tensor, boost: torch.Tensor, cfg: SPConfig) -> torch.Tensor:
    """Global k-winner inhibition -> bool [G, C]. The score is unique per
    column, so top-k has no ties."""
    G, C = overlap.shape
    col_rev = C - 1 - torch.arange(C, dtype=torch.int32, device=overlap.device)
    if cfg.boost_strength > 0.0:
        # same f32 clamp as the JAX package, before the int cast
        qmax = float(np.float32(min((2**31 - C) // C, 2**24)))
        qf = torch.round(overlap.to(torch.float32) * boost * 256.0)
        q = qf.clamp(0.0, qmax).to(torch.int32)
        score = q * C + col_rev
    else:
        score = overlap * C + col_rev
    winners = torch.topk(score, cfg.num_active_columns, dim=-1).indices
    active = torch.zeros((G, C), dtype=torch.bool, device=overlap.device)
    active.scatter_(1, winners, True)
    return active & (overlap >= cfg.stimulus_threshold)


def sp_learn(state: dict, sdr: torch.Tensor, overlap: torch.Tensor,
             active: torch.Tensor, cfg: SPConfig) -> dict:
    """Hebbian update on winners + duty cycles + boost + weak-column bump,
    in the JAX package's op order (hebbian -> clip -> duty -> boost -> bump
    -> clip). Returns the updated SP slice of the state dict."""
    dom = sp_domain(cfg)
    if cfg.sparse_pool:
        pool = state["members"]
        valid = pool >= 0
        hit = _gather_sdr(pool, sdr)
        inc_mask = active[:, :, None] & valid & hit
        dec_mask = active[:, :, None] & valid & ~hit
        bump_pool = valid
    else:
        pool = state["potential"]
        inc_mask = active[:, :, None] & pool & sdr[:, None, :]
        dec_mask = active[:, :, None] & pool & ~sdr[:, None, :]
        bump_pool = pool
    cdt = torch.float32 if dom.bits == 0 else torch.int32
    # domain constants as python scalars (f32-exact floats, or ints): a
    # numpy scalar on the left of a tensor op would hand it to numpy
    rate = (lambda v: float(dom.rate(v))) if dom.bits == 0 else dom.rate
    one = float(dom.one) if dom.bits == 0 else dom.one
    zero = float(dom.zero) if dom.bits == 0 else dom.zero
    perm = _compute(state["perm"], dom)
    # inc/dec masks are disjoint: (perm + inc) - dec equals the sequential form
    perm = perm + rate(cfg.syn_perm_active_inc) * inc_mask.to(cdt) \
        - rate(cfg.syn_perm_inactive_dec) * dec_mask.to(cdt)
    perm = perm.clamp(zero, one)

    it = state["sp_iter"] + 1
    period = torch.clamp(it, max=cfg.duty_cycle_period).to(torch.float32)[:, None]
    overlap_now = (overlap > 0).to(torch.float32)
    # d + (x - d) / p: sub/div/add, no multiply-add to contract
    overlap_duty = state["overlap_duty"] + (overlap_now - state["overlap_duty"]) / period
    active_duty = state["active_duty"] + (active.to(torch.float32) - state["active_duty"]) / period

    boost = state["boost"]
    if cfg.boost_strength > 0.0:
        target = np.float32(cfg.num_active_columns / perm.shape[1])
        boost = torch.exp((float(target) - active_duty) * float(np.float32(cfg.boost_strength)))

    min_duty = float(np.float32(cfg.min_pct_overlap_duty_cycle)) * overlap_duty.amax(-1, keepdim=True)
    weak = overlap_duty < min_duty
    perm = (perm + rate(cfg.syn_perm_below_stimulus_inc)
            * (weak[:, :, None] & bump_pool).to(cdt)).clamp(zero, one)

    return {
        **state,
        "perm": perm.to(_STORAGE[dom.dtype]),
        "boost": boost,
        "overlap_duty": overlap_duty,
        "active_duty": active_duty,
        "sp_iter": it,
    }


def sp_step(state: dict, sdr: torch.Tensor, cfg: SPConfig, learn: bool = True):
    """One SP step for G streams -> (new_state, bool [G, C] active columns)."""
    pool = state["members"] if cfg.sparse_pool else state["potential"]
    overlap = sp_overlap(state["perm"], pool, sdr, cfg)
    active = sp_inhibit(overlap, state["boost"], cfg)
    if learn:
        state = sp_learn(state, sdr, overlap, active, cfg)
    return state, active
