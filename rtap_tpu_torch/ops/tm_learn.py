"""The TM learning pass: the CUDA kernel's wrapper, its plain PyTorch
version, and the [C, K, S]-scale prep and epilogue around them.

Port of the JAX package's ``ops/pallas_tm.py`` (``tm_learn_pallas`` and its
Pallas ``_mega_kernel``). Per segment row [M] of the [G, n_seg, M] pools
(n_seg = C*K*S) the pass runs alloc-clear, reinforce, grow with eviction,
punish, death, and the dendrite conn/pot counts for t+1.

* :func:`learn_pass` — the harness's prep, batched over G: builds the
  per-row meta word from the decision tensors exactly as ``tm_learn_pallas``
  does (first col_cap active columns, then the first learn_cap learning
  segments in ascending (c, k, s) order) and the overflow flag, and
  gathers the kernel's arguments into a :class:`LearnPass`.
* :func:`tm_learn` — runs a :class:`LearnPass`, then stamps seg_last and
  applies empty-segment death.
* :func:`tm_learn_kernel` — the pass itself. On CUDA tensors it launches
  ``csrc/tm_learn.cu`` (and counts the launch in :data:`launches`) or
  raises; on CPU tensors it runs :func:`tm_learn_plain`. It never falls
  back from one to the other.
* :func:`tm_learn_plain` — the same pass in plain PyTorch, looping over M
  and the winner list as ``_mega_kernel`` does (the winner loop in blocks,
  on the growing rows only: the others add and evict nothing). Like the
  kernel's work list it visits only the rows that hold a synapse or carry
  a learn/alloc/grow/punish bit.

Both versions update the pools IN PLACE, in their storage dtypes (int16/
int32 presyn; f32, uint16 or uint8 perm), and return the per-row counts.
In-place saves a pool-sized copy per tick and replaces the JAX harness's
i32/f32 casts and the caller's round-back.

The meta word per row: bit 0 learn, bit 1 alloc, bit 2 grow, bit 3 punish,
bits 4.. n_grow clamped at 0 (a row with n_grow <= 0 grows nothing under
either reading, so the clamp changes no result).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from rtap_tpu_torch.models.perm import PermDomain

#: launches of the CUDA kernel (plain CPU runs do not count)
launches = 0
# serve's dispatch threads launch concurrently: the count's read-modify-write
# is taken under this lock, so no launch is lost
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def count_launch() -> None:
    """Count one launch of the CUDA kernel (safe from any thread)."""
    global launches
    with _count_lock:
        launches += 1


@dataclass(frozen=True)
class LearnConsts:
    """Permanence-domain constants of the pass, as f32-exact floats;
    ``pdec`` None skips the punish stage."""

    p_inc: float
    p_dec: float
    p_init: float
    p_one: float
    p_zero: float
    p_thr: float
    pdec: float | None

    @classmethod
    def from_config(cls, cfg, dom: PermDomain) -> "LearnConsts":
        pdec = None
        if cfg.predicted_segment_decrement > 0.0:
            pdec = float(dom.rate(cfg.predicted_segment_decrement))
        return cls(
            float(dom.rate(cfg.permanence_increment)),
            float(dom.rate(cfg.permanence_decrement)),
            float(dom.rate(cfg.initial_permanence)),
            float(dom.one),
            float(dom.zero),
            float(dom.threshold(cfg.connected_permanence)),
            pdec,
        )


def _col_table(col_ids: torch.Tensor, col_masks: torch.Tensor, C: int) -> torch.Tensor:
    """Per-stream column-mask table [G, C+1] int32 of a packed active set
    (col_ids [G, Ac] ascending with C fills, col_masks [G, Ac] K-bit int32
    masks, fills 0): ids are unique and the fill entry C keeps mask 0."""
    table = torch.zeros((col_ids.shape[0], C + 1), dtype=torch.int32, device=col_ids.device)
    return table.scatter_(1, col_ids.to(torch.int64), col_masks)


def _active_in(p: torch.Tensor, g: torch.Tensor, table: torch.Tensor, K: int) -> torch.Tensor:
    """Is each presynaptic cell p [n, X] int32, on a row of stream g [n],
    active in that stream's :func:`_col_table`? -> bool [n, X]. -1 floors
    to column -1, mapped to the zero fill entry and masked by ``p >= 0``
    either way."""
    C1 = table.shape[1]
    c_pre = torch.div(p, K, rounding_mode="floor")
    k_pre = p - c_pre * K  # floor remainder: -1 -> K - 1
    idx = g.to(torch.int64)[:, None] * C1 + torch.where(c_pre < 0, C1 - 1, c_pre).to(torch.int64)
    msk = table.reshape(-1)[idx]
    return (p >= 0) & (((msk >> k_pre) & 1) > 0)


def presyn_active_packed(presyn: torch.Tensor, col_ids: torch.Tensor,
                         col_masks: torch.Tensor, C: int, K: int) -> torch.Tensor:
    """Is each synapse's presynaptic cell in the packed active set? -> bool,
    presyn's shape [G, ...]. A per-stream [C+1] column-mask table
    (:func:`_col_table`) replaces the JAX package's [..., Ac]
    compare-and-sum with one gather."""
    G = presyn.shape[0]
    g = torch.arange(G, device=presyn.device)
    act = _active_in(presyn.reshape(G, -1).to(torch.int32), g, _col_table(col_ids, col_masks, C), K)
    return act.reshape(presyn.shape)


def _grow(p, v, n_grow, wids, p_init: float, N: int):
    """Grow on the rows that may add synapses: p/v [n, M] (post-reinforce),
    n_grow [n] > 0, each row's winner list wids [n, W]. Evicts the weakest
    occupied slots when free slots run short, then fills free slots
    ascending with the chosen winners ascending -> (p, v)."""
    n, M = p.shape
    W = wids.shape[1]
    dev = p.device
    # the winner loops run over blocks of the list to bound [n, M, b]
    wb = max(1, min(W, (1 << 26) // max(1, n * M)))

    def eligible(ws):  # valid winners not already presynaptic on the pre-eviction row
        return (ws < N) & ~(p[:, :, None] == ws[:, None, :]).any(1)

    # pass 1: eligible-winner count per row
    n_elig = torch.zeros(n, dtype=torch.int32, device=dev)
    for w0 in range(0, W, wb):
        n_elig += eligible(wids[:, w0:w0 + wb]).sum(-1, dtype=torch.int32)
    n_new = torch.minimum(n_elig, n_grow)

    # evict the weakest occupied synapses when free slots run short:
    # stable ascending rank by (permanence, slot), compare-count form
    occupied = p >= 0
    n_free = M - occupied.sum(-1, dtype=torch.int32)
    short = (n_new - n_free)[:, None]
    key = torch.where(occupied, v, float("inf"))
    slot = torch.arange(M, device=dev)
    ranks = torch.zeros((n, M), dtype=torch.int32, device=dev)
    for mp in range(M):
        kmp = key[:, mp:mp + 1]
        ranks += ((kmp < key) | ((kmp == key) & (mp < slot))).to(torch.int32)
    evict = occupied & (ranks < short)
    p_out = torch.where(evict, -1, p)
    v = torch.where(evict, 0.0, v)

    # pass 2: fill free slots ascending with chosen winners ascending
    free = p_out < 0
    frank = free.cumsum(-1, dtype=torch.int32) - free.to(torch.int32)  # 0-based among free
    fill = torch.zeros((n, M), dtype=torch.int32, device=dev)
    acc = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    for w0 in range(0, W, wb):
        ws = wids[:, w0:w0 + wb]
        elig = eligible(ws)  # [n, b]
        rank = acc + elig.cumsum(-1, dtype=torch.int32)  # 1-based among eligible
        acc = rank[:, -1:]
        chosen = elig & (rank <= n_grow[:, None])
        for m in range(M):
            hit = chosen & (rank - 1 == frank[:, m:m + 1])
            fill[:, m] = torch.where(hit.any(-1), torch.where(hit, ws, 0).sum(-1, dtype=torch.int32),
                                     fill[:, m])
    assign = free & (frank < n_new[:, None])
    return torch.where(assign, fill, p_out), torch.where(assign, p_init, v)


def _plain_rows(p, v, meta, g, ptable, atable, wids, cs: LearnConsts, K, N):
    """The pass on rows p [n, M] int32 / v [n, M] f32 with their meta
    words [n], of streams g [n] -> (presyn i32, perm f32, nsyn, conn, pot),
    the ``_mega_kernel`` stage list."""
    meta = meta[:, None]
    learn = (meta & 1) > 0
    alloc = ((meta >> 1) & 1) > 0
    grow = ((meta >> 2) & 1) > 0
    punish = ((meta >> 3) & 1) > 0
    n_grow = (meta >> 4)[:, 0]  # [n]

    # burst-new allocation: clear the allocated segment's slots
    p = torch.where(alloc, -1, p)
    v = torch.where(alloc, 0.0, v)

    # reinforce learning segments toward prev-active cells
    act = _active_in(p, g, ptable, K)
    exists = p >= 0
    x = v + cs.p_inc * act.to(torch.float32) - cs.p_dec * (exists & ~act).to(torch.float32)
    v = torch.where(learn, x.clamp(0.0, cs.p_one), v)

    # grow with eviction, on the growing rows only: a row whose grow flag
    # is off or whose n_grow <= 0 adds nothing and evicts nothing
    rows = (grow[:, 0] & (n_grow > 0)).nonzero(as_tuple=True)[0]
    if rows.numel():
        p[rows], v[rows] = _grow(p[rows], v[rows], n_grow[rows], wids[g[rows]], cs.p_init, N)

    # punish matching segments in non-active columns (pre-grow membership)
    if cs.pdec is not None:
        v = torch.where(punish & act, (v - cs.pdec).clamp(min=cs.p_zero), v)

    # synapse death at permanence <= 0, per-row occupancy
    dead = (p >= 0) & (v <= cs.p_zero)
    p = torch.where(dead, -1, p)
    nsyn = (p >= 0).sum(-1)

    # dendrite activity for t+1 on the updated pools
    dact = _active_in(p, g, atable, K)
    pot = dact.sum(-1)
    conn = (dact & (v >= cs.p_thr)).sum(-1)
    return p, v, nsyn, conn, pot


def _rows_needed(presyn: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Rows [G, R] that hold a synapse or carry a learn/alloc/grow/punish
    bit: on any other row every stage of the pass is a no-op and its counts
    are 0."""
    return (presyn >= 0).any(-1) | ((meta & 15) != 0)


def _check(presyn, perm, meta, pids, pmasks, wids, aids, amasks):
    G, R, M = presyn.shape
    if not 1 <= M <= 32:
        raise ValueError(f"tm_learn supports 1 <= M <= 32 synapse slots per segment, got {M}")
    if presyn.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"presyn must be int16 or int32, got {presyn.dtype}")
    if perm.dtype not in (torch.float32, torch.uint16, torch.uint8):
        raise TypeError(f"perm must be float32, uint16 or uint8, got {perm.dtype}")
    if perm.shape != presyn.shape or tuple(meta.shape) != (G, R):
        raise ValueError(f"shape mismatch: presyn {tuple(presyn.shape)}, perm "
                         f"{tuple(perm.shape)}, meta {tuple(meta.shape)}")
    for name, t in (("meta", meta), ("pids", pids), ("pmasks", pmasks), ("wids", wids),
                    ("aids", aids), ("amasks", amasks)):
        if t.dtype != torch.int32 or t.shape[0] != G:
            raise TypeError(f"{name} must be int32 with leading axis G={G}")
    for t in (presyn, perm, meta, pids, pmasks, wids, aids, amasks):
        if t.device != presyn.device:
            raise ValueError("all tm_learn tensors must be on one device")


def tm_learn_plain(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                   cs: LearnConsts, K: int, N: int):
    """Plain PyTorch version of the pass. Updates `presyn` [G, R, M] and
    `perm` [G, R, M] in place and returns (nsyn, conn, pot) uint8 [G, R].
    Like the kernel it reads and writes only the rows that
    :func:`_rows_needed` picks, in slices of streams so temporaries stay
    bounded at any G."""
    _check(presyn, perm, meta, pids, pmasks, wids, aids, amasks)
    G, R, M = presyn.shape
    C = N // K
    out = [torch.zeros((G, R), dtype=torch.uint8, device=presyn.device) for _ in range(3)]
    ptable, atable = _col_table(pids, pmasks, C), _col_table(aids, amasks, C)
    step = max(1, (1 << 24) // max(1, R * M))
    for g0 in range(0, G, step):
        s = slice(g0, g0 + step)
        g, r = _rows_needed(presyn[s], meta[s]).nonzero(as_tuple=True)
        g = g + g0
        # perm is indexed through its bit view: neither device indexes uint16
        v = as_bits(perm)[g, r].view(perm.dtype).to(torch.float32)
        p, v, *counts = _plain_rows(presyn[g, r].to(torch.int32), v, meta[g, r], g,
                                    ptable, atable, wids, cs, K, N)
        presyn[g, r] = p.to(presyn.dtype)
        # quantized domains hold integer-valued f32: the int32 hop is exact
        as_bits(perm)[g, r] = as_bits(v if perm.dtype == torch.float32
                                      else v.to(torch.int32).to(perm.dtype))
        for o, c in zip(out, counts):
            o[g, r] = c.to(torch.uint8)
    return tuple(out)


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """`t` as signed integers of its width, so that != compares bits (f32
    NaN and -0.0 included) and uint16 compares at all."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _pass_rows(args, presyn_after, perm_after):
    """Per row [G, R]: holds a synapse; needs its perm (a synapse or a
    learn/alloc/grow/punish bit); presyn changed; perm changed (bits
    compared)."""
    presyn, perm, meta = args[0], args[1], args[2]
    has_syn = (presyn >= 0).any(-1)
    needs_perm = _rows_needed(presyn, meta)
    presyn_changed = (as_bits(presyn_after) != as_bits(presyn)).any(-1)
    perm_changed = (as_bits(perm_after) != as_bits(perm)).any(-1)
    return has_syn, needs_perm, presyn_changed, perm_changed


def pass_bytes(args, presyn_after: torch.Tensor, perm_after: torch.Tensor) -> tuple[int, int]:
    """Bytes a pass must move on these inputs -> (data-dependent, full-row).

    `args` are the pass's arguments before it ran, (presyn, perm, meta,
    pids, pmasks, wids, aids, amasks); `presyn_after`/`perm_after` the pools
    after it. Data-dependent: every presyn and meta byte read; a row's perm
    read only if the row holds a synapse or has a learn/alloc/grow/punish
    bit; a row's presyn written only if the pass changed it, and its perm
    likewise, each pool on its own (death rewrites presyn alone, reinforce
    perm alone); the three uint8 counts written; the lists and winners read
    once. Full-row: every input read once, both pools written whole, the
    counts written."""
    presyn, perm, meta = args[0], args[1], args[2]
    G, R, M = presyn.shape
    ps, vs = presyn.element_size(), perm.element_size()
    counts = 3 * G * R
    lists = sum(t.numel() * t.element_size() for t in args[3:])
    full = (sum(t.numel() * t.element_size() for t in args)
            + presyn.numel() * ps + perm.numel() * vs + counts)
    _, needs_perm, presyn_changed, perm_changed = _pass_rows(args, presyn_after, perm_after)
    data = (presyn.numel() * ps + meta.numel() * meta.element_size() + lists + counts
            + int(needs_perm.sum()) * M * vs
            + int(presyn_changed.sum()) * M * ps + int(perm_changed.sum()) * M * vs)
    return data, full


def pass_occupancy(args, presyn_after: torch.Tensor, perm_after: torch.Tensor) -> dict:
    """What share of a pass's rows and slots the data fills and touches:
    rows changed (either pool), slots and rows holding a synapse, rows
    needing their perm, and the growing rows (grow bit, n_grow > 0) per
    stream."""
    presyn, meta = args[0], args[2]
    has_syn, needs_perm, presyn_changed, perm_changed = _pass_rows(args, presyn_after, perm_after)
    growing = ((((meta >> 2) & 1) > 0) & ((meta >> 4) > 0)).sum(1)
    return dict(rows_changed=(presyn_changed | perm_changed).double().mean().item(),
                slots_with_synapse=(presyn >= 0).double().mean().item(),
                rows_with_synapse=has_syn.double().mean().item(),
                rows_needing_perm=needs_perm.double().mean().item(),
                growing_rows_per_stream=[int(growing.min()), int(growing.max())])


_PRESYN_KIND = {torch.int16: 16, torch.int32: 32}
_PERM_KIND = {torch.float32: 0, torch.uint16: 16, torch.uint8: 8}


def _lib():
    from rtap_tpu_torch.ops._build import load

    lib = load("tm_learn")
    fn = lib.rtap_tm_learn
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci, ci] + [vp] * 11 + [ci] * 7 + [cf] * 7 + [ci, vp]
        fn.restype = ci
    return fn


def tm_learn_kernel(presyn, perm, meta, pids, pmasks, wids, aids, amasks,
                    cs: LearnConsts, K: int, N: int):
    """The pass on `presyn`/`perm` [G, R, M] in place -> (nsyn, conn, pot)
    uint8 [G, R]. CUDA tensors launch the kernel (counted in
    :data:`launches`); CPU tensors run :func:`tm_learn_plain`."""
    if presyn.device.type == "cpu":
        return tm_learn_plain(presyn, perm, meta, pids, pmasks, wids, aids, amasks, cs, K, N)
    if presyn.device.type != "cuda":
        raise ValueError(f"tm_learn runs on cuda or cpu tensors, got {presyn.device}")
    _check(presyn, perm, meta, pids, pmasks, wids, aids, amasks)
    if not 1 <= K <= 32:
        raise ValueError(f"tm_learn packs K <= 32 cells per column, got {K}")
    args = [presyn, perm, meta, pids, pmasks, wids, aids, amasks]
    if not all(t.is_contiguous() for t in args):
        raise ValueError("tm_learn needs contiguous tensors")
    G, R, M = presyn.shape
    out = [torch.empty((G, R), dtype=torch.uint8, device=presyn.device) for _ in range(3)]
    fn = _lib()
    err = fn(
        _PRESYN_KIND[presyn.dtype], _PERM_KIND[perm.dtype],
        *(t.data_ptr() for t in args), *(o.data_ptr() for o in out),
        G, R, M, K, N, wids.shape[1], pids.shape[1],
        cs.p_inc, cs.p_dec, cs.p_init, cs.p_one, cs.p_zero, cs.p_thr,
        0.0 if cs.pdec is None else cs.pdec, int(cs.pdec is not None),
        torch.cuda.current_stream(presyn.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tm_learn CUDA kernel failed to launch: cudaError {err}")
    count_launch()
    return tuple(out)


@dataclass
class LearnPass:
    """One learning tick's pass: the kernel's arguments and what the
    epilogue needs. ``args`` is (presyn, perm, meta, pids, pmasks, wids,
    aids, amasks) for ``tm_learn_kernel(*args, consts, K, N)``; presyn and
    perm are [G, R, M] views of the state's pools."""

    args: tuple
    consts: LearnConsts
    K: int
    N: int
    stamp: torch.Tensor  # bool [G, n_seg]: allocated + learned segments
    overflow: torch.Tensor  # bool [G]: a capacity truncation happened


def learn_pass(cfg, dom, presyn, syn_perm, seg_pot, matching_seg, learn_mask, alloc,
               active_cols, have_winners, pcol_ids, pcol_masks, p_cols, winner_ids,
               acol_ids, acol_masks) -> LearnPass:
    """The ``tm_learn_pallas`` prep, batched over G: the workspace
    truncation as per-row meta words. Pools are [G, C, K, S, M]."""
    G, C, K, S, M = presyn.shape
    L, Ac = cfg.learn_cap, cfg.col_cap
    n_seg = C * K * S
    dev = matching_seg.device
    alloc_col, bn_k, bn_s = alloc
    burst_new = alloc_col < C
    captured = active_cols & (active_cols.cumsum(-1) <= Ac)
    kk = torch.arange(K, device=dev)
    ss = torch.arange(S, device=dev)
    alloc_seg = (
        (burst_new & captured)[:, :, None, None]
        & (kk[None, None, :, None] == bn_k[:, :, None, None])
        & (ss[None, None, None, :] == bn_s[:, :, None, None])
    ).reshape(G, -1)
    ws_learn = ((learn_mask & captured[:, :, None, None]).reshape(G, -1)) | alloc_seg
    learn_trunc = ws_learn & (ws_learn.cumsum(-1) <= L)
    grow_seg = learn_trunc & have_winners[:, None]
    n_grow = cfg.new_synapse_count - torch.where(alloc_seg, 0, seg_pot.reshape(G, -1).to(torch.int32))
    if cfg.predicted_segment_decrement > 0.0:
        punish_seg = (matching_seg & ~active_cols[:, :, None, None]).reshape(G, -1)
    else:
        punish_seg = torch.zeros_like(learn_trunc)
    meta = (learn_trunc.to(torch.int32)
            | (alloc_seg.to(torch.int32) << 1)
            | (grow_seg.to(torch.int32) << 2)
            | (punish_seg.to(torch.int32) << 3)
            | (n_grow.clamp(min=0).to(torch.int32) << 4))
    # capacity overflow: truncated active set, truncated prev-active
    # packing, or more than learn_cap learners
    overflow = (active_cols.sum(-1) > Ac) | (p_cols > Ac) | (ws_learn.sum(-1) > L)
    args = (presyn.view(G, n_seg, M), syn_perm.view(G, n_seg, M), meta,
            pcol_ids, pcol_masks, winner_ids, acol_ids, acol_masks)
    return LearnPass(args, LearnConsts.from_config(cfg, dom), K, C * K,
                     alloc_seg | learn_trunc, overflow)


def tm_learn(lp: LearnPass, seg_last: torch.Tensor, it: torch.Tensor):
    """The whole TM learning pass for G streams (the ``tm_learn_pallas``
    counterpart): the pass on the pools in place, then the [C, K, S]-scale
    epilogue. Returns (seg_last' i32, conn, pot uint8), each [G, C, K, S]."""
    nsyn, conn, pot = tm_learn_kernel(*lp.args, lp.consts, lp.K, lp.N)
    # stamp alloc + learned segments, then empty-segment death after the sweep
    G = seg_last.shape[0]
    sl = torch.where(lp.stamp, it[:, None], seg_last.reshape(G, -1))
    sl = torch.where((sl >= 0) & (nsyn == 0), -1, sl)
    return sl.reshape(seg_last.shape), conn.reshape(seg_last.shape), pot.reshape(seg_last.shape)
