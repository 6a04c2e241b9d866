"""PyTorch port vs the JAX package: the TM learning pass.

The port's learning pass (ops/tm_learn.learn_pass + tm_learn, which on CPU
tensors runs tm_learn_plain) against the JAX package's Pallas harness tm_learn_pallas in
interpret mode, on random pools with empty slots, the column-0 sentinel
case and K = 32 (negative int32) masks, in the f32, u16 and u8 domains.
All six outputs are compared bit for bit; the port runs the three streams
of a case as one G = 3 batch, JAX vmaps its single-stream harness.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtap_tpu.ops.tm_tpu as jtm
from rtap_tpu.config import TMConfig as JTMConfig
from rtap_tpu.models.perm import tm_domain as j_tm_domain
from rtap_tpu.ops.pallas_tm import tm_learn_pallas
from rtap_tpu_torch.config import TMConfig
from rtap_tpu_torch.models.perm import tm_domain
from rtap_tpu_torch.ops.tm import _pack_active, _winner_id_list
from rtap_tpu_torch.ops.tm_learn import LearnConsts, learn_pass, tm_learn, tm_learn_kernel

# xdist workers share the host's cores with each other and with JAX: one
# intra-op thread per worker keeps torch's OpenMP pool from oversubscribing them
torch.set_num_threads(1)

PERM_NP = {0: np.float32, 16: np.uint16, 8: np.uint8}
KEYS = ("presyn", "perm", "seg_last", "seg_pot", "matching", "learn_mask", "active",
        "alloc_col", "bn_k", "bn_s", "have_winners", "it", "prev_active", "winner",
        "cur_active")


def _learn_case(rng, C, K, S, M, Ac, perm_bits, col0_sentinel):
    """One stream's random learning-pass inputs (numpy), consistent with the
    shapes and id conventions the JAX harness takes."""
    N = C * K
    one = {0: 1.0, 16: 65535, 8: 255}[perm_bits]
    presyn = rng.integers(0, N, (C, K, S, M)).astype(np.int16)
    presyn[rng.random((C, K, S, M)) < 0.35] = -1  # empty slots
    if perm_bits:
        perm = rng.integers(0, one + 1, (C, K, S, M)).astype(PERM_NP[perm_bits])
        perm[rng.random(perm.shape) < 0.2] = one // 2  # ties for the eviction rank
    else:
        perm = rng.choice(np.linspace(0, 1, 41, dtype=np.float32), (C, K, S, M))
    perm[rng.random(perm.shape) < 0.05] = 0
    perm = np.where(presyn >= 0, perm, 0).astype(PERM_NP[perm_bits])
    seg_last = rng.integers(-1, 50, (C, K, S)).astype(np.int32)
    seg_pot = rng.integers(0, M + 1, (C, K, S)).astype(np.int32)
    matching = rng.random((C, K, S)) < 0.3
    learn_mask = rng.random((C, K, S)) < 0.15
    active = rng.random(C) < (Ac + 1) / C  # sometimes more than Ac: overflow
    alloc_col = np.where(active & (rng.random(C) < 0.5), np.arange(C), C).astype(np.int32)
    bn_k = rng.integers(0, K, C).astype(np.int32)
    bn_s = rng.integers(0, S, C).astype(np.int32)

    def packed(force_col0):
        cols = np.sort(rng.choice(C, size=rng.integers(1, Ac + 1), replace=False))
        if force_col0:
            cols[0] = 0
            cols = np.unique(cols)
        cells = np.zeros((C, K), bool)
        cells[cols] = rng.random((len(cols), K)) < 0.5
        cells[cols, rng.integers(0, K, len(cols))] = True
        if K == 32:
            cells[cols[0], 31] = True  # bit 31: a negative int32 mask
        return cells

    prev_active = packed(col0_sentinel)
    cur_active = packed(col0_sentinel)
    winner = packed(False)
    if col0_sentinel:
        # empty slots in segments whose packed-active set holds column 0
        presyn[0, :, :, : M // 2] = -1
        presyn[:, 0, 0, 0] = -1
    return dict(presyn=presyn, perm=perm, seg_last=seg_last, seg_pot=seg_pot,
                matching=matching, learn_mask=learn_mask, active=active,
                alloc_col=alloc_col, bn_k=bn_k, bn_s=bn_s, prev_active=prev_active,
                cur_active=cur_active, winner=winner,
                have_winners=bool(winner.any()), it=np.int32(77))


def _run_jax_learn(jcfg, cases):
    dom = j_tm_domain(jcfg)
    Ac = jcfg.col_cap

    def one(presyn, perm, seg_last, seg_pot, matching, learn_mask, active, alloc_col,
            bn_k, bn_s, have_winners, it, prev_active, winner, cur_active):
        pids, pmasks, p_cols = jtm._pack_active(prev_active, Ac)
        aids, amasks, _ = jtm._pack_active(cur_active, Ac)
        return tm_learn_pallas(
            jcfg, dom, presyn, perm, seg_last, seg_pot, matching, learn_mask,
            (alloc_col, bn_k, bn_s), active, have_winners, it, pids, pmasks, p_cols,
            jtm._winner_id_list(winner, Ac), aids, amasks, interpret=True)

    out = jax.jit(jax.vmap(one))(*(jnp.asarray(_stack_np(cases, k)) for k in KEYS))
    return [np.asarray(o) for o in out]


def _stack_np(cases, key):
    return np.stack([np.asarray(c[key]) for c in cases])


def _run_port_learn(cfg, cases):
    t = {k: torch.from_numpy(_stack_np(cases, k)) for k in KEYS}
    Ac = cfg.col_cap
    pids, pmasks, p_cols = _pack_active(t["prev_active"], Ac)
    aids, amasks, _ = _pack_active(t["cur_active"], Ac)
    alloc = tuple(t[k].to(torch.int64) for k in ("alloc_col", "bn_k", "bn_s"))
    lp = learn_pass(
        cfg, tm_domain(cfg), t["presyn"], t["perm"], t["seg_pot"], t["matching"],
        t["learn_mask"], alloc, t["active"], t["have_winners"], pids, pmasks, p_cols,
        _winner_id_list(t["winner"], Ac), aids, amasks)
    seg_last, conn, pot = tm_learn(lp, t["seg_last"], t["it"])
    # the pass updates the pools in place
    return t["presyn"], t["perm"], seg_last, conn, pot, lp.overflow


@pytest.mark.parametrize("perm_bits", [0, 16, 8])
@pytest.mark.parametrize("K,S,M,Ac", [
    (8, 3, 12, 6),   # cluster-like geometry
    (32, 2, 8, 2),   # K = 32: negative packed masks
])
def test_tm_learn_plain_matches_pallas_interpret(perm_bits, K, S, M, Ac):
    C = 16
    jcfg = JTMConfig(cells_per_column=K, activation_threshold=3, min_threshold=2,
                     max_segments_per_cell=S, max_synapses_per_segment=M,
                     new_synapse_count=5, learn_cap=24, col_cap=Ac,
                     predicted_segment_decrement=0.05, perm_bits=perm_bits)
    cfg = TMConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(1000 + 10 * K + perm_bits)
    # stream 0 has no forced column 0; streams 1-2 hold the sentinel case
    cases = [_learn_case(rng, C, K, S, M, Ac, perm_bits, col0) for col0 in (False, True, True)]
    want = _run_jax_learn(jcfg, cases)
    got = _run_port_learn(cfg, cases)
    assert got[0].dtype == torch.int16 and got[1].dtype == torch.from_numpy(cases[0]["perm"]).dtype
    n_seg = C * K * S
    names = ("presyn", "perm", "seg_last", "conn", "pot", "overflow")
    for name, a, b in zip(names, got, want):
        a = a.numpy().reshape(b.shape)
        if name == "perm":
            a = a.astype(np.float32)  # the harness returns domain values as f32
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    assert want[0].shape == (3, n_seg, M)


def test_tm_learn_kernel_wrapper_refuses_and_counts_only_launches():
    """CPU tensors run the plain version and count no launch; a device the
    kernel does not take raises instead of falling back."""
    import rtap_tpu_torch.ops.tm_learn as tl

    tl.reset_launches()
    G, R, M = 1, 4, 6
    args = [torch.full((G, R, M), -1, dtype=torch.int16), torch.zeros((G, R, M)),
            torch.zeros((G, R), dtype=torch.int32)] + [torch.zeros((G, 2), dtype=torch.int32)] * 5
    cs = LearnConsts(0.1, 0.1, 0.21, 1.0, 0.0, 0.5, None)
    nsyn, conn, pot = tm_learn_kernel(*args, cs, 4, 8)
    assert tl.launches == 0 and int(nsyn.sum()) == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        tm_learn_kernel(*[a.to("meta") for a in args], cs, 4, 8)
    with pytest.raises(ValueError, match="M <= 32"):
        tm_learn_kernel(torch.zeros((1, 2, 33), dtype=torch.int16), torch.zeros((1, 2, 33)),
                        *args[2:], cs, 4, 8)
