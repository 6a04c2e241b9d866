"""PyTorch port vs the JAX package: tm_step.

The port's tm_step against the JAX tm_step on the branch-coverage sequences
of tests/parity/test_pallas_tm.py, learn and infer, with JAX in its default
mode (tests/test_torch_tm_pallas.py repeats the sequences with JAX in its
megakernel mode; tests/test_torch_tm_learn.py holds the learning pass
against the Pallas harness). Every TM leaf is compared every step, bit for
bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtap_tpu.ops.tm_tpu as jtm
from rtap_tpu.config import TMConfig as JTMConfig
from rtap_tpu_torch.config import TMConfig
from rtap_tpu_torch.ops.tm import _pack_active, tm_step
from rtap_tpu_torch.ops.tm_learn import presyn_active_packed

# xdist workers share the host's cores with each other and with JAX: one
# intra-op thread per worker keeps torch's OpenMP pool from oversubscribing them
torch.set_num_threads(1)

TM_KEYS = ("presyn", "syn_perm", "seg_last", "active_seg", "matching_seg",
           "seg_pot", "prev_active", "prev_winner", "tm_iter", "tm_overflow")


def port_cfg(jcfg: JTMConfig) -> TMConfig:
    return TMConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("K", [8, 32])
def test_presyn_active_packed_matches_jax(K):
    """The port's table form of packed membership (one gather per synapse)
    against the JAX package's compare-and-sum, incl. -1 slots and column 0."""
    rng = np.random.default_rng(K)
    C, Ac = 12, 5
    cells = rng.random((C, K)) < 0.3
    cells[0, K - 1] = True
    presyn = rng.integers(-1, C * K, (C, 2, 6)).astype(np.int32)
    ids, masks, n = jtm._pack_active(jnp.asarray(cells), Ac)
    want = np.asarray(jtm._presyn_active_packed(jnp.asarray(presyn), ids, masks, K))
    pids, pmasks, pn = _pack_active(torch.from_numpy(cells)[None], Ac)
    np.testing.assert_array_equal(pids[0].numpy(), np.asarray(ids))
    np.testing.assert_array_equal(pmasks[0].numpy(), np.asarray(masks))
    assert int(pn[0]) == int(n)
    got = presyn_active_packed(torch.from_numpy(presyn)[None], pids, pmasks, C, K)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def run_tm_steps(C, jcfg, seq, learn_flags=None):
    """Step JAX and the port (G = 1) through `seq`, comparing every leaf."""
    from tests.parity.test_tm_parity import _init_tm_state

    cfg = port_cfg(jcfg)
    host = _init_tm_state(C, jcfg)
    dev = jtm.to_kernel_layout({k: jnp.asarray(v) for k, v in host.items()})
    st = {k: torch.from_numpy(np.array(v, copy=True))[None] for k, v in host.items()}
    for step, cols in enumerate(seq):
        learn = True if learn_flags is None else learn_flags[step]
        active = np.zeros(C, bool)
        active[cols] = True
        dev, raw_j = jtm.tm_step(dev, jnp.asarray(active), jcfg, learn=learn)
        st, raw_t = tm_step(st, torch.from_numpy(active)[None], cfg, learn=learn)
        assert float(raw_t[0]) == float(raw_j), f"raw step {step}"
        ref = jtm.from_kernel_layout(dev, jcfg)
        for k in TM_KEYS:
            got = st[k][0].numpy()
            np.testing.assert_array_equal(got, np.asarray(ref[k]).astype(got.dtype),
                                          err_msg=f"{k} step {step}")


def _seq_repeating_and_novel():
    C = 64
    cfg = JTMConfig(cells_per_column=8, activation_threshold=3, min_threshold=2,
                    max_segments_per_cell=4, max_synapses_per_segment=12,
                    new_synapse_count=6, learn_cap=32, col_cap=6)
    rng = np.random.default_rng(11)
    pats = [rng.choice(C, size=5, replace=False) for _ in range(4)]
    return C, cfg, pats * 8 + [rng.choice(C, size=5, replace=False) for _ in range(24)]


def _seq_eviction_and_punish():
    C = 32
    cfg = JTMConfig(cells_per_column=4, activation_threshold=2, min_threshold=1,
                    max_segments_per_cell=2, max_synapses_per_segment=6,
                    new_synapse_count=4, predicted_segment_decrement=0.02, learn_cap=32,
                    col_cap=5)
    rng = np.random.default_rng(23)
    X, Y = (rng.choice(C, size=4, replace=False) for _ in range(2))
    Y2 = Y.copy()
    Y2[:2] = rng.choice(C, size=2, replace=False)
    seq = [rng.choice(C, size=4, replace=False) for _ in range(60)]
    return C, cfg, seq + ([X, Y] * 6 + [X, Y2] * 6) * 2


def _seq_edge_columns():
    C = 16
    cfg = JTMConfig(cells_per_column=4, activation_threshold=2, min_threshold=1,
                    max_segments_per_cell=2, max_synapses_per_segment=6,
                    new_synapse_count=4, learn_cap=80, col_cap=16)
    rng = np.random.default_rng(3)
    seq = [rng.choice(C, 3, replace=False), np.arange(C), np.array([], np.int64),
           rng.choice(C, 3, replace=False), np.arange(C)] * 4
    return C, cfg, seq


SEQS = {"repeating_and_novel": _seq_repeating_and_novel,
        "eviction_and_punish": _seq_eviction_and_punish,
        "edge_columns": _seq_edge_columns}


@pytest.mark.parametrize("seq", list(SEQS))
def test_tm_step_matches_jax(seq):
    """JAX in its default mode (tests/test_torch_tm_pallas.py: megakernel mode)."""
    run_tm_steps(*SEQS[seq]())


def test_tm_step_infer_matches_jax():
    """Learn a repeating sequence, then infer on it: the plain dendrite pass
    against the JAX inference step."""
    C, jcfg, s = _seq_repeating_and_novel()
    run_tm_steps(C, jcfg, s[:40] + s[:12], [True] * 40 + [False] * 12)
