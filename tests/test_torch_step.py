"""PyTorch port vs the JAX package: the fused chunk step at full width.

The port's chunk_step (bind -> encode -> SP -> TM -> raw, T ticks over a G
axis) against the JAX chunk_step for the full-width cluster preset, G = 4,
T = 64: raw and every state leaf equal bit for bit. Repeated with a learning
cadence (learn every 3rd tick once a short maturity window has passed), so
both the learn and the infer branch of the cadence run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtap_tpu.config import cluster_preset
from rtap_tpu.models.state import init_state as j_init_state
from rtap_tpu.ops.step import chunk_step as j_chunk_step
from rtap_tpu.ops.step import replicate_state
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_from_numpy, state_to_numpy
from rtap_tpu_torch.ops.step import chunk_step

# xdist workers share the host's cores with each other and with JAX: one
# intra-op thread per worker keeps torch's OpenMP pool from oversubscribing them
torch.set_num_threads(1)


def _inputs(T, G, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None, None]
    vals = (40 + 15 * np.sin(2 * np.pi * t / (9 + np.arange(G))[None, :, None])
            + rng.normal(0, 1.0, (T, G, 1))).astype(np.float32)
    vals[0, 1, 0] = np.nan  # leading NaN: offset binds later
    vals[20:23, 2, 0] = np.nan  # a gap
    vals[40, 3, 0] += 60.0  # a spike
    ts = (1_700_000_000 + np.arange(T)[:, None] * np.ones((1, G))).astype(np.int32)
    return vals, ts


def _compare(jcfg, T=64, G=4, chunks=1):
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    vals, ts = _inputs(T, G)
    st_np = replicate_state(j_init_state(jcfg, seed=2, include_fwd=False), G)
    js = {k: jnp.asarray(v) for k, v in st_np.items()}
    st = state_from_numpy(st_np, "cpu")
    step = T // chunks
    for c in range(chunks):
        sl = slice(c * step, (c + 1) * step)
        js, jraw = j_chunk_step(js, jnp.asarray(vals[sl]), jnp.asarray(ts[sl]), jcfg)
        st, raw = chunk_step(st, torch.from_numpy(vals[sl]), torch.from_numpy(ts[sl]), cfg)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw), err_msg=f"raw chunk {c}")
    got = state_to_numpy(st)
    for k, v in js.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not got["tm_overflow"].any()


def test_chunk_step_cluster_preset_matches_jax():
    _compare(cluster_preset())


@pytest.mark.parametrize("chunks", [1, 2])
def test_chunk_step_learn_cadence_matches_jax(chunks):
    """learn_every=3 with a 16-tick maturity window: ticks 16.. alternate
    infer/infer/learn, and the host-side cadence branch must pick the same
    ticks as the JAX package's lax.cond on tm_iter (across chunk edges)."""
    _compare(cluster_preset().with_learn_every(3, full_until=16), chunks=chunks)


def test_group_step_matches_chunk_step():
    """group_step one tick at a time gives chunk_step's raw and state."""
    from rtap_tpu_torch.ops.step import group_step

    jcfg = cluster_preset()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    vals, ts = (a[:6] for a in _inputs(64, 4))
    st_np = replicate_state(j_init_state(jcfg, seed=2, include_fwd=False), 4)
    st_chunk, raw_chunk = chunk_step(state_from_numpy(st_np, "cpu"), torch.from_numpy(vals),
                                     torch.from_numpy(ts), cfg)
    st = state_from_numpy(st_np, "cpu")
    for t in range(6):
        st, raw = group_step(st, torch.from_numpy(vals[t]), torch.from_numpy(ts[t]), cfg)
        np.testing.assert_array_equal(raw.numpy(), raw_chunk[t].numpy(), err_msg=f"raw {t}")
    got, want = state_to_numpy(st), state_to_numpy(st_chunk)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
