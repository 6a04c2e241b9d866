"""PyTorch port vs the JAX package: the Spatial Pooler.

The port's batched sp_step (G streams on a leading axis) against
``jax.vmap`` of the JAX sp_step, tick by tick, in the sparse member-index
layout (the cluster preset's) and the dense layout, in the f32, u16 and u8
permanence domains, learning and inferring. Bit-exact, except one stated
case: with boost_strength > 0 the boost factors come from ``exp``, which may
differ by 1 ulp between libm and XLA, so boost is compared within 1 ulp
(and the winners, which read it, must still be equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtap_tpu.config import cluster_preset, dense_cluster_preset
from rtap_tpu.models.state import init_state as j_init_state
from rtap_tpu.ops.sp_tpu import sp_step as j_sp_step
from rtap_tpu_torch import config as pconfig
from rtap_tpu_torch.ops.sp import sp_step

# xdist workers share the host's cores with each other and with JAX: one
# intra-op thread per worker keeps torch's OpenMP pool from oversubscribing them
torch.set_num_threads(1)

SP_KEYS = ("perm", "boost", "overlap_duty", "active_duty", "sp_iter")


def _sp_state(jcfg, G):
    keys = ("members", "potential") + SP_KEYS
    sts = [j_init_state(jcfg, seed=s, include_fwd=False) for s in range(G)]
    return {k: np.stack([np.asarray(s[k]) for s in sts]) for k in keys if k in sts[0]}


def _run(jcfg, T=40, G=3, learn_ticks=30, boost_ulp=0):
    cfg = pconfig.ModelConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(7)
    n_in = jcfg.input_size
    # RDSE-like inputs: a drifting window of active bits plus noise
    sdr = rng.random((T, G, n_in)) < 0.05
    for t in range(T):
        sdr[t, :, (3 * t) % (n_in - 12):(3 * t) % (n_in - 12) + 11] = True
    st_np = _sp_state(jcfg, G)
    js = {k: jnp.asarray(v) for k, v in st_np.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in st_np.items()}
    fns = {lrn: jax.jit(jax.vmap(lambda s, x, lrn=lrn: j_sp_step(s, x, jcfg.sp, lrn)))
           for lrn in (True, False)}
    for t in range(T):
        learn = t < learn_ticks
        js, jact = fns[learn](js, jnp.asarray(sdr[t]))
        ts, act = sp_step(ts, torch.from_numpy(sdr[t]), cfg.sp, learn)
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact), err_msg=f"active t={t}")
        for k in SP_KEYS:
            got, want = ts[k].numpy(), np.asarray(js[k])
            assert got.dtype == want.dtype, k
            if k == "boost" and boost_ulp:
                np.testing.assert_array_max_ulp(got, want, maxulp=boost_ulp)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{k} t={t}")


@pytest.mark.parametrize("perm_bits", [16, 0, 8])
def test_sparse_sp_matches_jax(perm_bits):
    _run(cluster_preset(perm_bits=perm_bits))


@pytest.mark.parametrize("perm_bits", [0, 16])
def test_dense_sp_matches_jax(perm_bits):
    _run(dense_cluster_preset(perm_bits=perm_bits), T=25, learn_ticks=18)


def test_sparse_sp_with_boost_matches_jax_within_one_ulp():
    base = cluster_preset()
    jcfg = dataclasses.replace(
        base, sp=dataclasses.replace(base.sp, boost_strength=2.0, duty_cycle_period=20))
    _run(jcfg, T=40, learn_ticks=40, boost_ulp=1)
