"""PyTorch port vs the JAX package: the model-health reducer and tracker.

* The reducer (ops/health.py) against JAX ``chunk_step(..., health=True)``
  and the numpy twin ``health_reduce_host``, in every permanence domain, on
  a half-live group (silent streams must not dilute the means). Tolerance:
  integer fields (histograms, ``scored``) exact; f32 fields at
  ``rtol=1e-5, atol=1e-6``, as the JAX package holds its own device
  reducer against its twin (the sums' order differs).
* The host tracker (obs/health.py): the JAX HealthTracker's events,
  scorecards and stats on the same leaf sequences; ``bump_run_epoch``
  writes the JAX package's ``<alerts>.epoch``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.obs.health import HealthTracker as JHealth
from rtap_tpu.obs.health import bump_run_epoch as j_bump
from rtap_tpu.obs.metrics import TelemetryRegistry as JRegistry
from rtap_tpu.ops.health_tpu import HEALTH_KEYS as J_KEYS
from rtap_tpu.ops.health_tpu import health_reduce_host
from rtap_tpu.ops.step import chunk_step as j_chunk_step
from rtap_tpu.ops.step import replicate_state as j_replicate
from rtap_tpu.models.state import init_state as j_init_state
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_from_numpy, state_to_numpy
from rtap_tpu_torch.obs.health import HealthTracker, bump_run_epoch
from rtap_tpu_torch.obs.metrics import TelemetryRegistry
from rtap_tpu_torch.ops.health import (
    HEALTH_KEYS,
    OCC_BINS,
    PERM_BINS,
    SCORE_BINS,
    health_reduce,
)
from rtap_tpu_torch.ops.step import chunk_step

torch.set_num_threads(1)

DOMAINS = {"u16": 16, "f32": 0, "u8": 8}
G = 6
RTOL, ATOL = 1e-5, 1e-6


def _cfgs(bits):
    j = j_scaled(32) if bits == 16 else j_scaled(32, perm_bits=bits)
    return j, ModelConfig.from_dict(j.to_dict())


def _feed(T, seed=0):
    """A half-live group: streams 3-5 never send, stream 1 goes silent."""
    rng = np.random.default_rng(seed)
    v = (30 + 8 * np.sin(np.arange(T) / 3.0)[:, None]
         + rng.normal(0, 2.0, (T, G))).astype(np.float32)
    v[:, 3:] = np.nan
    v[T // 2:, 1] = np.nan
    ts = (1_700_000_000 + np.arange(T, dtype=np.int64))[:, None].repeat(G, 1)
    return v[..., None], ts


def _assert_leaf_close(want: dict, got: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "i":
            assert np.array_equal(a, b), k
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=k)


def test_schema_matches_jax():
    from rtap_tpu.ops import health_tpu

    assert HEALTH_KEYS == J_KEYS
    assert (OCC_BINS, PERM_BINS, SCORE_BINS) == (health_tpu.OCC_BINS, health_tpu.PERM_BINS,
                                                 health_tpu.SCORE_BINS)


@pytest.mark.parametrize("domain", list(DOMAINS))
def test_health_leaves_match_jax_chunk_step(domain):
    jcfg, cfg = _cfgs(DOMAINS[domain])
    T = 24
    v, ts = _feed(T)
    single = j_init_state(jcfg, 0, include_fwd=False)
    jst = {k: jax.numpy.asarray(x) for k, x in j_replicate(single, G).items()}
    jst, (jraw, jleaf) = j_chunk_step(jst, jax.numpy.asarray(v),
                                      jax.numpy.asarray(ts.astype(np.int32)), jcfg,
                                      health=True)
    st = state_from_numpy(j_replicate(single, G), "cpu")
    got = []
    for lo in range(0, T, 8):
        st, (raw, leaf) = chunk_step(st, torch.from_numpy(v[lo:lo + 8]),
                                     torch.from_numpy(ts[lo:lo + 8].astype(np.int32)), cfg,
                                     health=True)
        got.append(leaf)
    leaf = {k: np.concatenate([g[k].numpy() for g in got]) for k in HEALTH_KEYS}
    _assert_leaf_close({k: np.asarray(x) for k, x in jleaf.items()}, leaf)
    # model state: the reducer only reads
    js = {k: np.asarray(x) for k, x in jax.device_get(jst).items()}
    ps = state_to_numpy(st)
    assert js.keys() == ps.keys()
    assert all(np.array_equal(js[k], ps[k], equal_nan=True) for k in js)
    # the silent streams dilute nothing: 2-3 live streams scored per tick
    assert leaf["scored"].max() == 3 and leaf["scored"][-1] == 2
    assert leaf["occ_hist"].sum(-1).max() <= 3
    assert leaf["perm_hist"][-1].sum() == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("domain", list(DOMAINS))
def test_health_reduce_matches_numpy_twin(domain):
    jcfg, cfg = _cfgs(DOMAINS[domain])
    v, ts = _feed(20, seed=3)
    single = j_init_state(jcfg, 0, include_fwd=False)
    st = state_from_numpy(j_replicate(single, G), "cpu")
    st, raw = chunk_step(st, torch.from_numpy(v), torch.from_numpy(ts.astype(np.int32)), cfg)
    want = health_reduce_host(state_to_numpy(st), raw[-1].numpy(), v[-1], jcfg)
    got = health_reduce(st, raw[-1], torch.from_numpy(v[-1]), cfg)
    _assert_leaf_close({k: np.asarray(x) for k, x in want.items()},
                       {k: x.numpy() for k, x in got.items()})
    assert int(got["scored"]) == 2


def _leaves(seed, T=200):
    """Health leaves of one group: a calm score distribution that walks to
    a new one (drift), a saturating pool, a sparsity collapse and an
    all-silent outage stretch."""
    rng = np.random.default_rng(seed)
    score_hist = np.zeros((T, 16), np.int32)
    for t in range(T):
        centre = 2 if t < 130 else 12
        score_hist[t] = np.bincount(np.clip(rng.normal(centre, 1.0, 40).astype(int), 0, 15),
                                    minlength=16)
    scored = np.full(T, 40, np.int32)
    scored[60:64] = 0
    score_hist[60:64] = 0
    occ = np.linspace(0.2, 0.97, T).astype(np.float32)
    act = np.full(T, 10 / 32, np.float32)
    act[90:100] = 0.01
    return {
        "occ_hist": np.tile(np.arange(8, dtype=np.int32), (T, 1)),
        "seg_occ_frac": occ,
        "syn_frac": (occ / 2).astype(np.float32),
        "perm_hist": np.tile(np.full(8, 0.125, np.float32), (T, 1)),
        "perm_conn_frac": np.full(T, 0.4, np.float32),
        "act_col_frac": act,
        "pred_cell_frac": np.full(T, 0.02, np.float32),
        "hit_num": rng.random(T).astype(np.float32) * 30,
        "hit_den": np.full(T, 40.0, np.float32),
        "score_hist": score_hist,
        "scored": scored,
    }


def test_health_tracker_matches_jax():
    from rtap_tpu.config import cluster_preset as j_cluster

    out = {}
    for pkg, (Tracker, Reg) in {"jax": (JHealth, JRegistry),
                                "torch": (HealthTracker, TelemetryRegistry)}.items():
        events = []
        cfg = j_cluster() if pkg == "jax" else ModelConfig.from_dict(j_cluster().to_dict())
        tr = Tracker(cfg, registry=Reg(), sink=events.append, drift_min_ticks=40)
        for gi in (0, 1):
            leaves = _leaves(gi)
            for lo in range(0, 200, 5):
                tr.fold(gi, {k: x[lo:lo + 5] for k, x in leaves.items()}, tick=lo + 4)
        out[pkg] = (events, tr.snapshot(), tr.stats())
    assert out["torch"] == out["jax"]
    kinds = {e["event"] for e in out["torch"][0]}
    assert kinds == {"pool_saturated", "sparsity_collapsed", "score_drift"}


@pytest.mark.parametrize("bad", [dict(occupancy_threshold=0.0), dict(sparsity_min_frac=1.0),
                                 dict(drift_threshold=1.5), dict(drift_min_ticks=0)])
def test_health_tracker_refuses_what_jax_refuses(bad):
    from rtap_tpu.config import cluster_preset as j_cluster

    with pytest.raises(ValueError) as je:
        JHealth(j_cluster(), registry=JRegistry(), **bad)
    with pytest.raises(ValueError) as te:
        HealthTracker(ModelConfig.from_dict(j_cluster().to_dict()),
                      registry=TelemetryRegistry(), **bad)
    assert str(te.value) == str(je.value)


def test_bump_run_epoch_matches_jax(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    reg = TelemetryRegistry()
    assert [bump_run_epoch(a, reg) for _ in range(3)] == [j_bump(b, JRegistry())
                                                         for _ in range(3)] == [1, 2, 3]
    assert json.loads((tmp_path / "a.jsonl.epoch").read_text())["epoch"] == 3
    snap = {m["name"]: m["value"] for m in reg.snapshot()["metrics"]}
    assert snap["rtap_obs_run_epoch"] == 3
    assert bump_run_epoch(None, reg) == 0  # nothing to persist beside
    (tmp_path / "a.jsonl.epoch").write_text("{torn")
    assert bump_run_epoch(a, reg) == 1  # a corrupt file restarts the count
