"""PyTorch port vs the JAX package: the predictive horizon.

* The reducer (ops/predict.py): leaves and state bit-exact against JAX
  ``chunk_step(..., predict=True)`` and against the numpy twin
  ``predict_update_host``, in every permanence domain, tick by tick and in
  chunks; a claimed slot's warm-up bit-exact against the JAX group's.
* The host side: PredictTracker + BlastFuser give the JAX package's events
  and snapshots on the same leaf sequences; ``scan_event_ids`` its ids.
* The cascade eval (``python -m rtap_tpu_torch.predict_eval``) on the CPU:
  the same page tick, first-precursor ticks and blast radius as the JAX
  package's ``scripts/predict_eval.py`` on the same seed.

Tolerance: bit-exact everywhere (f32 with a power-of-two alpha).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.models.oracle.predict import predict_update_host
from rtap_tpu.models.state import init_state as j_init_state
from rtap_tpu.ops.step import chunk_step as j_chunk_step
from rtap_tpu.ops.step import replicate_state as j_replicate
from rtap_tpu.predict import BlastFuser as JBlast
from rtap_tpu.predict import PredictTracker as JTracker
from rtap_tpu.correlate import TopologyMap as JTopo
from rtap_tpu.service.alerts import scan_event_ids as j_scan_event_ids
from rtap_tpu.service.registry import StreamGroup as JGroup
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.correlate import TopologyMap
from rtap_tpu_torch.models.state import init_state, state_from_numpy, state_to_numpy
from rtap_tpu_torch.obs.metrics import TelemetryRegistry
from rtap_tpu_torch.ops.predict import PRED_ALPHA, PREDICT_KEYS, predict_update
from rtap_tpu_torch.ops.step import chunk_step, group_step
from rtap_tpu_torch.predict import BlastFuser, PredictTracker
from rtap_tpu_torch.service.alerts import scan_event_ids
from rtap_tpu_torch.service.registry import StreamGroup

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = {"u16": 16, "f32": 0, "u8": 8}
G, K_H = 5, 3


def _cfgs(bits):
    j = j_scaled(32) if bits == 16 else j_scaled(32, perm_bits=bits)
    return j, ModelConfig.from_dict(j.to_dict())


def _feed(T, seed=0):
    """[T, G, 1] values with a silent stream and a gap, and [T, G] ts."""
    rng = np.random.default_rng(seed)
    v = (30 + 8 * np.sin(np.arange(T) / 3.0)[:, None]
         + rng.normal(0, 2.0, (T, G))).astype(np.float32)
    v[10:20] += 40.0 * (rng.random(v[10:20].shape) < 0.3)  # unpredictable jumps
    v[:, 4] = np.nan  # silent: never scored
    v[6:9, 1] = np.nan  # a gap: unscored, the EWMA holds
    ts = (1_700_000_000 + np.arange(T, dtype=np.int64))[:, None].repeat(G, 1)
    return v[..., None], ts


def _assert_tree_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k


@pytest.mark.parametrize("domain", list(DOMAINS))
def test_predict_leaves_match_jax_chunk_step(domain):
    jcfg, cfg = _cfgs(DOMAINS[domain])
    T = 30
    v, ts = _feed(T)
    single = j_init_state(jcfg, 0, include_fwd=False, predict_horizon=K_H)
    jst = {k: jax.numpy.asarray(x) for k, x in j_replicate(single, G).items()}
    pst = state_from_numpy(j_replicate(single, G), "cpu")
    assert pst["pred_ring"].shape == (G, K_H, cfg.sp.columns)
    # the JAX chunk in two scans; the port tick by tick and in chunks of 5
    jleaves = []
    for lo, hi in ((0, 12), (12, T)):
        jst, (jraw, jl) = j_chunk_step(jst, jax.numpy.asarray(v[lo:hi]),
                                       jax.numpy.asarray(ts[lo:hi].astype(np.int32)), jcfg,
                                       predict=True)
        jleaves.append({k: np.asarray(x) for k, x in jl.items()})
    jleaf = {k: np.concatenate([j[k] for j in jleaves]) for k in PREDICT_KEYS}
    for how in ("tick", "chunk"):
        st = state_from_numpy(j_replicate(single, G), "cpu")
        got = []
        if how == "tick":
            for t in range(T):
                st, (_, leaf) = group_step(st, torch.from_numpy(v[t]),
                                           torch.from_numpy(ts[t].astype(np.int32)), cfg,
                                           predict=True)
                got.append({k: x[None].numpy() for k, x in leaf.items()})
        else:
            for lo in range(0, T, 5):
                st, (_, leaf) = chunk_step(st, torch.from_numpy(v[lo:lo + 5]),
                                           torch.from_numpy(ts[lo:lo + 5].astype(np.int32)),
                                           cfg, predict=True)
                got.append({k: x.numpy() for k, x in leaf.items()})
        leaf = {k: np.concatenate([g[k] for g in got]) for k in PREDICT_KEYS}
        _assert_tree_equal(jleaf, leaf)
        _assert_tree_equal({k: np.asarray(x) for k, x in jax.device_get(jst).items()},
                           state_to_numpy(st))
    assert jleaf["scored"].any() and not jleaf["scored"][:, 4].any()
    assert not jleaf["scored"][:K_H].any()  # the warm-up horizon
    assert np.isfinite(jleaf["miss_ewma"][-1, :4]).all()


@pytest.mark.parametrize("domain", list(DOMAINS))
def test_predict_update_matches_numpy_twin(domain):
    """One update on a post-step state, against ``predict_update_host``."""
    jcfg, cfg = _cfgs(DOMAINS[domain])
    v, ts = _feed(14, seed=1)
    st = state_from_numpy({k: np.broadcast_to(x, (G, *np.shape(x))).copy()
                           for k, x in init_state(cfg, 0, K_H).items()}, "cpu")
    st, _ = chunk_step(st, torch.from_numpy(v[:13]), torch.from_numpy(ts[:13].astype(np.int32)),
                       cfg, predict=True)
    st, _ = group_step(st, torch.from_numpy(v[13]), torch.from_numpy(ts[13].astype(np.int32)),
                       cfg)  # the step alone: the predictor folds tick 13 below
    host = state_to_numpy(st)
    want_state, want_leaf = predict_update_host(host, v[13], jcfg)
    got_state, got_leaf = predict_update(st, torch.from_numpy(v[13]), cfg, 13)
    _assert_tree_equal({k: np.asarray(x) for k, x in want_leaf.items()},
                       {k: x.numpy() for k, x in got_leaf.items()})
    _assert_tree_equal({k: np.asarray(x) for k, x in want_state.items()},
                       state_to_numpy(got_state))


def test_claimed_slot_warm_up_matches_jax():
    """A slot released and claimed mid-run restarts its predictor warm-up
    at the group's tick (``pred_tick0``). Claiming slot 0 also restarts
    stream 0's ``tm_iter``, the predictor's tick clock, as in the JAX group:
    the claimed slots stay unscored until that clock passes their warm-up."""
    jcfg, cfg = _cfgs(16)
    v, ts = _feed(24, seed=2)
    ids = [f"s{i}" for i in range(G)]
    jg = JGroup(jcfg, ids, backend="tpu", predict=K_H)
    pg = StreamGroup(cfg, ids, device="cpu", predict=K_H)
    for lo, hi in ((0, 8), (8, 16), (16, 24)):
        if lo == 8:
            for grp in (jg, pg):
                grp.release_slot("s0")  # slot 0: stream 0's tm_iter restarts
                grp.release_slot("s2")
                assert grp.claim_slot("late0") == 0 and grp.claim_slot("late2") == 2
        jr = jg.run_chunk(v[lo:hi], ts[lo:hi])
        pr = pg.run_chunk(v[lo:hi], ts[lo:hi])
        for a, b in zip(jr, pr):
            assert np.array_equal(a, b)
        _assert_tree_equal({k: np.asarray(x) for k, x in jg.last_predict.items()},
                           pg.last_predict)
        if lo == 8:
            mid = pg.last_predict
    _assert_tree_equal({k: np.asarray(x) for k, x in jax.device_get(jg.state).items()},
                       state_to_numpy(pg.state))
    assert int(pg.state["pred_tick0"][0]) == int(pg.state["pred_tick0"][2]) == 8
    assert not mid["scored"][:, [0, 2]].any() and mid["scored"][:, 1].any()


def _leaf_sequence(seed, T=60, G_=6):
    """Per-tick predict leaves: calm streams, one ramping stream, a gap."""
    rng = np.random.default_rng(seed)
    ewma = np.clip(0.05 + 0.05 * rng.random((T, G_)), 0, 1).astype(np.float32)
    ewma[20:45, 1] = np.linspace(0.1, 0.8, 25)  # a sustained divergence
    ewma[45:, 1] = 0.05  # recovered: re-arms
    ewma[30:50, 3] = 0.6
    scored = np.ones((T, G_), bool)
    scored[:5] = False
    scored[33:36, 3] = False  # a source gap holds the run
    ewma[~scored] = np.nan
    overlap = np.where(scored, 1 - ewma, np.nan).astype(np.float32)
    return {"overlap": overlap, "miss_ewma": ewma,
            "pred_col_frac": np.full((T, G_), 0.04, np.float32), "scored": scored}


def test_predict_tracker_and_blast_fuser_match_jax():
    from rtap_tpu.obs.metrics import TelemetryRegistry as JRegistry

    spec = {"services": {"web": ["web-00", "web-01", "web-02"]}}
    ids = ["web-00.cpu", "web-01.cpu", "__pad0", "web-02.mem", "web-02.cpu", "x-00.cpu"]
    out = {}
    for pkg, (Tracker, Blast, Topo, Reg) in {
            "jax": (JTracker, JBlast, JTopo, JRegistry),
            "torch": (PredictTracker, BlastFuser, TopologyMap, TelemetryRegistry)}.items():
        events = []
        tr = Tracker(horizon=4, threshold=0.35, min_ticks=3, warmup_ticks=8,
                     registry=Reg(), sink=events.append,
                     blast=Blast(Topo.from_spec(spec), seed_streams=ids))
        tr.arm_suppression(["precursor:web-02.mem:32"])  # already on disk
        leaves = _leaf_sequence(7)
        for lo in range(0, 60, 6):  # chunks of 6 ticks on the group-tick clock
            tr.fold(0, {k: x[lo:lo + 6] for k, x in leaves.items()}, tick=lo + 5, ids=ids)
        tr.fold(1, {k: x[:1] for k, x in _leaf_sequence(8).items()}, tick=0,
                ids=[f"b{i}.cpu" for i in range(6)])
        out[pkg] = (events, tr.snapshot(), tr.stats())
    assert out["torch"] == out["jax"]
    kinds = [e["event"] for e in out["torch"][0]]
    assert "precursor" in kinds and "predicted_incident" in kinds
    assert out["torch"][2]["events_suppressed"] == 1


def test_schema_matches_jax():
    from rtap_tpu.models.oracle import predict as j_predict

    assert PREDICT_KEYS == j_predict.PREDICT_KEYS and PRED_ALPHA == j_predict.PRED_ALPHA
    assert type(PRED_ALPHA) is type(j_predict.PRED_ALPHA)


def test_scan_event_ids_matches_jax(tmp_path):
    p = tmp_path / "alerts.jsonl"
    p.write_text("\n".join([
        json.dumps({"alert_id": "0:a:1", "stream": "a"}),
        json.dumps({"event": "precursor", "alert_id": "precursor:a:3"}),
        json.dumps({"event": "predicted_incident", "alert_id": "predicted_incident:w:3"}),
        json.dumps({"event": "incident", "alert_id": "x"}),
        '{"event": "precursor", "alert_id": "torn',
    ]) + "\n")
    for off in (0, 20):
        assert scan_event_ids(str(p), off) == j_scan_event_ids(str(p), off)
    assert scan_event_ids(str(p)) == {"precursor:a:3", "predicted_incident:w:3"}


def test_cascade_eval_matches_jax_on_cpu(tmp_path):
    """The port's cascade eval at the JAX script's defaults (2 services x 3
    nodes, cpu + mem, 400 ticks, seed 0, horizon 8, threshold 0.35, min 12
    ticks) pages at the JAX package's tick with its blast radius."""
    from rtap_tpu_torch.predict_eval import main

    env = {**os.environ, "RTAP_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu"}
    jax_out = tmp_path / "jax.json"
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "scripts", "predict_eval.py"),
                             "--out", str(jax_out)], cwd=str(tmp_path), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    port_out = tmp_path / "port.json"
    rc = main(["--device", "cpu", "--out", str(port_out)])
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    assert rc == 0
    want = json.loads(jax_out.read_text())["score"]
    got = json.loads(port_out.read_text())
    assert got["verified"] and got["device"] == "cpu"
    assert got["score"] == want
    assert want["win"] and want["blast_covered"] and want["false_precursors"] == 0
    assert got["score"]["page_tick"] < got["scenario"]["burst_onsets"]["svca-01"]


def test_cascade_eval_workdir_mode_scores_the_alert_file(tmp_path, capsys):
    """``--workdir`` (alerts, checkpoints, the journal and the topology
    correlator, as the card's kill drill runs it) pages exactly as the
    in-memory run: the score read back from the alert file is the same."""
    from rtap_tpu_torch.predict_eval import main

    argv = ["--device", "cpu", "--ticks", "240", "--precursor-ticks", "60"]
    assert main([*argv, "--out", str(tmp_path / "mem.json")]) in (0, 5)
    assert main([*argv, "--workdir", str(tmp_path / "w"), "--out",
                 str(tmp_path / "disk.json")]) in (0, 5)
    capsys.readouterr()
    mem, disk = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("mem", "disk"))
    assert disk["score"] == mem["score"] and mem["score"]["paged"]
    assert disk["resumed_at_tick"] == 0 and disk["ticks_run"] == 240
    assert sorted(os.listdir(tmp_path / "w" / "ck")) == ["group0000"]
    assert "incidents" in disk and os.path.exists(tmp_path / "w" / "alerts.jsonl.corr")
