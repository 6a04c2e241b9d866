"""PyTorch port vs the JAX package: the multivariate node eval.

* ``generate_node``: the same values, timestamps, windows, events and
  touched metrics over seeds, node ids, ``coupled_frac`` and
  ``fault_metrics`` (the rng draws in a fixed order: a reordered draw gives
  plausible but different streams).
* ``run_node_eval``: the JAX package's ``scripts/node_eval.py`` has no
  function to call, so its computation is rebuilt here from the JAX
  ``StreamGroup`` and the script's scoring; the port's log-likelihood is
  array-equal and its shapes dict equal. The config is node_preset(3) at
  full width with a 60-tick probation, so that the faults past mid-stream
  are scored after it, at 3 nodes x 400 ticks.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rtap_tpu.config import node_preset as j_node_preset
from rtap_tpu.data.synthetic import SyntheticStreamConfig as JSynCfg
from rtap_tpu.data.synthetic import generate_node as j_generate_node
from rtap_tpu.service.registry import StreamGroup as JGroup
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_node
from rtap_tpu_torch.eval import node_eval

torch.set_num_threads(1)

NODES, LENGTH = 3, 400


def _scfg(cls, **kw):
    base = dict(length=500, cadence_s=1.0, n_anomalies=4, kinds=("spike", "level_shift", "dropout"),
                anomaly_magnitude=6.0, noise_phi=0.97, noise_scale=0.5, inject_after_frac=0.4)
    return cls(**{**base, **kw})


@pytest.mark.parametrize("seed,node,kw", [
    (100, "node00000", {}),
    (7, "node00042", dict(coupled_frac=0.0)),
    (8, "n-1", dict(coupled_frac=1.0, metrics=("cpu", "mem", "net", "disk_io"))),
    (9, "node00003", dict(fault_metrics=("cpu", "mem"))),
    (10, "node00004", dict(coupled_frac=0.3, metrics=("latency_ms", "net"))),
])
def test_generate_node_as_jax(seed, node, kw):
    want = j_generate_node(node, _scfg(JSynCfg), seed=seed, **kw)
    got = generate_node(node, _scfg(SyntheticStreamConfig), seed=seed, **kw)
    assert (got.node_id, got.metrics) == (want.node_id, want.metrics)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values.dtype == want.values.dtype == np.float32
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.windows == want.windows and len(got.windows) == 4
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert got.event_metrics == want.event_metrics


@pytest.mark.parametrize("kw", [dict(length=120, inject_after_frac=0.7),
                                dict(fault_metrics=("gpu",)), dict(fault_metrics=())])
def test_generate_node_refusals_as_jax(kw):
    cfg_kw = {k: v for k, v in kw.items() if k != "fault_metrics"}
    fm = {"fault_metrics": kw["fault_metrics"]} if "fault_metrics" in kw else {}
    with pytest.raises(ValueError) as want:
        j_generate_node("a", _scfg(JSynCfg, **cfg_kw), **fm)
    with pytest.raises(ValueError) as got:
        generate_node("a", _scfg(SyntheticStreamConfig, **cfg_kw), **fm)
    assert str(got.value) == str(want.value)


def _short(cfg):
    return dataclasses.replace(cfg, likelihood=dataclasses.replace(
        cfg.likelihood, learning_period=60, estimation_samples=40))


def _jax_node_eval(cfg, nodes, length, magnitude, threshold, latency_ticks):
    """scripts/node_eval.py's computation on the JAX package -> (shapes,
    loglik, raw)."""
    scfg = _scfg(JSynCfg, length=length, n_anomalies=3, anomaly_magnitude=magnitude,
                 inject_after_frac=0.5)
    ns = [j_generate_node(f"node{i:05d}", scfg, seed=100 + i) for i in range(nodes)]
    vals = np.stack([n.values for n in ns], axis=1)
    ts = np.stack([n.timestamps for n in ns], axis=1).astype(np.int64)
    grp = JGroup(cfg, [n.node_id for n in ns], backend="tpu")
    loglik = np.empty((length, nodes))
    raw = np.empty((length, nodes), np.float32)
    for lo in range(0, length, 128):
        hi = min(lo + 128, length)
        raw[lo:hi], loglik[lo:hi], _ = grp.run_chunk(vals[lo:hi], ts[lo:hi])
    shapes = {"coupled": {"events": 0, "detected": 0, "responses": []},
              "single": {"events": 0, "detected": 0, "responses": []}}
    for g, node in enumerate(ns):
        for (a, b), touched in zip(node.windows, node.event_metrics):
            kind = "coupled" if len(touched) == len(node.metrics) else "single"
            w = (node.timestamps >= a) & (node.timestamps <= b + latency_ticks * scfg.cadence_s)
            resp = float(loglik[w, g].max())
            shapes[kind]["events"] += 1
            shapes[kind]["responses"].append(round(resp, 3))
            shapes[kind]["detected"] += int(resp >= threshold)
    for v in shapes.values():
        v["recall_at_threshold"] = round(v["detected"] / v["events"], 3) if v["events"] else None
        v["median_response"] = round(float(np.median(v["responses"])), 3) if v["responses"] else None
    return {k: {kk: vv for kk, vv in v.items() if kk != "responses"}
            for k, v in shapes.items()}, loglik, raw


@pytest.fixture(scope="module")
def node_runs():
    jcfg = _short(j_node_preset(3))
    args = (NODES, LENGTH, 6.0, 0.15, 15)
    want = _jax_node_eval(jcfg, *args)
    got = node_eval.run_node_eval(*args, device="cpu", cfg=ModelConfig.from_dict(jcfg.to_dict()))
    return got, want


def test_run_node_eval_loglik_as_jax(node_runs):
    got, (_, want_ll, want_raw) = node_runs
    assert got["loglik"].shape == got["raw"].shape == (LENGTH, NODES)
    np.testing.assert_array_equal(got["loglik"], want_ll)
    np.testing.assert_array_equal(got["raw"], want_raw)


def test_run_node_eval_shapes_as_jax(node_runs):
    got, (want_shapes, _, _) = node_runs
    assert got["shapes"] == want_shapes
    assert sum(v["events"] for v in got["shapes"].values()) == 3 * NODES
    assert got["device"] == "cpu" and got["nodes"] == NODES and got["length"] == LENGTH


def test_node_eval_main_writes_report_without_loglik(tmp_path, monkeypatch, capsys):
    seen = {}

    def fake(*args, **kw):
        seen["args"] = args
        return {"shapes": {"coupled": {"events": 1}}, "raw": np.zeros((2, 2), np.float32),
                "loglik": np.zeros((2, 2)), "nodes": 2}

    monkeypatch.setattr(node_eval, "run_node_eval", fake)
    out = tmp_path / "sub" / "node.json"
    assert node_eval.main(["--nodes", "2", "--device", "cpu", "--out", str(out)]) == 0
    assert seen["args"] == (2, 1400, 6.0, 0.15, 15, "cpu")
    assert json.loads(out.read_text()) == {"shapes": {"coupled": {"events": 1}}, "nodes": 2}
    assert json.loads(capsys.readouterr().out) == {"coupled": {"events": 1}}
