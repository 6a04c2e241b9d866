"""PyTorch port vs the JAX package: the fault-injection eval.

* The scoring primitives (``debounce_mask``, ``_episodes``,
  ``match_alerts``, ``_f1``, ``score_lead_time``) give equal results on
  seeded alert masks, streams and events.
* ``run_fault_eval`` end to end (replay on the CPU through each package,
  then the numpy threshold x debounce sweep): the report is equal in every
  field, floats included, except the wall-clock throughput entries, which
  are compared by key.
* ``python -m rtap_tpu_torch eval``: the JSON it writes is the report of
  ``run_fault_eval`` with the same arguments; ``--backend`` exits 2 naming
  ``--device``.

Sizes: the 32-column cluster family with a 40-tick probation
(``workload_eval.tiny_eval_configs``), a few streams of 400 ticks.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rtap_tpu.data.synthetic import ANOMALY_KINDS as J_KINDS
from rtap_tpu.data.synthetic import SyntheticStreamConfig as JSynCfg
from rtap_tpu.data.synthetic import generate_stream as j_generate_stream
from rtap_tpu.eval import fault_eval as jf
from rtap_tpu.eval.workload_eval import tiny_eval_configs as j_tiny
from rtap_tpu_torch.__main__ import main
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.data.synthetic import ANOMALY_KINDS, SyntheticStreamConfig, generate_stream
from rtap_tpu_torch.eval import fault_eval as pf

torch.set_num_threads(1)

WALL_CLOCK = ("elapsed_s", "metrics_per_sec")


def _streams(n=5, length=600, seed=3):
    """Kind-labelled streams of both packages from one seed."""
    kw = dict(length=length, n_anomalies=3, kinds=ANOMALY_KINDS, inject_after_frac=0.3,
              noise_phi=0.97, noise_scale=0.5)
    ids = [f"node{i:03d}.cpu" for i in range(n)]
    return ([j_generate_stream(s, JSynCfg(**kw), seed=seed) for s in ids],
            [generate_stream(s, SyntheticStreamConfig(**kw), seed=seed) for s in ids])


def _hits(T, n, seed):
    """A seeded [T, n] hit mask with runs (a thresholded AR walk)."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=(T, n)), axis=0)
    return (x - np.minimum.accumulate(x, axis=0)) > 2.0


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_debounce_mask_as_jax(d):
    hits = _hits(300, 7, d)
    got = pf.debounce_mask(hits, d)
    np.testing.assert_array_equal(got, jf.debounce_mask(hits, d))
    assert got.dtype == bool and got.sum() <= hits.sum()


@pytest.mark.parametrize("cooldown", [0.0, 1.0, 5.0, 10.0, 60.0])
def test_episodes_as_jax(cooldown):
    rng = np.random.default_rng(int(cooldown) + 1)
    ts = np.sort(rng.choice(np.arange(1_700_000_000, 1_700_001_000), 120, replace=False))
    assert pf._episodes(ts, cooldown) == jf._episodes(ts, cooldown)
    assert pf._episodes(ts[:0], cooldown) == jf._episodes(ts[:0], cooldown) == []


@pytest.mark.parametrize("d,cooldown", [(1, 10.0), (2, 10.0), (3, 5.0), (4, 30.0)])
def test_match_alerts_as_jax(d, cooldown):
    js, ps = _streams()
    alerts = pf.debounce_mask(_hits(600, len(ps), 10 + d), d)
    pk, ov = pf.match_alerts(ps, alerts, ps[0].timestamps, cooldown)
    jpk, jov = jf.match_alerts(js, alerts, js[0].timestamps, cooldown)
    assert ov == jov
    assert {k: dataclasses.asdict(v) for k, v in pk.items()} == \
        {k: dataclasses.asdict(v) for k, v in jpk.items()}
    assert {k: v.summary() for k, v in pk.items()} == {k: v.summary() for k, v in jpk.items()}
    assert ov["events"] == 15


@pytest.mark.parametrize("p,r", [(0.0, 0.0), (1.0, 0.0), (0.7, 0.8), (0.3333, 0.9167)])
def test_f1_as_jax(p, r):
    assert pf._f1(p, r) == jf._f1(p, r)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_score_lead_time_as_jax(seed):
    rng = np.random.default_rng(seed)
    nodes = [f"svc-{i:02d}" for i in range(5)]
    cascade = nodes[:3]
    onsets = {n: 300 + 4 * i for i, n in enumerate(cascade)}
    events = [{"event": "precursor", "stream": f"{nodes[rng.integers(5)]}.cpu",
               "tick": int(rng.integers(250, 320))} for _ in range(6)]
    events.insert(int(rng.integers(6)), {
        "event": "predicted_incident", "alert_id": "pi-1", "tick": int(rng.integers(280, 310)),
        "first_node": cascade[0], "blast_radius": list(rng.permutation(cascade)[:2 + seed % 2])})
    events.append({"event": "alert", "stream": "svc-04.cpu", "tick": 10})
    got = pf.score_lead_time(events, onsets, cascade)
    assert got == jf.score_lead_time(events, onsets, cascade)
    assert pf.score_lead_time([], onsets, cascade) == jf.score_lead_time([], onsets, cascade)


def _tiny(mode="streaming"):
    _cat, tiny, _comp = j_tiny()
    if mode == "window":
        tiny = dataclasses.replace(tiny, likelihood=dataclasses.replace(tiny.likelihood,
                                                                        mode="window"))
    return tiny


CASES = {
    "window": dict(cfg=lambda: _tiny("window")),
    "streaming": dict(cfg=lambda: _tiny()),
    "all_kinds": dict(cfg=lambda: _tiny(), kinds=J_KINDS),
    "heldout": dict(cfg=lambda: _tiny(), family="heldout", kinds=J_KINDS),
    "learn_every_2": dict(cfg=lambda: _tiny().with_learn_every(2)),
}


def _same_report(got: dict, want: dict) -> None:
    """Equal in every field; throughput's wall-clock entries by key only."""
    got, want = dict(got), dict(want)
    gt, wt = got.pop("throughput"), want.pop("throughput")
    assert got == want
    assert gt.keys() == wt.keys()
    assert {k: v for k, v in gt.items() if k not in WALL_CLOCK} == \
        {k: v for k, v in wt.items() if k not in WALL_CLOCK}


@pytest.mark.parametrize("case", list(CASES))
def test_run_fault_eval_as_jax(case):
    kw = dict(CASES[case])
    jcfg = kw.pop("cfg")()
    common = dict(n_streams=6, length=400, chunk_ticks=128, **kw)
    want = dataclasses.asdict(jf.run_fault_eval(cfg=jcfg, backend="tpu", **common))
    rep = pf.run_fault_eval(cfg=ModelConfig.from_dict(jcfg.to_dict()), device="cpu", **common)
    got = dataclasses.asdict(rep)
    _same_report(got, want)
    # the exact fields, named: floats compared with ==
    for k in ("best_threshold", "best_debounce", "at_best", "at_default", "per_kind",
              "kind_thresholds"):
        assert got[k] == want[k], k
    assert got["throughput"]["scored"] == 6 * 400
    assert got["at_best"]["events"] == 12
    assert json.loads(rep.to_json())["at_best"] == got["at_best"]


def test_run_fault_eval_does_not_depend_on_the_chunk():
    """The replay's chunking is a dispatch detail: the report is the same at
    any chunk size, so the card's runs at the CLI's 256 answer for the
    JAX fixture's 128."""
    cfg = ModelConfig.from_dict(_tiny().to_dict())
    a, b = (dataclasses.asdict(pf.run_fault_eval(n_streams=3, length=400, cfg=cfg, device="cpu",
                                                 chunk_ticks=c)) for c in (64, 256))
    _same_report(a, b)


def test_eval_command_writes_run_fault_eval_report(tmp_path, capsys):
    out = tmp_path / "eval.json"
    argv = ["eval", "--device", "cpu", "--streams", "2", "--length", "450",
            "--learning-period", "60", "--debounce", "3", "--out", str(out)]
    assert main(argv) == 0
    printed = json.loads(capsys.readouterr().out)
    written = json.loads(out.read_text())
    cfg = pf.eval_config(likelihood="streaming", learning_period=60)
    want = dataclasses.asdict(pf.run_fault_eval(n_streams=2, length=450, cfg=cfg, device="cpu",
                                                default_debounce=3))
    _same_report(written, want)
    assert printed == written
    assert written["default_debounce"] == 3 and written["n_streams"] == 2


def test_eval_config_matches_the_jax_module_flags():
    """The module's flag -> config mapping (perm bits, likelihood mode,
    probation, cadence) builds the config the JAX module's main builds."""
    import rtap_tpu.config as jc

    base = jc.cluster_preset(perm_bits=8)
    want = dataclasses.replace(base, likelihood=dataclasses.replace(base.likelihood,
                                                                    mode="streaming"))
    want = want.with_learning_period(200).with_learn_every(3, None, burst=2)
    got = pf.eval_config(8, "streaming", 200, 3, None, 2)
    assert got == ModelConfig.from_dict(want.to_dict())


def test_eval_command_refuses_backend(capsys):
    assert main(["eval", "--backend", "tpu"]) == 2
    assert "--device" in capsys.readouterr().err


def test_eval_command_runs_on_cuda_unless_told(monkeypatch):
    """No card and no --device: the eval refuses instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["eval", "--streams", "1", "--length", "900"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pf.run_fault_eval(n_streams=1, length=900)

