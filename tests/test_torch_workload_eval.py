"""PyTorch port vs the JAX package: the workload-modality eval.

* ``generate_log_stream`` and ``generate_categorical_stream``: the same
  lines / values, timestamps, windows and events over several seeds and
  stream ids.
* ``TemplateMiner``: on seeded log lines, the same template-id sequence,
  final template strings, stats and overflow.
* ``run_categorical_eval``, ``run_log_template_eval`` and
  ``run_composite_vs_scalar`` on the miniature configs
  (``tiny_eval_configs``): equal reports except the wall-clock throughput
  entries (compared by key); ``main`` exits 1 when the composite gate fails.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rtap_tpu.data.synthetic import SyntheticStreamConfig as JSynCfg
from rtap_tpu.data.synthetic import generate_categorical_stream as j_gen_cat
from rtap_tpu.data.synthetic import generate_log_stream as j_gen_log
from rtap_tpu.eval import workload_eval as jw
from rtap_tpu.ingest.templates import TemplateMiner as JMiner
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.data.synthetic import (
    SyntheticStreamConfig,
    generate_categorical_stream,
    generate_log_stream,
)
from rtap_tpu_torch.eval import workload_eval as pw
from rtap_tpu_torch.ingest import TemplateMiner

torch.set_num_threads(1)

WALL_CLOCK = ("elapsed_s", "metrics_per_sec")
SEEDS_IDS = [(0, "node0000.log"), (11, "node0003.log"), (47, "ev0001.class"), (123, "x")]


def _cfgs(**kw):
    return JSynCfg(**kw), SyntheticStreamConfig(**kw)


def _same_events(a, b):
    assert [dataclasses.astuple(e) for e in a] == [dataclasses.astuple(e) for e in b]


@pytest.mark.parametrize("seed,sid", SEEDS_IDS)
def test_generate_log_stream_as_jax(seed, sid):
    jc, pc = _cfgs(length=700, n_anomalies=3, inject_after_frac=0.4)
    want, got = j_gen_log(sid, jc, seed=seed), generate_log_stream(sid, pc, seed=seed)
    assert got.stream_id == want.stream_id and got.lines == want.lines
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.timestamps.dtype == want.timestamps.dtype
    assert got.windows == want.windows and len(got.windows) == 3
    _same_events(got.events, want.events)


@pytest.mark.parametrize("seed,sid", SEEDS_IDS)
def test_generate_categorical_stream_as_jax(seed, sid):
    jc, pc = _cfgs(length=700, n_anomalies=2, inject_after_frac=0.4)
    want = j_gen_cat(sid, jc, seed=seed, n_classes=5)
    got = generate_categorical_stream(sid, pc, seed=seed, n_classes=5)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values.dtype == want.values.dtype == np.float32
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.windows == want.windows
    _same_events(got.events, want.events)


def test_generators_refuse_too_short_streams_as_jax():
    jc, pc = _cfgs(length=100, n_anomalies=3, inject_after_frac=0.6)
    for jfn, pfn in ((j_gen_log, generate_log_stream), (j_gen_cat, generate_categorical_stream)):
        with pytest.raises(ValueError, match="too short") as want:
            jfn("a", jc)
        with pytest.raises(ValueError, match="too short") as got:
            pfn("a", pc)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,sid", SEEDS_IDS)
def test_template_miner_as_jax(seed, sid):
    jc, _ = _cfgs(length=600, n_anomalies=3, inject_after_frac=0.3)
    lines = j_gen_log(sid, jc, seed=seed).lines + ["", "a b c 1", "a b d 2", "a x d 3 q"]
    jm, pm = JMiner(), TemplateMiner()
    assert pm.encode_values(lines) == jm.encode_values(lines)
    assert pm.n_templates() == jm.n_templates() >= 7
    assert [pm.template(t) for t in range(pm.n_templates())] == \
        [jm.template(t) for t in range(jm.n_templates())]
    assert pm.stats() == jm.stats()


def test_template_miner_overflow_and_validation_as_jax():
    lines = [f"w{i} x{i} y{i} z{i} k" if i % 2 else f"alpha{chr(97 + i % 26)} beta"
             for i in range(40)] + [f"t{c} u v" for c in "abcdefgh"]
    for kw in (dict(max_templates=4), dict(depth=1, sim_threshold=0.9)):
        jm, pm = JMiner(**kw), TemplateMiner(**kw)
        assert pm.encode_values(lines) == jm.encode_values(lines)
        assert (pm.overflow, pm.lines_seen, pm.overflow_id) == \
            (jm.overflow, jm.lines_seen, jm.overflow_id)
        assert pm.template(pm.overflow_id) == jm.template(jm.overflow_id)
    assert TemplateMiner(max_templates=4).overflow_id == 3
    for bad in (dict(depth=0), dict(sim_threshold=0.0), dict(max_templates=1)):
        with pytest.raises(ValueError) as want:
            JMiner(**bad)
        with pytest.raises(ValueError) as got:
            TemplateMiner(**bad)
        assert str(got.value) == str(want.value)


def _tiny():
    jcfgs = jw.tiny_eval_configs()
    return jcfgs, tuple(ModelConfig.from_dict(c.to_dict()) for c in jcfgs)


def test_tiny_eval_configs_as_jax():
    jcfgs, pcfgs = _tiny()
    assert pw.tiny_eval_configs() == pcfgs


def _strip(rep):
    """A report with every throughput's wall-clock entries dropped (after
    checking they are there)."""
    if isinstance(rep, dict):
        out = {}
        for k, v in rep.items():
            if k == "throughput":
                assert set(WALL_CLOCK) <= v.keys()
                v = {kk: vv for kk, vv in v.items() if kk not in WALL_CLOCK}
            else:
                v = _strip(v)
            out[k] = v
        return out
    return rep


def _same(got, want):
    assert _strip(got) == _strip(want)


def test_run_categorical_eval_as_jax():
    (jcat, _, _), (pcat, _, _) = _tiny()
    kw = dict(n_streams=4, length=360, seed=5)
    want = jw.run_categorical_eval(cfg=jcat, backend="tpu", **kw)
    got = pw.run_categorical_eval(cfg=pcat, device="cpu", **kw)
    _same(got, want)
    assert got["at_best"]["events"] == 8 and got["throughput"]["scored"] == 4 * 360


def test_run_log_template_eval_as_jax():
    (jcat, _, _), (pcat, _, _) = _tiny()
    kw = dict(n_streams=4, length=360, seed=11)
    want = jw.run_log_template_eval(cfg=jcat, backend="tpu", **kw)
    got = pw.run_log_template_eval(cfg=pcat, device="cpu", **kw)
    _same(got, want)
    assert got["miner"]["templates_max"] >= 7


def test_run_composite_vs_scalar_as_jax():
    (_, jtiny, jcomp), (_, ptiny, pcomp) = _tiny()
    kw = dict(n_streams=4, length=360, seed=11)
    want = jw.run_composite_vs_scalar(scalar_cfg=jtiny, composite_cfg=jcomp, backend="tpu", **kw)
    got = pw.run_composite_vs_scalar(scalar_cfg=ptiny, composite_cfg=pcomp, device="cpu", **kw)
    _same(got, want)
    assert got["gate_composite_no_worse"] == want["gate_composite_no_worse"]


def test_workload_main_writes_report_and_exits_1_on_a_failed_gate(tmp_path, monkeypatch, capsys):
    """main runs the three modalities with --device, writes the report and
    exits 1 exactly when the composite gate fails (the modalities are
    stubbed: their own tests above hold them to the JAX package)."""
    calls = []

    def fake(name, gate=None):
        def run(**kw):
            calls.append((name, kw))
            out = {"modality": name}
            if gate is not None:
                out["gate_composite_no_worse"] = gate
            return out
        return run

    out = tmp_path / "w.json"
    for gate, rc in ((True, 0), (False, 1)):
        monkeypatch.setattr(pw, "run_categorical_eval", fake("categorical"))
        monkeypatch.setattr(pw, "run_log_template_eval", fake("log_template"))
        monkeypatch.setattr(pw, "run_composite_vs_scalar", fake("composite_vs_scalar", gate))
        assert pw.main(["--device", "cpu", "--streams", "3", "--out", str(out)]) == rc
        rep = json.loads(out.read_text())
        assert rep["verified"] is gate and rep["device"] == "cpu" and rep["round"] == "r09"
    assert calls[2] == ("composite_vs_scalar",
                        dict(n_streams=4, length=900, device="cpu", seed=11))
    assert "FAIL: composite F1" in capsys.readouterr().err
