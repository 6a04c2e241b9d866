"""PyTorch port vs the JAX package: per-alert attribution
(service/attribution.py) and its ``top_fields`` block on alert lines.

* The port's copies of the oracle's ``rdse_bucket`` and ``scalar_bucket``
  equal the JAX package's on a sweep of values, offsets and resolutions.
* The same value batches and alert indices through both attributors give
  equal ``top_fields`` for the univariate, multivariate (node), composite
  (value / delta / categorical, the encoder clamp) and scalar-encoder
  cases of tests/unit/test_attribution.py, and on seeded random walks.
* ``AlertWriter`` lines with an attributor are byte-equal to the JAX
  package's; without one the schema has no ``top_fields``.
"""

import dataclasses
import json

import numpy as np
import pytest

from rtap_tpu.config import CompositeEncoderConfig as JComp
from rtap_tpu.config import FieldSpec as JField
from rtap_tpu.config import ScalarEncoderConfig as JScalar
from rtap_tpu.config import categorical_preset as j_categorical
from rtap_tpu.config import cluster_preset as j_cluster
from rtap_tpu.config import composite_preset as j_composite
from rtap_tpu.config import node_preset as j_node
from rtap_tpu.models.oracle.encoders import rdse_bucket as j_rdse_bucket
from rtap_tpu.models.oracle.encoders import scalar_bucket as j_scalar_bucket
from rtap_tpu.service.alerts import AlertWriter as JWriter
from rtap_tpu.service.attribution import AlertAttributor as JAttr
from rtap_tpu_torch.config import ModelConfig, ScalarEncoderConfig
from rtap_tpu_torch.service.alerts import AlertWriter
from rtap_tpu_torch.service.attribution import AlertAttributor, rdse_bucket, scalar_bucket

NO_ALERTS = np.array([], np.int64)


def test_rdse_bucket_equals_the_oracle():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(0, 1e3, 500), rng.normal(0, 1e10, 200),
                           [0.0, 0.25, -0.25, 0.5, 1.5, 2.5, 1e38, -1e38, np.inf, -np.inf]])
    for res in (0.5, 0.1, 1.0 / 3, 7.7, 1e-6):
        for off in (0.0, 12.5, -3e9):
            assert np.array_equal(rdse_bucket(vals, off, res), j_rdse_bucket(vals, off, res))
        assert rdse_bucket(3.3, 1.1, res) == j_rdse_bucket(3.3, 1.1, res)


def test_scalar_bucket_equals_the_oracle():
    vals = np.linspace(-50, 150, 4001).astype(np.float32)
    for lo, hi, size, width in ((0.0, 100.0, 400, 21), (-5.0, 5.0, 128, 11),
                                (10.0, 10.5, 64, 3)):
        t = ScalarEncoderConfig(min_val=lo, max_val=hi, size=size, width=width)
        j = JScalar(min_val=lo, max_val=hi, size=size, width=width)
        assert np.array_equal(scalar_bucket(vals, t), j_scalar_bucket(vals, j))


def _composite():
    cfg = dataclasses.replace(j_cluster(), n_fields=3, composite=JComp(fields=(
        JField(name="value", kind="rdse", size=128, active_bits=11, resolution=0.5),
        JField(name="delta", kind="delta", size=128, active_bits=11, resolution=0.5),
        JField(name="event_class", kind="categorical", size=128, active_bits=11))))
    return cfg


def _scalar_cfg():
    return dataclasses.replace(j_cluster(), scalar=JScalar(min_val=0.0, max_val=100.0,
                                                           size=400, width=21))


CONFIGS = {"cluster": j_cluster, "node3": lambda: j_node(3), "node2": lambda: j_node(2),
           "composite": _composite, "composite-preset": j_composite,
           "categorical": j_categorical, "scalar": _scalar_cfg}

# (values rows, alert indices) sequences from tests/unit/test_attribution.py
SCRIPTS = {
    "node3": [([[30.0, 50.0, 10.0], [1.0, 2.0, 3.0]], []),
              ([[30.0, 550.0, 10.0], [1.0, 2.0, 3.0]], [0]),
              ([[30.0, 550.0, 10.0], [1.0, 2.0, 403.0]], [0, 1]),
              ([[1.0e10, 2.0e10, 3.0e10], [np.nan, np.nan, np.nan]], []),
              ([[1.0e10, 2.1e10, 3.0e10], [1.0, 2.0, 3.0]], [0, 1])],
    "node2": [([[5.0, 5.0]], []), ([[np.nan, np.nan]], []), ([[5.0, 500.0]], [0]),
              ([[5.0, 500.0]], [0])],
    "cluster": [([10.0, 10.0], []), ([10.0, 900.0], [1]), ([10.0, 900.0], [0, 1]),
                ([np.nan, 901.0], [0])],
    "composite": [([[10.0, 10.0, 2.0]], []), ([[10.0, 10.0, 2.0]], []),
                  ([[60.0, 60.0, 2.0]], [0]), ([[60.0, 60.0, 3.0]], [0]),
                  ([[60.5, 60.5, 2e8]], [0]), ([[61.0, 61.0, 3e8]], [0]),
                  ([[10.0, 10.0, 3e8]], [0])],
    "scalar": [([10.0, 50.0], []), ([10.0, 95.0], [1]), ([200.0, -5.0], [0, 1])],
}
SCRIPTS["composite-preset"] = SCRIPTS["composite"]
SCRIPTS["categorical"] = [([3.0, 4.0], []), ([3.0, 5.0], [1]), ([9.0, 5.0], [0, 1])]


def _run(attr, script):
    out = []
    for rows, idx in script:
        vals = np.array(rows, np.float32)
        out.append(attr.update_and_attribute([f"s{i}" for i in range(len(vals))], vals,
                                             np.array(idx, np.int64)))
    return out


@pytest.mark.parametrize("top_k", [1, 3])
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_top_fields_match_jax(name, top_k):
    jcfg = CONFIGS[name]()
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    script = SCRIPTS[name]
    assert _run(AlertAttributor(tcfg, top_k=top_k), script) == \
        _run(JAttr(jcfg, top_k=top_k), script)


@pytest.mark.parametrize("name", ["cluster", "node3", "composite", "scalar"])
def test_random_walks_match_jax(name):
    jcfg = CONFIGS[name]()
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    F = jcfg.n_fields
    script, v = [], rng.uniform(0, 50, (8, F))
    for _ in range(60):
        v = v + rng.normal(0, 2, v.shape) + (rng.random(v.shape) < 0.05) * 80
        rows = v.copy()
        rows[rng.random(rows.shape) < 0.03] = np.nan
        idx = np.nonzero(rng.random(8) < 0.3)[0]
        script.append(((rows[:, 0] if F == 1 else rows).tolist(), idx.tolist()))
    t, j = AlertAttributor(tcfg, top_k=3), JAttr(jcfg, top_k=3)
    assert _run(t, script) == _run(j, script)
    assert t.live_evictions == j.live_evictions


def test_alert_writer_lines_with_top_fields_are_byte_equal(tmp_path):
    jcfg = j_node(3)
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    ids = ["n0", "n1"]
    base = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    spike = base.copy()
    spike[1, 0] += 400.0
    raw, ll = np.zeros(2, np.float32), np.zeros(2)
    texts = {}
    for name, writer, attr, cfg in (("jax", JWriter, JAttr, jcfg),
                                    ("torch", AlertWriter, AlertAttributor, tcfg)):
        path = tmp_path / f"{name}.jsonl"
        w = writer(str(path), attributor=attr(cfg))
        w.emit_batch(ids, np.array([100, 100]), base, raw, ll, np.zeros(2, bool), group=0,
                     tick=0)
        w.emit_batch(ids, np.array([101, 101]), spike, raw, ll, np.array([False, True]),
                     group=0, tick=1)
        w.emit_batch(ids, np.array([102, 102]), spike, raw, ll, np.array([True, True]),
                     group=0, tick=2)
        w.close()
        texts[name] = path.read_text()
    assert texts["torch"] == texts["jax"]
    first = json.loads(texts["torch"].splitlines()[0])
    assert first["stream"] == "n1" and first["top_fields"][0]["field"] == 0
    plain = tmp_path / "plain.jsonl"
    w = AlertWriter(str(plain))
    w.emit_batch(ids, np.array([1, 1]), base, raw, ll, np.array([True, False]))
    w.close()
    assert "top_fields" not in json.loads(plain.read_text())
