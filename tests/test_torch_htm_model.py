"""PyTorch port vs the JAX package: the single-stream model API.

* ``HTMModel`` reproduces ``tests/golden/golden_config1.npz`` (the stand-in
  stream ...5f5533, 400 rows, ``golden_config()``) and
  ``golden_cluster_q16.npz``: raw equal, loglik within 1e-12 — the
  contract tests/golden/test_golden.py holds the JAX package to.
* ``save``/``load`` continue bit-identically; a file the JAX package's
  ``HTMModel.save`` wrote loads in the port and continues as the JAX model
  does, and the reverse.
* models/likelihood.py equals the JAX package's ``AnomalyLikelihood`` over a
  random raw sequence in the window and streaming modes, state_dict round
  trips included.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from rtap_tpu.data.nab_corpus import load_corpus as j_load_corpus
from rtap_tpu.models import HTMModel as JHTMModel
from rtap_tpu.models.oracle.likelihood import AnomalyLikelihood as JLik
from rtap_tpu_torch.config import LikelihoodConfig, ModelConfig
from rtap_tpu_torch.models import AnomalyDetector, HTMModel, create_model
from rtap_tpu_torch.models.likelihood import AnomalyLikelihood
from tests.golden.generate_golden import GOLDEN_PATH, ROWS, golden_config

torch.set_num_threads(1)

CFG = ModelConfig.from_dict(golden_config().to_dict())
CORPUS = Path(__file__).resolve().parent.parent / "data" / "nab"


def _stream():
    nf = next(f for f in j_load_corpus(CORPUS) if "5f5533" in f.name)
    return nf.timestamps, nf.values


def _run(model, ts, vals, lo, hi):
    out = [model.run(int(ts[i]), float(vals[i])) for i in range(lo, hi)]
    return (np.array([r.raw_score for r in out]), np.array([r.log_likelihood for r in out]))


def test_golden_config1_reproduced():
    ts, vals = _stream()
    det = AnomalyDetector(CFG, seed=0, device="cpu")
    raw, loglik = _run(det.model, ts, vals, 0, ROWS)
    golden = np.load(GOLDEN_PATH)
    np.testing.assert_array_equal(raw, golden["raw"])
    np.testing.assert_allclose(loglik, golden["loglik"], rtol=0, atol=1e-12)
    assert det.handle_record(int(ts[ROWS]), float(vals[ROWS]))[1] in (True, False)


def test_golden_cluster_q16_reproduced():
    """tests/golden/golden_cluster_q16.npz (dense_cluster_preset, u16, the
    window likelihood, 900 rows of a seeded synthetic stream) through the
    port's AnomalyDetector, under the contract tests/golden/test_golden.py
    holds the JAX package to."""
    from rtap_tpu_torch.config import dense_cluster_preset
    from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_stream
    from tests.golden.generate_golden import GOLDEN_Q16_PATH, Q16_ROWS

    base = dense_cluster_preset(perm_bits=16)
    cfg = dataclasses.replace(base, likelihood=dataclasses.replace(base.likelihood,
                                                                   mode="window"))
    s = generate_stream("golden.cpu", SyntheticStreamConfig(
        length=Q16_ROWS, n_anomalies=1, kinds=("level_shift",), anomaly_magnitude=6.0,
        noise_phi=0.97, noise_scale=0.5,
        inject_after_frac=cfg.likelihood.safe_inject_frac(Q16_ROWS)), seed=33)
    det = AnomalyDetector(cfg, seed=0, device="cpu")
    raw, loglik = _run(det.model, s.timestamps, s.values, 0, Q16_ROWS)
    golden = np.load(GOLDEN_Q16_PATH)
    np.testing.assert_array_equal(raw, golden["raw"])
    np.testing.assert_allclose(loglik, golden["loglik"], rtol=0, atol=1e-12)


def _small_cfg(jcfg):
    # a narrower model keeps the per-record cost down (the JAX oracle's too)
    return dataclasses.replace(jcfg, sp=dataclasses.replace(jcfg.sp, columns=128,
                                                            num_active_columns=10))


def test_save_load_continues_bit_identically(tmp_path):
    cfg = ModelConfig.from_dict(_small_cfg(golden_config()).to_dict())
    ts, vals = _stream()
    a = HTMModel(cfg, seed=3, device="cpu")
    _run(a, ts, vals, 0, 120)
    path = str(tmp_path / "m.npz")
    a.save(path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.npz"]  # no temp residue
    b = HTMModel.load(path, device="cpu")
    assert b.cfg == cfg and b.seed == 3
    ra, la = _run(a, ts, vals, 120, 180)
    rb, lb = _run(b, ts, vals, 120, 180)
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(la, lb)
    sa, sb = a.single_state(), b.single_state()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_file_crosses_packages(tmp_path, writer):
    """One package saves at row 90 (past the likelihood's probation start);
    the other loads the file; both continue 40 rows and agree exactly."""
    jcfg = _small_cfg(golden_config())
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    ts, vals = _stream()
    path = str(tmp_path / "m.npz")
    if writer == "jax":
        src = JHTMModel(jcfg, seed=4)
        _run(src, ts, vals, 0, 90)
        src.save(path)
        dst = HTMModel.load(path, device="cpu")
    else:
        src = HTMModel(cfg, seed=4, device="cpu")
        _run(src, ts, vals, 0, 90)
        src.save(path)
        dst = JHTMModel.load(path)
    assert dst.seed == 4
    rs, ls = _run(src, ts, vals, 90, 130)
    rd, ld = _run(dst, ts, vals, 90, 130)
    np.testing.assert_array_equal(rs, rd)
    np.testing.assert_allclose(ls, ld, rtol=0, atol=1e-12)
    assert np.unique(ls).size > 1  # the likelihood left its probation


def test_create_model_defaults_to_nab_preset_on_cuda(monkeypatch):
    from rtap_tpu_torch.config import nab_preset

    m = create_model(device="cpu", min_val=0.0, max_val=13.0)
    assert m.cfg == nab_preset(0.0, 13.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HTMModel(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnomalyDetector(CFG)


@pytest.mark.parametrize("mode", ["window", "streaming"])
def test_likelihood_matches_jax(mode):
    lcfg = dict(learning_period=30, estimation_samples=20, historic_window_size=150,
                reestimation_period=17, averaging_window=5, mode=mode)
    from rtap_tpu.config import LikelihoodConfig as JLikCfg

    mine, ref = AnomalyLikelihood(LikelihoodConfig(**lcfg)), JLik(JLikCfg(**lcfg))
    rng = np.random.default_rng(9)
    raw = np.clip(rng.beta(0.5, 3.0, 600) + (rng.random(600) < 0.02), 0, 1)
    for i, r in enumerate(raw):
        assert mine.update(float(r)) == ref.update(float(r)), i
        if i == 300:  # state_dict round trip mid-stream, both ways
            mine.load_state_dict(ref.state_dict())
            ref.load_state_dict(mine.state_dict())
    a, b = mine.state_dict(), ref.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
