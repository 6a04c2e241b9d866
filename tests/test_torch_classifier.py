"""PyTorch port vs the JAX package: the SDR classifier.

* ``classifier_step`` against ``jax.vmap`` of the JAX one, learning and
  inferring over a sequence of random patterns and values (NaN and values
  past the bucket range included): buckets and ``cls_cnt`` exact, ``cls_w``
  within rtol 1e-5 / atol 1e-6, predictions and probabilities within 1e-4
  (the tolerance the JAX package holds its own device path to: the product
  and ``exp`` are not bit-exact across devices).
* ``StreamGroup`` and ``replay_streams`` predictions against the JAX ones at
  ``golden_config()`` with a 17-bucket classifier; raw exact.
* A checkpoint round trip keeps the ``cls_*`` and ``enc_prev`` leaves and
  continues bit-identically.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtap_tpu.config import ClassifierConfig, composite_preset, scaled_cluster_preset
from rtap_tpu.ops.classifier_tpu import classifier_bucket_device, classifier_step as j_step
from rtap_tpu.service.loop import replay_streams as j_replay
from rtap_tpu.service.registry import StreamGroup as JStreamGroup
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_stream
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.ops.classifier import classifier_bucket, classifier_step
from rtap_tpu_torch.service.checkpoint import load_group, save_group
from rtap_tpu_torch.service.registry import StreamGroup
from rtap_tpu_torch.service.replay import replay_streams
from tests.golden.generate_golden import golden_config

torch.set_num_threads(1)

CLS = dict(rtol=1e-5, atol=1e-6)
PRED = dict(rtol=0, atol=1e-4)


def _with_classifier(cfg, buckets):
    return dataclasses.replace(cfg, classifier=ClassifierConfig(enabled=True, buckets=buckets))


def test_classifier_bucket_matches_jax():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(0, 30, 200), [np.nan, np.inf, -np.inf, 3e38, -3e38,
                                                 0.5, 1.5, -2.5, 64.0, 65.0]]).astype(np.float32)
    off = rng.normal(0, 5, v.size).astype(np.float32)
    res = rng.uniform(0.05, 3.0, v.size).astype(np.float32)
    want = jax.vmap(lambda a, b, c: classifier_bucket_device(a, b, c, 130))(v, off, res)
    got = classifier_bucket(*(torch.from_numpy(x) for x in (v, off, res)), 130)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("learn", [True, False])
def test_classifier_step_matches_jax(learn):
    """12 ticks of random patterns for G = 6 streams, each stream with its
    own offset and resolution; a NaN value and an all-off pattern learn
    nothing."""
    jcfg = _with_classifier(scaled_cluster_preset(16), 23)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    G, C, K, B = 6, jcfg.sp.columns, jcfg.tm.cells_per_column, 23
    rng = np.random.default_rng(7)
    st = {"cls_w": rng.normal(0, 0.2, (G, C * K, B)).astype(np.float32),
          "cls_val": np.zeros((G, B), np.float32), "cls_cnt": np.zeros((G, B), np.int32),
          "enc_offset": rng.normal(40, 3, (G, 1)).astype(np.float32),
          "enc_resolution": rng.uniform(0.3, 2.0, (G, 1)).astype(np.float32)}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    jfn = jax.jit(jax.vmap(lambda s, a, b, v: j_step(s, a, b, v, jcfg, learn)))
    prev = rng.random((G, C, K)) < 0.1
    for t in range(12):
        now = rng.random((G, C, K)) < 0.1
        now[1] = False  # an all-off pattern
        value = (40 + rng.normal(0, 8, G)).astype(np.float32)
        value[2] = np.nan if t % 3 == 0 else value[2]
        value[3] = 1e6  # past the bucket range: the top bucket
        jst, jpred, jprob = jfn(jst, jnp.asarray(prev), jnp.asarray(now), jnp.asarray(value))
        tst, pred, prob = classifier_step(tst, torch.from_numpy(prev), torch.from_numpy(now),
                                          torch.from_numpy(value), cfg, learn)
        np.testing.assert_array_equal(tst["cls_cnt"].numpy(), np.asarray(jst["cls_cnt"]))
        np.testing.assert_allclose(tst["cls_w"].numpy(), np.asarray(jst["cls_w"]), **CLS)
        np.testing.assert_allclose(tst["cls_val"].numpy(), np.asarray(jst["cls_val"]), **CLS)
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), **PRED, err_msg=f"tick {t}")
        np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), **PRED, err_msg=f"tick {t}")
        prev = now
    if learn:
        assert tst["cls_cnt"].sum() > 0


def _stream(length, seed):
    return generate_stream("cls.cpu", SyntheticStreamConfig(length=length, n_anomalies=0),
                           seed=seed)


def test_stream_group_predictions_match_jax():
    """golden_config() with a 17-bucket classifier, 3 streams over 60 ticks
    in chunks and single ticks: raw exact, predictions within 1e-4,
    TickResult.prediction the last row."""
    jcfg = _with_classifier(golden_config(), 17)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    ss = [_stream(60, seed) for seed in (1, 2, 3)]
    vals = np.stack([s.values for s in ss], 1)
    ts = np.stack([s.timestamps for s in ss], 1)
    ids = ["a", "b", "c"]
    jg = JStreamGroup(jcfg, ids, seed=1, backend="tpu")
    tg = StreamGroup(cfg, ids, seed=1, device="cpu")
    for sl in (slice(0, 32), slice(32, 58)):
        jr, _, _ = jg.run_chunk(vals[sl], ts[sl])
        tr, _, _ = tg.run_chunk(vals[sl], ts[sl])
        np.testing.assert_array_equal(tr, jr)
        assert tg.last_predictions.shape == (sl.stop - sl.start, 3)
        np.testing.assert_allclose(tg.last_predictions, jg.last_predictions, **PRED)
    for i in (58, 59):
        jres, tres = jg.tick(vals[i], ts[i]), tg.tick(vals[i], ts[i])
        np.testing.assert_array_equal(tres.raw, jres.raw)
        np.testing.assert_allclose(tres.prediction, jres.prediction, **PRED)
        np.testing.assert_allclose(tg.last_predictions[-1], tres.prediction)
    got, want = state_to_numpy(tg.state), jax.device_get(jg.state)
    np.testing.assert_array_equal(got["cls_cnt"], np.asarray(want["cls_cnt"]))
    np.testing.assert_allclose(got["cls_w"], np.asarray(want["cls_w"]), **CLS)
    for k in want:
        if not k.startswith("cls_"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert np.isfinite(tg.last_predictions).all()


def test_replay_predictions_match_jax():
    jcfg = _with_classifier(golden_config(), 17)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    streams = [_stream(70, seed) for seed in (4, 5)]
    streams[1] = dataclasses.replace(streams[1], stream_id="cls.mem")
    want = j_replay(streams, jcfg, backend="tpu", chunk_ticks=32)
    got = replay_streams(streams, cfg, device="cpu", chunk_ticks=32)
    np.testing.assert_array_equal(got.raw, want.raw)
    assert got.predictions.shape == (70, 2) and np.isfinite(got.predictions).all()
    np.testing.assert_allclose(got.predictions, want.predictions, **PRED)
    plain = replay_streams(streams, ModelConfig.from_dict(golden_config().to_dict()),
                           device="cpu", chunk_ticks=32)
    assert plain.predictions is None
    np.testing.assert_array_equal(plain.raw, got.raw)  # the classifier reads only


@pytest.mark.parametrize("which", ["classifier", "composite"])
def test_checkpoint_keeps_classifier_and_delta_leaves(tmp_path, which):
    """Save at tick 30, load, continue: the cls_* / enc_prev leaves come back
    equal and the next 20 ticks are bit-identical (predictions included)."""
    if which == "classifier":
        cfg = ModelConfig.from_dict(_with_classifier(golden_config(), 17).to_dict())
        keys = ("cls_w", "cls_val", "cls_cnt")
    else:
        cfg = ModelConfig.from_dict(composite_preset().to_dict())
        keys = ("enc_prev",)
    ss = [_stream(50, seed) for seed in (6, 7)]
    vals = np.stack([s.values for s in ss], 1)
    vals[29, 1] = np.nan  # the saved predecessor holds the pre-gap value
    ts = np.stack([s.timestamps for s in ss], 1)
    ref = StreamGroup(cfg, ["a", "b"], seed=2, device="cpu")
    ref.run_chunk(vals[:30], ts[:30])
    save_group(ref, tmp_path / "g")
    back = load_group(tmp_path / "g", device="cpu")
    a, b = state_to_numpy(ref.state), state_to_numpy(back.state)
    assert a.keys() == b.keys() and set(keys) <= a.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k], equal_nan=True), k
    for sl in (slice(30, 40), slice(40, 50)):
        r1, l1, _ = ref.run_chunk(vals[sl], ts[sl])
        r2, l2, _ = back.run_chunk(vals[sl], ts[sl])
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(l1, l2)
        if which == "classifier":
            np.testing.assert_array_equal(ref.last_predictions, back.last_predictions)
    a, b = state_to_numpy(ref.state), state_to_numpy(back.state)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
