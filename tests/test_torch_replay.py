"""PyTorch port vs the JAX package: stream groups, replay and the golden.

* The port's StreamGroup.run_chunk against the JAX StreamGroup on the JAX
  CPU backend: raw, log-likelihood and alerts equal, with a claim_slot
  mid-run.
* A G = 1 port group fed the stream of tests/golden/generate_golden.py's
  run_sparse reproduces golden_cluster_sparse.npz's raw scores exactly over
  900 ticks.
* Without CUDA and without device="cpu", every entry point raises.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rtap_tpu.config import cluster_preset
from rtap_tpu.service.registry import StreamGroup as JStreamGroup
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.service.registry import StreamGroup, StreamGroupRegistry

# xdist workers share the host's cores with each other and with JAX: one
# intra-op thread per worker keeps torch's OpenMP pool from oversubscribing them
torch.set_num_threads(1)


def _short_probation(jcfg):
    """Cluster preset with a short likelihood probation, so 80 ticks reach
    real log-likelihoods and alerts."""
    return dataclasses.replace(jcfg, likelihood=dataclasses.replace(
        jcfg.likelihood, learning_period=20, estimation_samples=10))


def test_stream_group_matches_jax_with_claim_mid_run():
    jcfg = _short_probation(cluster_preset())
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    ids = ["n0.cpu", "n0.mem", "n1.cpu", "__pad0", "__pad1"]
    jg = JStreamGroup(jcfg, ids, seed=4, backend="tpu", threshold=0.3, debounce=2)
    tg = StreamGroup(cfg, ids, seed=4, device="cpu", threshold=0.3, debounce=2)
    rng = np.random.default_rng(9)
    T, G = 80, len(ids)
    vals = (30 + 10 * np.sin(np.arange(T)[:, None] / 6.0) + rng.normal(0, 1, (T, G))
            ).astype(np.float32)
    vals[55:60, 0] += 40.0
    vals[:, 3:] = np.nan  # pads are fed NaN
    ts = (1_700_000_000 + np.arange(T)[:, None] * np.ones((1, G))).astype(np.int64)
    for t0, t1 in ((0, 32), (32, 64), (64, 80)):
        if t0 == 32:
            assert jg.claim_slot("n2.net") == tg.claim_slot("n2.net") == 3
            vals[32:, 3] = 25 + rng.normal(0, 1, T - 32).astype(np.float32)
        want = jg.run_chunk(vals[t0:t1], ts[t0:t1])
        got = tg.run_chunk(vals[t0:t1], ts[t0:t1])
        for name, a, b in zip(("raw", "loglik", "alerts"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} ticks {t0}-{t1}")
    assert tg.ticks == jg.ticks == T
    assert tg.stream_ids == jg.stream_ids
    assert tg.overflow_total() == 0


def test_tick_matches_run_chunk_and_registry_claims_pads():
    """StreamGroup.tick one record at a time gives run_chunk's scores; a
    registry pads its last group and hands the pads to later streams."""
    cfg = ModelConfig.from_dict(_short_probation(cluster_preset()).to_dict())
    ids = ["a", "b", "c"]
    rng = np.random.default_rng(3)
    T = 30
    vals = (20 + 5 * np.sin(np.arange(T)[:, None] / 4.0) + rng.normal(0, 1, (T, 3))
            ).astype(np.float32)
    ts = (1_700_000_000 + np.arange(T)[:, None] * np.ones((1, 3))).astype(np.int64)
    chunked = StreamGroup(cfg, ids, seed=1, device="cpu", threshold=0.3)
    raw, loglik, alerts = chunked.run_chunk(vals, ts)
    ticked = StreamGroup(cfg, ids, seed=1, device="cpu", threshold=0.3)
    for t in range(T):
        res = ticked.tick(vals[t], ts[t])
        np.testing.assert_array_equal(res.raw, raw[t], err_msg=f"raw {t}")
        np.testing.assert_array_equal(res.log_likelihood, loglik[t], err_msg=f"loglik {t}")
        np.testing.assert_array_equal(res.alerts, alerts[t], err_msg=f"alerts {t}")

    reg = StreamGroupRegistry(cfg, group_size=4, device="cpu")
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()
    assert len(reg.groups) == 1 and reg.groups[0].stream_ids[3].startswith("__pad")
    reg.add_stream("d")
    assert reg.groups[0].stream_ids == ["a", "b", "c", "d"]
    with pytest.raises(RuntimeError, match="capacity"):
        reg.add_stream("e")


def test_golden_cluster_sparse_raw_reproduced():
    from tests.golden.generate_golden import GOLDEN_SPARSE_PATH, Q16_ROWS
    from rtap_tpu_torch.config import cluster_preset as p_cluster_preset
    from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_stream

    base = p_cluster_preset(perm_bits=16)
    cfg = dataclasses.replace(base, likelihood=dataclasses.replace(base.likelihood, mode="window"))
    s = generate_stream(
        "golden.cpu",
        SyntheticStreamConfig(length=Q16_ROWS, n_anomalies=1, kinds=("level_shift",),
                              anomaly_magnitude=6.0, noise_phi=0.97, noise_scale=0.5,
                              inject_after_frac=cfg.likelihood.safe_inject_frac(Q16_ROWS)),
        seed=33,
    )
    grp = StreamGroup(cfg, ["golden.cpu"], seed=0, device="cpu")
    raw, loglik, _ = grp.run_chunk(s.values[:, None], s.timestamps[:, None])
    golden = np.load(GOLDEN_SPARSE_PATH)
    np.testing.assert_array_equal(raw[:, 0].astype(np.float64), golden["raw"])
    np.testing.assert_allclose(loglik[:, 0], golden["loglik"], rtol=0, atol=1e-9)


def test_replay_cli_on_cpu(capsys):
    from rtap_tpu_torch.__main__ import main

    assert main(["replay", "--device", "cpu", "--nodes", "1", "--length", "80",
                 "--chunk-ticks", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["streams"] == 3 and out["ticks"] == 80 and out["scored"] == 240
    assert out["tm_overflow_total"] == 0 and out["device"] == "cpu"


def test_entry_points_raise_without_cuda(monkeypatch):
    from rtap_tpu_torch.__main__ import main
    from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_cluster
    from rtap_tpu_torch.service.replay import replay_streams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.from_dict(cluster_preset().to_dict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamGroup(cfg, ["a"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamGroupRegistry(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay_streams(generate_cluster(1, cfg=SyntheticStreamConfig(length=80)), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["replay", "--nodes", "1", "--length", "80"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamGroup(cfg, ["a"], device="cpu", mesh=object())
