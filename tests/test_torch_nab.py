"""PyTorch port vs the JAX package: the NAB corpus loader, scorer and runner.

* ``load_corpus`` of the committed stand-in corpus is array-equal to the JAX
  package's; ``write_corpus`` round-trips.
* ``optimize_threshold`` and ``score_corpus`` equal the JAX package's for the
  three profiles (the null detector scores 0.0, the perfect one 100.0).
* ``detect_files_batched`` against the JAX one at ``golden_config()`` on a
  2-file mini corpus: raw equal, loglik within 1e-12; the per-file path
  (``HTMModel``) within 1e-9 of the batched one (the batched likelihood's
  rounding, as the JAX package's own test holds it); unequal lengths pad.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from rtap_tpu.data import nab_corpus as jcorpus
from rtap_tpu.nab import scorer as jscorer
from rtap_tpu.nab.runner import detect_files_batched as j_batched
from rtap_tpu.service.registry import StreamGroup as JStreamGroup
from rtap_tpu_torch.config import ModelConfig, rdse_resolution
from rtap_tpu_torch.data.nab_corpus import NabFile, load_corpus, write_corpus
from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_stream
from rtap_tpu_torch.nab import scorer
from rtap_tpu_torch.nab.runner import detect_file, detect_files_batched
from tests.golden.generate_golden import golden_config

torch.set_num_threads(1)

CORPUS = Path(__file__).resolve().parent.parent / "data" / "nab"
JCFG = golden_config()
CFG = ModelConfig.from_dict(JCFG.to_dict())
ROWS = 128  # past golden_config's 90-row likelihood probation; 2 chunks of 64


def _mini_corpus(n_files=2, rows=ROWS):
    files = []
    for i in range(n_files):
        s = generate_stream(f"int{i}.cpu", SyntheticStreamConfig(
            length=rows, cadence_s=300.0, n_anomalies=1, anomaly_magnitude=8.0,
            noise_scale=0.35, kinds=("spike",), inject_after_frac=0.5), seed=21 + i)
        files.append(NabFile(f"it/int{i}.csv", s.timestamps, s.values * (1 + 3 * i), s.windows))
    return files


def test_load_corpus_matches_jax(tmp_path):
    mine, ref = load_corpus(CORPUS), jcorpus.load_corpus(CORPUS)
    assert [f.name for f in mine] == [f.name for f in ref] and len(mine) == 8
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_array_equal(a.values, b.values)
        assert a.values.dtype == b.values.dtype and a.windows == b.windows
    assert sum(len(f.values) for f in mine) == 32256
    write_corpus(tmp_path, mine[:2])
    back = load_corpus(tmp_path)
    assert [f.windows for f in back] == [f.windows for f in mine[:2]]
    np.testing.assert_array_equal(back[0].timestamps, mine[0].timestamps)
    assert load_corpus(CORPUS, subset="synthetic")[0].name == "synthetic/node_latency_burst.csv"


def test_standin_corpus_regenerates_the_committed_one(tmp_path):
    from rtap_tpu_torch.data.nab_corpus import ensure_standin_corpus

    root = ensure_standin_corpus(tmp_path / "nab")
    assert ensure_standin_corpus(root) == root  # present: left as it is
    for a, b in zip(load_corpus(root), load_corpus(CORPUS), strict=True):
        assert a.name == b.name and a.windows == b.windows
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("profile", sorted(scorer.PROFILES))
def test_optimize_threshold_matches_jax(profile):
    files = load_corpus(CORPUS)
    rng = np.random.default_rng(1)
    null = [(np.zeros(len(f.values)), f.timestamps, f.windows) for f in files]
    perfect = []
    for f in files:
        s = np.zeros(len(f.values))
        for a, _ in f.windows:
            s[np.nonzero(f.timestamps >= a)[0][0]] = 1.0
        perfect.append((s, f.timestamps, f.windows))
    noisy = [(np.round(rng.random(len(f.values)), 2), f.timestamps, f.windows) for f in files]
    noisy[0][0][5] = np.nan
    mine, ref = scorer.PROFILES[profile], jscorer.PROFILES[profile]
    assert scorer.optimize_threshold(null, mine)[1] == 0.0
    assert scorer.optimize_threshold(perfect, mine)[1] == pytest.approx(100.0)
    for per_file in (null, perfect, noisy):
        got = scorer.optimize_threshold(per_file, mine)
        assert got == jscorer.optimize_threshold(per_file, ref)
        assert scorer.score_corpus(per_file, got[0], mine) == \
            jscorer.score_corpus(per_file, got[0], ref)


def _jax_batched(files):
    """The JAX package's detect_files_batched (equal-length files), with
    raw as well -> (raw per file, loglik per file)."""
    import jax.numpy as jnp

    grp = JStreamGroup(JCFG, [f.name for f in files], seed=0, backend="tpu")
    res = np.array([rdse_resolution(float(np.nanmin(f.values)), float(np.nanmax(f.values)))
                    for f in files], np.float32)[:, None]
    grp.state = {**grp.state, "enc_resolution": jnp.asarray(res)}
    vals = np.stack([f.values for f in files], 1)
    ts = np.stack([f.timestamps for f in files], 1)
    outs = [grp.run_chunk(vals[t:t + 64], ts[t:t + 64]) for t in range(0, len(vals), 64)]
    raw, loglik = (np.concatenate([o[i] for o in outs]) for i in (0, 1))
    return list(raw.T), list(loglik.T)


def test_batched_matches_jax_and_per_file():
    """Equal-length files: raw equal to the JAX package's, loglik within
    1e-12; the port's per-file path within 1e-9 of its batched one."""
    from rtap_tpu_torch.nab.runner import _detect_batched

    files = _mini_corpus()
    raw, loglik, _ = _detect_batched(files, CFG, 0, 64, "cpu")
    for r, jr, ll, jll in zip(raw, *_jax_batched(files), loglik):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_allclose(ll, jll, rtol=0, atol=1e-12)
        assert np.unique(ll).size > 1
    per_file = detect_file(files[1], CFG, device="cpu")
    np.testing.assert_allclose(per_file, loglik[1], rtol=0, atol=1e-9)


def test_batched_pads_unequal_lengths():
    """A shorter file pads with NaN on its continued cadence: scores only
    for its real rows, the same as the JAX package's, and the longer file's
    scores untouched by its neighbour's padding."""
    files = _mini_corpus()
    files[1] = NabFile(files[1].name, files[1].timestamps[:100], files[1].values[:100],
                       files[1].windows)
    out = detect_files_batched(files, CFG, device="cpu")
    assert [len(s) for s in out] == [ROWS, 100] and all(np.isfinite(s).all() for s in out)
    for got, want in zip(out, j_batched(files, JCFG)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    alone = detect_files_batched(files[:1], CFG, device="cpu")[0]
    np.testing.assert_array_equal(out[0], alone)
