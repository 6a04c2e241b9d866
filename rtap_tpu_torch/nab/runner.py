"""NAB corpus runner: the detector over every file -> optimized corpus scores.

Port of the JAX package's ``nab/runner.py`` (NAB's ``run.py --detect
--score --normalize``): one fresh detector per corpus file, sized to that
file's value range as NAB does, detection scores (log-likelihood) per row,
then one corpus-wide threshold sweep per cost profile.

Two paths compute the same per-file scores:

- batched (the default, :func:`detect_files_batched`): every file is one
  stream of ONE stream group on the device (``cuda`` unless given), each
  with its own encoder resolution (runtime state, ``enc_resolution``);
  shorter files are padded with NaN (the encoder's missing-sample path) on
  a continued cadence and the padded rows are dropped from the result;
- per file (:func:`detect_file`): an ``AnomalyDetector`` (models/htm_model.py)
  per file, optionally one spawned process per file.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
from dataclasses import dataclass

import numpy as np

from rtap_tpu_torch.config import ModelConfig, nab_preset, rdse_resolution
from rtap_tpu_torch.data.nab_corpus import NabFile
from rtap_tpu_torch.nab.scorer import PROFILES, optimize_threshold

PROFILE_NAMES = ("standard", "reward_low_FP", "reward_low_FN")


@dataclass
class NabRunResult:
    scores: dict[str, tuple[float, float]]  # profile -> (best_threshold, score)
    per_file: list[tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]]
    raw: list[np.ndarray] | None = None  # per-file raw scores (batched path)
    group: object | None = None  # the batched path's StreamGroup, final state


def _value_range(nf: NabFile) -> tuple[float, float]:
    # nan-aware: a missing sample must not poison the encoder resolution
    return float(np.nanmin(nf.values)), float(np.nanmax(nf.values))


def _file_range_config(nf: NabFile, base_cfg: ModelConfig | None) -> ModelConfig:
    lo, hi = _value_range(nf)
    if base_cfg is None:
        return nab_preset(lo, hi)
    # rescale only the encoder resolution to this file's range, NAB-style
    res = rdse_resolution(lo, hi)
    return dataclasses.replace(base_cfg, rdse=dataclasses.replace(base_cfg.rdse, resolution=res))


def detect_file(nf: NabFile, cfg: ModelConfig | None = None, device=None,
                seed: int = 0) -> np.ndarray:
    """One detector over one file -> detection scores (log-likelihood) [T]."""
    from rtap_tpu_torch.models.htm_model import AnomalyDetector

    det = AnomalyDetector(_file_range_config(nf, cfg), device=device, seed=seed)
    out = np.zeros(len(nf.values), np.float64)
    for i, (t, v) in enumerate(zip(nf.timestamps, nf.values)):
        out[i], _ = det.handle_record(int(t), float(v))
    return out


def _detect_batched(files: list[NabFile], cfg: ModelConfig | None, seed: int,
                    chunk_ticks: int, device):
    """Every file as one stream of one group -> (raw per file, loglik per
    file, the group)."""
    from rtap_tpu_torch.service.registry import StreamGroup

    n = len(files)
    T = max(len(f.values) for f in files)
    base = cfg if cfg is not None else nab_preset(0.0, 100.0)
    grp = StreamGroup(base, [f.name for f in files], seed=seed, device=device)
    res = np.array([rdse_resolution(*_value_range(f)) for f in files], np.float32)
    grp.set_enc_resolution(res[:, None].repeat(base.n_fields, axis=1))

    vals = np.full((T, n), np.nan, np.float32)
    ts = np.zeros((T, n), np.int64)
    for g, f in enumerate(files):
        L = len(f.values)
        vals[:L, g] = f.values
        ts[:L, g] = f.timestamps
        if L < T:  # continue the file's cadence so the date encoder stays sane
            step = int(np.median(np.diff(f.timestamps))) if L > 1 else 1
            ts[L:, g] = f.timestamps[-1] + np.arange(1, T - L + 1) * max(step, 1)

    raw = np.empty((T, n), np.float32)
    loglik = np.empty((T, n))
    for t0 in range(0, T, chunk_ticks):
        t1 = min(t0 + chunk_ticks, T)
        raw[t0:t1], loglik[t0:t1], _ = grp.run_chunk(vals[t0:t1], ts[t0:t1])
    cut = [len(f.values) for f in files]
    return ([raw[:L, g] for g, L in enumerate(cut)], [loglik[:L, g] for g, L in enumerate(cut)],
            grp)


def detect_files_batched(files: list[NabFile], cfg: ModelConfig | None = None, seed: int = 0,
                         chunk_ticks: int = 64, device=None) -> list[np.ndarray]:
    """Every corpus file as one stream of ONE stream group on `device` ->
    detection scores (log-likelihood) per file, the padded rows dropped.
    Per-file scores equal :func:`detect_file`'s up to the batched
    likelihood's float rounding."""
    return _detect_batched(files, cfg, seed, chunk_ticks, device)[1]


def _detect_star(args):
    return detect_file(*args)


def run_corpus(files: list[NabFile], cfg: ModelConfig | None = None, device=None,
               seed: int = 0, batched: bool = True, processes: int = 1,
               profiles: tuple[str, ...] = PROFILE_NAMES) -> NabRunResult:
    """Detect, score and normalize over a corpus (NAB run.py analog).
    `batched` puts every file into one group on `device`; otherwise one
    detector per file, in `processes` spawned processes when > 1."""
    raw = grp = None
    if batched:
        raw, scores, grp = _detect_batched(files, cfg, seed, 64, device)
    elif processes > 1:
        import torch

        # the workers share this process's intra-op threads between them
        threads = max(1, torch.get_num_threads() // processes)
        with mp.get_context("spawn").Pool(processes, initializer=torch.set_num_threads,
                                          initargs=(threads,)) as pool:
            scores = pool.map(_detect_star, [(nf, cfg, device, seed) for nf in files])
    else:
        scores = [detect_file(nf, cfg, device, seed) for nf in files]
    per_file = [(s, nf.timestamps, nf.windows) for s, nf in zip(scores, files)]
    results = {p: optimize_threshold(per_file, PROFILES[p]) for p in profiles}
    return NabRunResult(results, per_file, raw, grp)
