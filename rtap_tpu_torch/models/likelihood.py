"""Anomaly likelihood of one stream: a rolling-Gaussian tail post-process
on the host (numpy).

A copy of the JAX package's ``models/oracle/likelihood.py`` (the port keeps
its own, and imports nothing of the JAX package): raw anomaly scores are
smoothed with a short moving average; a Gaussian is periodically refit to
the moving-averaged scores over a long historic window; the reported
likelihood is 1 - Q(shortTermAverage), log-scaled to spread the top of the
range. During the probationary period the output is a noncommittal 0.5
(log score 0).

``mode="streaming"`` replaces the historic window with exponentially
decayed moments (O(1) memory per stream); the window mode is the default.
The stream-group form is service/likelihood_batch.py.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

from rtap_tpu_torch.config import LikelihoodConfig

# NuPIC's log-scale constant: log(1.0000000001 - x) / log(1e-10)
_LOG_DENOM = math.log(1e-10)


def tail_probability(z: float) -> float:
    """Gaussian upper-tail Q(z) via erfc."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def log_likelihood(likelihood: float) -> float:
    """NuPIC's log scale: 0.5 -> ~0.03, 0.9999 -> ~0.4, 1-1e-10 -> 1.0."""
    return math.log(1.0000000001 - likelihood) / _LOG_DENOM


class AnomalyLikelihood:
    """Per-stream likelihood state machine (single stream; the service layer
    vectorizes a batch variant in service/likelihood_batch.py)."""

    def __init__(self, cfg: LikelihoodConfig):
        self.cfg = cfg
        self.records = 0
        self.scores: deque[float] = deque(maxlen=cfg.historic_window_size)
        self.recent: deque[float] = deque(maxlen=cfg.averaging_window)
        self.mean = 0.0
        self.std = 1.0
        self.have_distribution = False
        # streaming-mode moments of the averaged score
        self._s0 = 0.0
        self._s1 = 0.0
        self._s2 = 0.0

    def _refit_window(self) -> None:
        scores = np.asarray(self.scores, np.float64)
        # NuPIC skips the model's learning-period records when fitting: early
        # scores are dominated by an untrained TM (raw ~1.0) and would inflate
        # sigma for the rest of the stream.
        still_buffered = max(0, self.cfg.learning_period - (self.records - len(scores)))
        if still_buffered:
            scores = scores[still_buffered:]
        if len(scores) < 2:
            return
        w = self.cfg.averaging_window
        kernel = np.ones(w) / w
        averaged = np.convolve(scores, kernel, mode="valid") if len(scores) >= w else scores
        self.mean = float(averaged.mean())
        self.std = max(float(averaged.std()), 1e-6)
        self.have_distribution = True

    def _update_streaming(self, avg: float) -> None:
        d = self.cfg.streaming_decay
        self._s0 = d * self._s0 + 1.0
        self._s1 = d * self._s1 + avg
        self._s2 = d * self._s2 + avg * avg
        self.mean = self._s1 / self._s0
        var = max(self._s2 / self._s0 - self.mean**2, 0.0)
        self.std = max(math.sqrt(var), 1e-6)
        self.have_distribution = self.records >= self.cfg.probationary_period

    # what this state machine persists (HTMModel.save writes it as lik_*;
    # the same keys as the JAX package's, so either package reads the other's)
    def state_dict(self) -> dict:
        return {
            "records": np.asarray(self.records, np.int64),
            "have_distribution": np.asarray(int(self.have_distribution), np.int64),
            "scalars": np.array(
                [self.mean, self.std, self._s0, self._s1, self._s2], np.float64
            ),
            "scores": np.asarray(self.scores, np.float64),
            "recent": np.asarray(self.recent, np.float64),
        }

    def load_state_dict(self, d: dict) -> None:
        self.records = int(d["records"])
        self.have_distribution = bool(d["have_distribution"])
        self.mean, self.std, self._s0, self._s1, self._s2 = (
            float(x) for x in d["scalars"]
        )
        self.scores = deque(d["scores"].tolist(), maxlen=self.cfg.historic_window_size)
        self.recent = deque(d["recent"].tolist(), maxlen=self.cfg.averaging_window)

    def update(self, raw_score: float) -> tuple[float, float]:
        """Feed one raw anomaly score -> (likelihood, log_likelihood)."""
        self.records += 1
        self.recent.append(raw_score)
        avg = sum(self.recent) / len(self.recent)

        if self.cfg.mode == "streaming":
            self._update_streaming(avg)
        else:
            self.scores.append(raw_score)
            if self.records % self.cfg.reestimation_period == 0 or not self.have_distribution:
                if self.records >= self.cfg.probationary_period:
                    self._refit_window()

        if self.records < self.cfg.probationary_period or not self.have_distribution:
            return 0.5, log_likelihood(0.5)
        lik = 1.0 - tail_probability((avg - self.mean) / self.std)
        return lik, log_likelihood(lik)
