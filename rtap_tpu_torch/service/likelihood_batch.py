"""Vectorized anomaly likelihood over a stream group (host side).

A numpy copy of the JAX package's ``service/likelihood_batch.py`` (the port
imports nothing of that package); the two give the same bits.

Semantically identical to the per-stream oracle
(models/oracle/likelihood.py, itself faithful to NuPIC's
anomaly_likelihood.py — SURVEY.md C8) but runs all G streams of a group in
lockstep with numpy array ops, so the host post-process stays negligible next
to the device step even at 100k streams (SURVEY.md §7 hard part 5).

Lockstep is the group invariant: every stream in a group receives a score
every tick, so the record count, ring-buffer cursor, and refit schedule are
scalars shared by the whole batch. Floating-point note: batch reductions
(np.sum/np.mean along an axis) may round differently from the oracle's
sequential Python sums by ~1 ulp; parity tests use rel tolerances, not
bit-equality.
"""

from __future__ import annotations

import math

import numpy as np

from rtap_tpu_torch.config import LikelihoodConfig

# NuPIC's log-scale constant: log(1.0000000001 - x) / log(1e-10)
_LOG_DENOM = np.log(1e-10)


# numpy ships no erfc ufunc and scipy is unavailable here. A frompyfunc over
# math.erfc measured 14 ms/tick at G=100k on the 1-core host (reports/
# likelihood_100k.json) — 14% of the tick's 100 ms share of the 1 s budget —
# so the production path is a vectorized W. J. Cody rational approximation
# (the CALERF algorithm behind most libm erfc implementations), accurate to
# ~1e-16 relative against math.erfc (pinned by
# tests/unit/test_likelihood_model.py::test_vector_erfc_matches_libm).
_SQRT2 = math.sqrt(2.0)

# Cody branch 1 (|x| <= 0.46875): erf(x) = x * P1(x^2)/Q1(x^2)
_ERF_A = (3.16112374387056560e0, 1.13864154151050156e2,
          3.77485237685302021e2, 3.20937758913846947e3,
          1.85777706184603153e-1)
_ERF_B = (2.36012909523441209e1, 2.44024637934444173e2,
          1.28261652607737228e3, 2.84423683343917062e3)
# branch 2 (0.46875 < x <= 4): erfc(x) = exp(-x^2) * P2(x)/Q2(x)
_ERF_C = (5.64188496988670089e-1, 8.88314979438837594e0,
          6.61191906371416295e1, 2.98635138197400131e2,
          8.81952221241769090e2, 1.71204761263407058e3,
          2.05107837782607147e3, 1.23033935479799725e3,
          2.15311535474403846e-8)
_ERF_D = (1.57449261107098347e1, 1.17693950891312499e2,
          5.37181101862009858e2, 1.62138957456669019e3,
          3.29079923573345963e3, 4.36261909014324716e3,
          3.43936767414372164e3, 1.23033935480374942e3)
# branch 3 (x > 4): erfc(x) = exp(-x^2)/x * (1/sqrt(pi) - P3(z)/Q3(z)/x^2),
# z = 1/x^2
_ERF_P = (3.05326634961232344e-1, 3.60344899949804439e-1,
          1.25781726111229246e-1, 1.60837851487422766e-2,
          6.58749161529837803e-4, 1.63153871373020978e-2)
_ERF_Q = (2.56852019228982242e0, 1.87295284992346047e0,
          5.27905102951428412e-1, 6.05183413124413191e-2,
          2.33520497626869185e-3)
_SQRPI = 5.6418958354775628695e-1  # 1/sqrt(pi)


def _erfc_tail(y: np.ndarray) -> np.ndarray:
    """erfc on |x| > 0.46875 (Cody branches 2/3), y = |x| within range."""
    # both branches share the exp(-y^2) split: ysq = trunc(16y)/16 keeps the
    # squared term exactly representable, dely catches the residual
    yc = np.minimum(y, 30.0)  # erfc underflows to 0 well before 30
    ysq = np.trunc(yc * 16.0) / 16.0
    expterm = np.exp(-ysq * ysq) * np.exp(-(yc - ysq) * (yc + ysq))

    mid = yc <= 4.0
    out = np.empty_like(yc)
    y2 = yc[mid]
    num = _ERF_C[8] * y2
    den = y2.copy()
    for i in range(7):
        num = (num + _ERF_C[i]) * y2
        den = (den + _ERF_D[i]) * y2
    out[mid] = expterm[mid] * (num + _ERF_C[7]) / (den + _ERF_D[7])

    big = ~mid
    if big.any():
        y3 = yc[big]
        z3 = 1.0 / (y3 * y3)
        num = _ERF_P[5] * z3
        den = z3.copy()
        for i in range(4):
            num = (num + _ERF_P[i]) * z3
            den = (den + _ERF_Q[i]) * z3
        r3 = z3 * (num + _ERF_P[4]) / (den + _ERF_Q[4])
        out[big] = expterm[big] * (_SQRPI - r3) / y3
    return out


def erfc_np(x: np.ndarray) -> np.ndarray:
    """Vectorized double-precision erfc (Cody's CALERF rational
    approximations), elementwise over any-shape float64 input. Branches
    evaluate on compressed subsets — for the Gaussian-z inputs of the
    likelihood path nearly everything lands in branches 1/2."""
    x = np.asarray(x, np.float64)
    y = np.abs(x)
    out = np.empty_like(y)

    small = y <= 0.46875
    z1 = y[small] ** 2
    num = _ERF_A[4] * z1
    den = z1.copy()
    for i in range(3):
        num = (num + _ERF_A[i]) * z1
        den = (den + _ERF_B[i]) * z1
    out[small] = 1.0 - y[small] * (num + _ERF_A[3]) / (den + _ERF_B[3])

    tail = ~small
    if tail.any():
        out[tail] = _erfc_tail(y[tail])
    return np.where(x < 0.0, 2.0 - out, out)


def tail_probability_np(z: np.ndarray) -> np.ndarray:
    """Gaussian upper-tail Q(z) = 0.5*erfc(z/sqrt(2)), elementwise."""
    return 0.5 * erfc_np(z / _SQRT2)


def log_likelihood_np(lik: np.ndarray) -> np.ndarray:
    return np.log(1.0000000001 - lik) / _LOG_DENOM


class BatchAnomalyLikelihood:
    """Likelihood state for G lockstep streams.

    `update(raw [G]) -> (likelihood [G], log_likelihood [G])`.
    """

    # Window mode's [G, W] f64 ring is the one host allocation that scales
    # with BOTH stream count and window size: G=100k x W=8640 = 6.9 GB.
    # Above the soft limit we warn; above the hard limit (env-overridable,
    # GiB) we refuse — streaming mode exists precisely for that regime
    # (SURVEY.md §7 hard part 5).
    RING_WARN_BYTES = 1 << 30

    def __init__(self, cfg: LikelihoodConfig, group_size: int):
        self.cfg = cfg
        self.G = int(group_size)
        self.records = 0
        # per-slot birth record count: slots claimed mid-run (dynamic stream
        # registration, C19 lazy-creation parity) restart THEIR probation
        # clock while the group's lockstep cursor keeps running. age of slot
        # g = records - birth[g]; 0 for original members.
        self.birth = np.zeros(self.G, np.int64)
        # short moving-average ring [G, w]
        self.recent = np.zeros((self.G, cfg.averaging_window), np.float64)
        self.mean = np.zeros(self.G, np.float64)
        self.std = np.ones(self.G, np.float64)
        self.have_distribution = False
        if cfg.mode == "streaming":
            self._s0 = np.zeros(self.G, np.float64)
            self._s1 = np.zeros(self.G, np.float64)
            self._s2 = np.zeros(self.G, np.float64)
            self.scores = None
        else:
            import logging
            import os

            ring_bytes = 8 * self.G * cfg.historic_window_size
            cap_gib = float(os.environ.get("RTAP_MAX_LIKELIHOOD_RING_GB", "8"))
            if ring_bytes > cap_gib * (1 << 30):
                raise ValueError(
                    f"window-mode likelihood ring would be "
                    f"{ring_bytes / (1 << 30):.1f} GiB host RAM for G={self.G} "
                    f"x W={cfg.historic_window_size} (cap {cap_gib:g} GiB; "
                    "RTAP_MAX_LIKELIHOOD_RING_GB to raise). Use "
                    "mode='streaming' at this stream count."
                )
            if ring_bytes > self.RING_WARN_BYTES:
                logging.getLogger(__name__).warning(
                    "window-mode likelihood ring: %.1f GiB host RAM (G=%d, W=%d); "
                    "consider mode='streaming' at scale",
                    ring_bytes / (1 << 30), self.G, cfg.historic_window_size,
                )
            # historic window ring [G, W]; cursor/fill shared (lockstep)
            self.scores = np.zeros((self.G, cfg.historic_window_size), np.float64)

    # ---- dynamic membership ----
    def reset_slot(self, g: int) -> None:
        """Re-initialize one slot for a stream claimed mid-run: fresh
        moments/rings and a probation clock starting NOW. Streaming mode
        reproduces a fresh stream's outputs exactly (per-stream EMA
        moments); window mode masks the slot's pre-birth ring entries out
        of its Gaussian refit (`_refit_window`), so its distribution is
        fit from its OWN scores only — refit *times* stay on the group's
        lockstep clock, the one (documented) difference from a standalone
        fresh stream."""
        self.birth[g] = self.records
        self.recent[g] = 0.0
        self.mean[g] = 0.0
        self.std[g] = 1.0
        if self.scores is None:
            self._s0[g] = self._s1[g] = self._s2[g] = 0.0
        else:
            self.scores[g] = 0.0

    # ---- checkpointing ----
    def state_dict(self) -> dict[str, np.ndarray]:
        d = {
            # 0-d arrays, not numpy scalars: orbax has no TypeHandler for the
            # scalar types (np.bool_/np.int64)
            "records": np.asarray(self.records, np.int64),
            "birth": self.birth,
            "recent": self.recent,
            "mean": self.mean,
            "std": self.std,
            "have_distribution": np.asarray(self.have_distribution),
        }
        if self.scores is not None:
            d["scores"] = self.scores
        else:
            d.update(s0=self._s0, s1=self._s1, s2=self._s2)
        return d

    def load_state_dict(self, d: dict[str, np.ndarray]) -> None:
        self.records = int(d["records"])
        # pre-dynamic-membership checkpoints lack birth: zeros (all slots
        # are founding members) reproduces the old behavior exactly
        self.birth = (np.asarray(d["birth"], np.int64) if "birth" in d
                      else np.zeros(self.G, np.int64))
        self.recent = np.asarray(d["recent"], np.float64)
        self.mean = np.asarray(d["mean"], np.float64)
        self.std = np.asarray(d["std"], np.float64)
        self.have_distribution = bool(d["have_distribution"])
        if self.scores is not None:
            self.scores = np.asarray(d["scores"], np.float64)
        else:
            self._s0, self._s1, self._s2 = (
                np.asarray(d["s0"], np.float64),
                np.asarray(d["s1"], np.float64),
                np.asarray(d["s2"], np.float64),
            )

    # ---- the per-tick update ----
    def _refit_window(self) -> None:
        n = min(self.records, self.cfg.historic_window_size)
        # ring -> chronological [G, n]
        cur = self.records % self.cfg.historic_window_size
        if self.records <= self.cfg.historic_window_size:
            scores = self.scores[:, :n]
        else:
            scores = np.concatenate([self.scores[:, cur:], self.scores[:, :cur]], axis=1)
        # skip records from the model's learning period (oracle._refit_window)
        still_buffered = max(0, self.cfg.learning_period - (self.records - n))
        if still_buffered:
            scores = scores[:, still_buffered:]
        if scores.shape[1] < 2:
            return
        w = self.cfg.averaging_window
        if scores.shape[1] >= w:
            # moving average over trailing window (the oracle's convolve
            # "valid" mode), via cumulative sums
            csum = np.cumsum(np.pad(scores * (1.0 / w), ((0, 0), (1, 0))), axis=1)
            averaged = csum[:, w:] - csum[:, :-w]
        else:
            averaged = scores
        if not self.birth.any():
            # founding-members fast path, bit-identical to the original
            self.mean = averaged.mean(axis=1)
            self.std = np.maximum(averaged.std(axis=1), 1e-6)
            self.have_distribution = True
            return
        # per-slot masking for claimed slots: chronological entries before
        # a slot's birth are reset zeros, and the slot's FIRST
        # learning_period own scores are its untrained model's learning
        # transient (near-1.0 raws) — the oracle excludes exactly that
        # window for a fresh stream ("would inflate sigma"), so the
        # claimed slot must too. An averaged entry is valid iff its whole
        # w-window lies at/after birth + learning_period. For founding
        # members (birth 0) this reduces to <= 0 — identical to the
        # global still_buffered trim, hence the fast path above. Slots
        # with <2 valid entries keep their previous (reset: 0/1) moments —
        # the young mask pins them to 0.5 through probation anyway.
        chrono_start = self.records - n + still_buffered
        p = np.maximum(
            self.birth + self.cfg.learning_period - chrono_start, 0)
        idx = np.arange(averaged.shape[1])[None, :]
        valid = idx >= p[:, None]
        cnt = valid.sum(axis=1)
        safe = np.maximum(cnt, 1)
        mean_new = (averaged * valid).sum(axis=1) / safe
        var = (((averaged - mean_new[:, None]) ** 2) * valid).sum(axis=1) / safe
        std_new = np.maximum(np.sqrt(var), 1e-6)
        ok = cnt >= 2
        self.mean = np.where(ok, mean_new, self.mean)
        self.std = np.where(ok, std_new, self.std)
        self.have_distribution = True

    def _update_streaming(self, avg: np.ndarray) -> None:
        d = self.cfg.streaming_decay
        self._s0 = d * self._s0 + 1.0
        self._s1 = d * self._s1 + avg
        self._s2 = d * self._s2 + avg * avg
        self.mean = self._s1 / self._s0
        var = np.maximum(self._s2 / self._s0 - self.mean**2, 0.0)
        self.std = np.maximum(np.sqrt(var), 1e-6)
        self.have_distribution = self.records >= self.cfg.probationary_period

    def update(self, raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Feed one tick of raw scores [G] -> (likelihood [G], log_lik [G])."""
        raw = np.asarray(raw, np.float64)
        w = self.cfg.averaging_window
        self.recent[:, self.records % w] = raw
        self.records += 1
        if not self.birth.any():
            # founding-members fast path: bit-identical to the original
            # lockstep logic (all slots share one age)
            n_recent = min(self.records, w)
            if self.records < w:
                avg = self.recent[:, :n_recent].sum(axis=1) / n_recent
            else:
                avg = self.recent.sum(axis=1) / w
        else:
            # per-slot age: a claimed slot's ring was zeroed at birth, so
            # the full-ring sum is the sum of its own samples; dividing by
            # min(age, w) reproduces a fresh stream's moving average
            # (for birth=0 slots this equals the fast path up to summation
            # order). Same lockstep cursor, per-slot maturity.
            age = np.minimum(self.records - self.birth, w)
            avg = self.recent.sum(axis=1) / np.maximum(age, 1)

        if self.cfg.mode == "streaming":
            self._update_streaming(avg)
        else:
            self.scores[:, (self.records - 1) % self.cfg.historic_window_size] = raw
            if self.records % self.cfg.reestimation_period == 0 or not self.have_distribution:
                if self.records >= self.cfg.probationary_period:
                    self._refit_window()

        if self.records < self.cfg.probationary_period or not self.have_distribution:
            half = np.full(self.G, 0.5)
            return half, log_likelihood_np(half)
        lik = 1.0 - tail_probability_np((avg - self.mean) / self.std)
        # per-slot probation: slots claimed mid-run (birth > 0) are pinned
        # to 0.5 until THEIR OWN age clears the probationary period — a
        # late-joining stream must not be scored against moments it has
        # not yet established (same contract as a founding member's)
        young = (self.records - self.birth) < self.cfg.probationary_period
        if young.any():
            lik = np.where(young, 0.5, lik)
        return lik, log_likelihood_np(lik)
