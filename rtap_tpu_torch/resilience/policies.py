"""Retry + circuit-breaker policies for the serve stack's IO edges.

The port's copy of the JAX package's ``resilience/policies.py``. An
exporter that times out, an alert sink on a full disk or a flapping TCP
peer is THAT edge's problem, never the loop's:

- :class:`Retry` — bounded attempts with exponential backoff + seeded
  jitter (``random.Random(seed)``: same seed, same delay schedule).
- :class:`CircuitBreaker` — per-endpoint closed/open/half-open gate: after
  ``fail_threshold`` consecutive failures the endpoint is skipped outright
  until ``cooldown_s`` passes; one half-open probe then decides.

Both emit through ``rtap_tpu_torch.obs`` (retry attempts, breaker
transitions, short-circuited calls).
"""

from __future__ import annotations

import random
import time
from typing import Callable

from rtap_tpu_torch.obs import get_registry

__all__ = ["CircuitBreaker", "Retry"]


class Retry:
    """Bounded retry with exponential backoff and seeded jitter.

    ``attempts`` counts TOTAL tries (1 = no retry). Delay before retry i
    (1-based) is ``min(base_delay_s * 2**(i-1), max_delay_s)`` plus a
    uniform jitter of up to ``jitter`` of that delay — jitter decorrelates
    a fleet of producers hammering a recovering endpoint in lockstep.
    The jitter PRNG is private and seeded: same seed, same schedule
    (chaos runs and tests depend on it; never use the global random).
    """

    def __init__(self, attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, jitter: float = 0.1,
                 seed: int = 0, sleep: Callable[[float], None] = time.sleep,
                 op: str = "unnamed"):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1; got {attempts}")
        if base_delay_s < 0 or max_delay_s < base_delay_s:
            raise ValueError(
                f"need 0 <= base_delay_s <= max_delay_s; got "
                f"{base_delay_s}, {max_delay_s}")
        if not 0 <= jitter <= 1:
            raise ValueError(f"jitter must be in [0, 1]; got {jitter}")
        self.attempts = int(attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.op = op
        self._obs_retries = get_registry().counter(
            "rtap_obs_retry_attempts_total",
            "retries performed after a failed attempt, by operation",
            op=op)

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry `attempt` (1-based), jitter included."""
        d = min(self.base_delay_s * (2.0 ** (attempt - 1)), self.max_delay_s)
        return d * (1.0 + self.jitter * self._rng.random())

    def backoff(self, attempt: int) -> None:
        """Count + sleep the backoff before retry `attempt` — for manual
        retry loops that can't funnel through :meth:`call` (send_jsonl
        tracks partially-delivered batches across attempts)."""
        self._obs_retries.inc()
        self._sleep(self.delay_for(attempt))

    def call(self, fn: Callable, *args,
             retry_on: tuple = (OSError,), **kwargs):
        """Run ``fn`` with up to ``attempts`` tries; re-raises the last
        failure once the budget is exhausted. Only exceptions matching
        ``retry_on`` are retried — anything else propagates immediately
        (a programming error must not be retried into the noise)."""
        for attempt in range(1, self.attempts + 1):
            try:
                return fn(*args, **kwargs)
            except retry_on:
                if attempt == self.attempts:
                    raise
                self.backoff(attempt)


class CircuitBreaker:
    """Per-endpoint closed → open → half-open gate over an IO call.

    States: **closed** (calls flow; ``fail_threshold`` CONSECUTIVE
    failures open it), **open** (calls are short-circuited — `allow()`
    is False — until ``cooldown_s`` of wall clock passes), **half-open**
    (exactly one probe call is allowed; success re-closes, failure
    re-opens and restarts the cooldown). The caller drives it through
    the `allow`/`record_success`/`record_failure` triplet and substitutes
    a degraded result (a NaN tick, a dropped line) while it is open.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, fail_threshold: int = 5, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "unnamed"):
        if fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1; got {fail_threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0; got {cooldown_s}")
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self._clock = clock
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0
        obs = get_registry()
        self._obs_transitions = {
            s: obs.counter(
                "rtap_obs_breaker_transitions_total",
                "circuit-breaker state entries by (breaker, state)",
                breaker=name, state=s)
            for s in (self.OPEN, self.HALF_OPEN, self.CLOSED)
        }
        self._obs_short = obs.counter(
            "rtap_obs_breaker_short_circuits_total",
            "calls skipped because the breaker was open", breaker=name)

    def _transition(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self._obs_transitions[state].inc()

    def allow(self) -> bool:
        """True if a call may proceed now. An open breaker past its
        cooldown moves to half-open and admits ONE probe; the probe's
        record_success/record_failure decides what happens next."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._transition(self.HALF_OPEN)
                return True
            self._obs_short.inc()
            return False
        # half-open: the single probe is already in flight this tick —
        # further calls wait for its verdict
        self._obs_short.inc()
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._transition(self.CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN \
                or self.consecutive_failures >= self.fail_threshold:
            self._opened_at = self._clock()
            self._transition(self.OPEN)
