"""Operator-declared latency SLOs: burn-rate evaluation + budget gauges.

The port's copy of the JAX package's ``obs/slo.py`` (the same grammar,
windows and burn events). ``serve --slo detect=2s@p99`` declares a contract — "99% of alerts must
be delivered within 2 s of their row's source timestamp" — and this
module defends it the way SRE practice defends error budgets
(docs/SLO.md is the runbook):

- every observation (a per-alert detect latency, a per-tick host
  latency) is judged good/bad against the target,
- bad-fraction is tracked over a FAST and a SLOW rolling tick window,
  and the **burn rate** (bad fraction / error budget fraction) over
  both must exceed their thresholds simultaneously before anything
  pages — the multi-window AND that kills both flavors of false alarm
  (a brief spike trips fast-only; a slow drift trips slow-only),
- the page is an **edge-triggered** ``slo_burn`` event on the alert
  stream (one line per episode, with hysteresis: re-arm only after both
  burn rates fall below ``rearm_frac`` of their thresholds), plus a
  flight-recorder postmortem dump so the waterfall that caused the burn
  is captured,
- cumulative budget exhaustion (``slo_budget_exhausted``) fires once
  when the run's total bad fraction overdraws the budget.

Specs parse from the operator grammar ``name=<target><unit>@p<q>``
(``detect=2s@p99``, ``tick=500ms@p95``); malformed specs raise
``ValueError`` with the exact complaint — the serve CLI turns that into
a usage error before any listener starts.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

import numpy as np

from rtap_tpu_torch.obs.metrics import TelemetryRegistry, get_registry

__all__ = ["SloSpec", "SloTracker", "parse_slo", "tick_slo_pair",
           "SLO_STAGES"]

#: stages an SLO may target — the LatencyTracker's sketch vocabulary
#: minus the raw per-phase internals nobody contracts on
SLO_STAGES = ("detect", "tick", "ingest", "dispatch", "collect", "emit")

_SPEC = re.compile(
    r"^(?P<name>[a-z_]+)=(?P<target>\d+(?:\.\d+)?)(?P<unit>ms|s)"
    r"@p(?P<q>\d+(?:\.\d+)?)$")


@dataclass(frozen=True)
class SloSpec:
    name: str  # the stage the SLO contracts on (SLO_STAGES)
    target_s: float  # latency objective in seconds
    quantile: float  # 0 < q < 1 (p99 -> 0.99); budget = 1 - q

    @property
    def budget_frac(self) -> float:
        return 1.0 - self.quantile

    def label(self) -> str:
        from rtap_tpu_torch.obs.latency import qlabel

        t = self.target_s
        ts = f"{t * 1e3:g}ms" if t < 1.0 else f"{t:g}s"
        return f"{self.name}={ts}@{qlabel(self.quantile)}"


def parse_slo(spec: str) -> SloSpec:
    """``detect=2s@p99`` -> SloSpec. Raises ValueError on anything else,
    with a message naming the exact problem (the CLI's usage error)."""
    m = _SPEC.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad SLO spec {spec!r}: expected NAME=<target><ms|s>@p<q>, "
            "e.g. detect=2s@p99 or tick=500ms@p95")
    name = m.group("name")
    if name not in SLO_STAGES:
        raise ValueError(
            f"bad SLO spec {spec!r}: unknown stage {name!r} "
            f"(one of {', '.join(SLO_STAGES)})")
    target = float(m.group("target"))
    if m.group("unit") == "ms":
        target /= 1e3
    if target <= 0:
        raise ValueError(f"bad SLO spec {spec!r}: target must be > 0")
    q = float(m.group("q")) / 100.0
    if not (0.0 < q < 1.0):
        raise ValueError(
            f"bad SLO spec {spec!r}: quantile must be in (0, 100) "
            "exclusive — p100 has no error budget to burn")
    return SloSpec(name=name, target_s=target, quantile=q)


def tick_slo_pair(cadence_s: float, spec: str | None = None):
    """A LatencyTracker + SloTracker armed with a per-tick host-latency
    SLO — THE seeded-soak shape (crash/failover children): synthetic
    feed epochs rule out the wall-anchored detect SLO (docs/SLO.md
    clock contract), so those soaks contract on the tick stage instead.
    Default spec ``tick=<cadence>s@p99``; one helper so the soaks can
    never drift apart on the default/format logic."""
    from rtap_tpu_torch.obs.latency import LatencyTracker

    # :.6f, not str(): a 1e-05-style float repr would fail the grammar
    spec = spec or f"tick={cadence_s:.6f}s@p99"
    latency = LatencyTracker(cadence_s=cadence_s)
    slo = SloTracker([parse_slo(spec)], cadence_s=cadence_s,
                     quantile_source=latency.quantile)
    return latency, slo


class _SloState:
    """One spec's rolling windows + burn state (loop-thread only)."""

    __slots__ = ("spec", "bad_ring", "total_ring", "idx", "filled",
                 "cur_bad", "cur_total", "cum_bad", "cum_total",
                 "burning", "burn_events", "exhausted", "recoveries")

    def __init__(self, spec: SloSpec, slow_window: int):
        self.spec = spec
        self.bad_ring = np.zeros(slow_window, np.int64)
        self.total_ring = np.zeros(slow_window, np.int64)
        self.idx = 0
        self.filled = 0
        self.cur_bad = 0  # accumulating since the last on_tick
        self.cur_total = 0
        self.cum_bad = 0
        self.cum_total = 0
        self.burning = False
        self.burn_events = 0
        self.exhausted = False
        self.recoveries = 0


class SloTracker:
    """Evaluates declared SLOs per tick; emits edge-triggered events.

    ``sink``/``flight`` follow the degradation-controller wiring
    contract (service/loop.py attaches ``AlertWriter.emit_event`` and
    the flight recorder); ``quantile_source`` is
    ``LatencyTracker.quantile`` so the verdict can report the observed
    quantile next to the target. Fast/slow windows are tick counts —
    at the standard 1 s cadence the defaults (60 / 600) are 1 min /
    10 min, scaled down from the SRE-book hours because a serve run is
    minutes-to-hours, not weeks.
    """

    def __init__(self, specs, cadence_s: float = 1.0,
                 fast_window: int = 60, slow_window: int = 600,
                 fast_burn: float = 14.0, slow_burn: float = 6.0,
                 rearm_frac: float = 0.5,
                 registry: TelemetryRegistry | None = None,
                 sink=None, flight=None, quantile_source=None):
        specs = list(specs)
        if not specs:
            raise ValueError("SloTracker needs at least one SloSpec")
        if not (1 <= fast_window <= slow_window):
            raise ValueError(
                f"need 1 <= fast_window <= slow_window; got "
                f"{fast_window}/{slow_window}")
        if fast_burn <= 0 or slow_burn <= 0:
            raise ValueError("burn thresholds must be > 0")
        if not (0.0 < rearm_frac < 1.0):
            raise ValueError(
                f"rearm_frac must be in (0, 1); got {rearm_frac}")
        seen: set[str] = set()
        for s in specs:
            if s.name in seen:
                raise ValueError(f"duplicate SLO for stage {s.name!r}")
            seen.add(s.name)
        self.specs = specs
        self.cadence_s = float(cadence_s)
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.rearm_frac = float(rearm_frac)
        self.sink = sink
        self.flight = flight
        self.quantile_source = quantile_source
        self._states = {s.name: _SloState(s, self.slow_window)
                        for s in specs}
        reg = registry or get_registry()
        self._obs_events = {
            kind: reg.counter(
                "rtap_obs_slo_events_total",
                "SLO guardrail events by kind (edge-triggered; each also "
                "writes one JSONL line on the alert stream)", event=kind)
            for kind in ("slo_burn", "slo_recovered",
                         "slo_budget_exhausted")
        }
        self._obs_bad = {
            s.name: reg.counter(
                "rtap_obs_slo_bad_samples_total",
                "observations that violated their SLO target",
                slo=s.name)
            for s in specs
        }
        self._obs_burn_fast = {
            s.name: reg.gauge(
                "rtap_obs_slo_burn_rate",
                "error-budget burn rate (window bad fraction / budget "
                "fraction); 1.0 = burning exactly at budget",
                slo=s.name, window="fast")
            for s in specs
        }
        self._obs_burn_slow = {
            s.name: reg.gauge(
                "rtap_obs_slo_burn_rate",
                "error-budget burn rate (window bad fraction / budget "
                "fraction); 1.0 = burning exactly at budget",
                slo=s.name, window="slow")
            for s in specs
        }
        self._obs_budget = {
            s.name: reg.gauge(
                "rtap_obs_slo_error_budget_remaining",
                "fraction of the run's error budget left (1 = untouched, "
                "0 = spent, negative = overdrawn)", slo=s.name)
            for s in specs
        }

    # ------------------------------------------------------------ feed --
    def observe(self, stage: str, value_s: float) -> None:
        """Judge one observation against the stage's SLO (no-op for
        stages without one — callers need not know what was declared)."""
        st = self._states.get(stage)
        if st is None:
            return
        st.cur_total += 1
        if value_s > st.spec.target_s:
            st.cur_bad += 1

    def observe_many(self, stage: str, values_s: np.ndarray) -> None:
        st = self._states.get(stage)
        if st is None or values_s.size == 0:
            return
        st.cur_total += int(values_s.size)
        st.cur_bad += int((values_s > st.spec.target_s).sum())

    # ------------------------------------------------------------ tick --
    def _window_frac(self, st: _SloState, window: int) -> float:
        n = min(st.filled, window)
        if n == 0:
            return 0.0
        # the ring index points at the NEXT write slot; the last n
        # entries are the window
        sel = (st.idx - 1 - np.arange(n)) % self.slow_window
        total = int(st.total_ring[sel].sum())
        if total == 0:
            return 0.0
        return int(st.bad_ring[sel].sum()) / total

    def _event(self, kind: str, tick: int, st: _SloState,
               **fields) -> None:
        self._obs_events[kind].inc()
        ev = {"event": kind, "tick": int(tick),
              "slo": st.spec.label(), "stage": st.spec.name, **fields}
        if self.flight is not None:
            self.flight.record_event(ev)
        if self.sink is not None:
            self.sink(ev)

    def on_tick(self, tick: int) -> None:
        """Close the tick's counts into the rings; evaluate burn rates;
        raise/clear edge-triggered events (loop thread, once per tick)."""
        for st in self._states.values():
            if st.cur_bad:
                self._obs_bad[st.spec.name].inc(st.cur_bad)
            st.bad_ring[st.idx] = st.cur_bad
            st.total_ring[st.idx] = st.cur_total
            st.cum_bad += st.cur_bad
            st.cum_total += st.cur_total
            st.cur_bad = st.cur_total = 0
            st.idx = (st.idx + 1) % self.slow_window
            st.filled = min(st.filled + 1, self.slow_window)
            budget = st.spec.budget_frac
            fast = self._window_frac(st, self.fast_window) / budget
            slow = self._window_frac(st, self.slow_window) / budget
            self._obs_burn_fast[st.spec.name].set(round(fast, 4))
            self._obs_burn_slow[st.spec.name].set(round(slow, 4))
            remaining = 1.0 - (
                (st.cum_bad / st.cum_total) / budget if st.cum_total
                else 0.0)
            self._obs_budget[st.spec.name].set(round(remaining, 4))
            # warm-up gate: until the FAST window has filled, a couple
            # of bad first ticks read as burn rates of 10+ over a
            # two-tick "window" — a startup transient, not an episode.
            # Pages (and the exhaustion edge) wait for a full fast
            # window of history; the gauges above publish regardless.
            if st.filled < self.fast_window:
                continue
            # effective thresholds are clamped to what the declared
            # quantile can REACH: burn tops out at 1/budget (bad_frac
            # = 1), so a p90 SLO (max burn 10) against the default
            # fast threshold 14 could never page — clamp to 90%/50%
            # of the ceiling so a total violation always does
            fast_thr = min(self.fast_burn, 0.9 / budget)
            slow_thr = min(self.slow_burn, 0.5 / budget)
            if not st.burning:
                if fast >= fast_thr and slow >= slow_thr:
                    st.burning = True
                    st.burn_events += 1
                    self._event(
                        "slo_burn", tick, st,
                        burn_fast=round(fast, 2), burn_slow=round(slow, 2),
                        target_s=st.spec.target_s,
                        quantile=st.spec.quantile,
                        budget_remaining=round(remaining, 4))
                    if self.flight is not None:
                        # the fast burn is the black-box moment: capture
                        # the waterfall window that caused it
                        self.flight.request_dump("slo_burn", tick)
            else:
                if fast < self.rearm_frac * fast_thr and \
                        slow < self.rearm_frac * slow_thr:
                    st.burning = False
                    st.recoveries += 1
                    self._event("slo_recovered", tick,
                                st, burn_fast=round(fast, 2),
                                burn_slow=round(slow, 2))
            if not st.exhausted and st.cum_total and remaining <= 0.0:
                st.exhausted = True
                self._event(
                    "slo_budget_exhausted", tick, st,
                    bad=int(st.cum_bad), total=int(st.cum_total),
                    budget_frac=budget)
            elif st.exhausted and remaining > 0.1:
                st.exhausted = False  # re-arm well clear of the edge

    # --------------------------------------------------------- consume --
    def _verdict_one(self, st: _SloState) -> dict:
        spec = st.spec
        budget = spec.budget_frac
        bad_frac = (st.cum_bad / st.cum_total) if st.cum_total else 0.0
        observed_q = None
        if self.quantile_source is not None:
            observed_q = self.quantile_source(
                spec.name, spec.quantile, "total")
        # the contract: the declared quantile of observations met the
        # target — equivalently, the bad fraction stayed within budget.
        # Zero observations is NO DATA (met=None), not a pass or a
        # fail: a detect SLO on a run that never alerted proves nothing
        # either way, and a soak keying on met==False must not page
        met = (bad_frac <= budget) if st.cum_total else None
        return {
            "slo": spec.label(),
            "stage": spec.name,
            "target_s": spec.target_s,
            "quantile": spec.quantile,
            "met": met,
            "samples": int(st.cum_total),
            "bad": int(st.cum_bad),
            "bad_frac": round(bad_frac, 6),
            "budget_frac": round(budget, 6),
            "budget_remaining": round(
                1.0 - bad_frac / budget if st.cum_total else 1.0, 4),
            "observed_quantile_s": round(observed_q, 6)
            if observed_q is not None else None,
            "burn_events": st.burn_events,
            "recoveries": st.recoveries,
            "burning": st.burning,
        }

    def verdict(self) -> dict:
        """The run's SLO verdict — embedded in loop stats and every soak
        report: per-SLO met/bad-frac/budget plus an overall flag."""
        per = [self._verdict_one(st) for st in self._states.values()]
        return {
            # overall: no SLO is provably violated (no-data SLOs read
            # met=null individually and do not fail the run)
            "met": all(v["met"] is not False for v in per),
            "slos": per,
        }

    def snapshot(self) -> dict:
        """The ``GET /slo`` body: the live verdict plus window config."""
        return {
            "ts": time.time(),
            "fast_window_ticks": self.fast_window,
            "slow_window_ticks": self.slow_window,
            "fast_burn_threshold": self.fast_burn,
            "slow_burn_threshold": self.slow_burn,
            **self.verdict(),
        }

    def _window_sums(self, st: _SloState, window: int) -> tuple[int, int]:
        n = min(st.filled, window)
        if n == 0:
            return 0, 0
        sel = (st.idx - 1 - np.arange(n)) % self.slow_window
        return int(st.bad_ring[sel].sum()), int(st.total_ring[sel].sum())

    def fleet_state(self) -> list[dict]:
        """Per-SLO mergeable counts (the fleet push payload):
        raw bad/total sums for the fast/slow windows and the run, NOT
        fractions — the aggregator re-derives fleet burn rates from
        summed counts, the same anti-max-of-p99s discipline the merged
        sketches follow. Window lengths ride along so the aggregator can
        refuse to pool incomparable windows."""
        out = []
        for st in self._states.values():
            fast_bad, fast_total = self._window_sums(st, self.fast_window)
            slow_bad, slow_total = self._window_sums(st, self.slow_window)
            out.append({
                "stage": st.spec.name,
                "target_s": st.spec.target_s,
                "quantile": st.spec.quantile,
                "fast_window_ticks": self.fast_window,
                "slow_window_ticks": self.slow_window,
                "fast_bad": fast_bad, "fast_total": fast_total,
                "slow_bad": slow_bad, "slow_total": slow_total,
                "cum_bad": int(st.cum_bad),
                "cum_total": int(st.cum_total),
                "burning": st.burning,
                "burn_events": st.burn_events,
            })
        return out
