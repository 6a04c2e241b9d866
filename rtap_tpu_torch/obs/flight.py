"""Black-box flight recorder: bounded per-tick history + postmortem bundles.

The port's copy of the JAX package's ``obs/flight.py`` (the same bundle
layout, so either package's :func:`validate_bundle` accepts the other's
bundles). A crashed or degraded hour-long soak used to leave only a final metrics
snapshot behind; the flight recorder keeps the last ``n_ticks`` ticks of
evidence — per-tick latency, per-phase wall-second deltas, per-group
scored digests, deadline verdicts, and the recent structured events — in
STRICTLY BOUNDED preallocated rings, and dumps an atomic postmortem
bundle when something goes wrong:

- ``group_quarantined`` (a dispatch/collect fault isolated a group),
- a degradation-level change (the load-shedding ladder moved),
- a missed-tick burst (``miss_burst`` consecutive deadline misses),
- an unhandled exception escaping ``serve`` (the CLI's excepthook path),
- or on demand (``GET /postmortem`` on the obs HTTP server, or a direct
  :meth:`dump` call).

A bundle is one directory, written to a temp sibling and ``os.rename``d
into place (a reader never sees a half-written bundle):

- ``trace.json``   — the span recorder's Chrome trace-event JSON over the
  flight window (loadable in ui.perfetto.dev; docs/POSTMORTEM.md),
- ``events.jsonl`` — the retained structured event lines, in order,
- ``summary.json`` — reason + tick, window stats (per-phase mean/max,
  misses, per-group scored totals), the telemetry-registry summary, and
  the caller-supplied config/info block.

The JAX package's ``scripts/postmortem.py`` pretty-prints a bundle;
:func:`validate_bundle` is the machine check (used by the chaos soak and
the tests).
Dumps are throttled (``min_dump_gap_ticks`` per reason, ``max_bundles``
per run) so a quarantine storm cannot fill the disk — except the
``unhandled_exception`` crash dump, which is always admitted (the black
box's whole point is evidence of the death). Bundle names carry a
per-run tag (start time + pid), so re-runs into the same directory
never collide with a prior run's bundles.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import numpy as np

from rtap_tpu_torch.obs.metrics import TelemetryRegistry, get_registry

__all__ = ["FlightRecorder", "validate_bundle"]

_BUNDLE_FILES = ("summary.json", "events.jsonl")


class FlightRecorder:
    """Bounded ring of the last N ticks + auto-dumped postmortem bundles.

    ``record_tick`` is the only hot-path call (one per tick): a handful of
    numpy scalar stores into preallocated rings, lazily sized to the
    fleet's group count on the first tick. Everything else (event capture,
    dumping) is rare by construction.
    """

    def __init__(self, trace=None, n_ticks: int = 240,
                 out_dir: str | None = None,
                 registry: TelemetryRegistry | None = None,
                 n_events: int = 512, max_event_bytes: int = 1024,
                 miss_burst: int = 5, min_dump_gap_ticks: int = 120,
                 max_bundles: int = 16, info: dict | None = None,
                 health_provider=None, latency_provider=None,
                 predict_provider=None):
        if n_ticks < 1:
            raise ValueError(f"n_ticks must be >= 1; got {n_ticks}")
        if miss_burst < 1:
            raise ValueError(f"miss_burst must be >= 1; got {miss_burst}")
        self.trace = trace
        self.n_ticks = int(n_ticks)
        self.out_dir = out_dir
        self.registry = registry or get_registry()
        self.miss_burst = int(miss_burst)
        self.min_dump_gap_ticks = int(min_dump_gap_ticks)
        self.max_bundles = int(max_bundles)
        self.max_event_bytes = int(max_event_bytes)
        self.info = dict(info or {})
        # optional model-health snapshot source (obs/health.py):
        # a callable returning a JSON-able dict, embedded in every
        # bundle's summary.json so triage gets model state, not just
        # timing. live_loop wires the HealthTracker's snapshot in.
        self.health_provider = health_provider
        # optional detection-latency source (obs/latency.py):
        # same contract — the latest stage waterfall + windowed
        # quantiles land in every bundle's summary, so an slo_burn (or
        # any other) postmortem names the stage that ate the budget
        self.latency_provider = latency_provider
        # optional predictive-horizon scorecard source
        # (rtap_tpu_torch/predict/): same contract — the divergence trajectories and
        # open blast windows land in every bundle's summary, so a
        # precursor postmortem shows what the predictor saw
        self.predict_provider = predict_provider
        # tick rings (preallocated; the scored ring is sized on first use
        # because the group count is the loop's to know)
        self._tick = np.full(self.n_ticks, -1, np.int64)
        self._elapsed = np.zeros(self.n_ticks, np.float64)
        self._missed = np.zeros(self.n_ticks, bool)
        self._phases: np.ndarray | None = None  # [n_ticks, n_phases] f64
        self._phase_names: tuple[str, ...] = ()
        self._scored: np.ndarray | None = None  # [n_ticks, n_groups] i64
        self._n = 0
        self._last_tick = -1
        self._miss_run = 0
        # bounded event ring: pre-serialized, truncated lines
        self._events: deque[str] = deque(maxlen=int(n_events))
        self._events_by_kind: dict[str, int] = {}
        self._events_total = 0
        # per-run tag in every bundle name: a re-run pointed at the same
        # --postmortem-dir (chaos workdirs are reusable) must never collide with a prior run's
        # bundle — os.rename onto an existing dir fails ENOTEMPTY and
        # would silently drop the NEW incident's postmortem
        self._run_tag = f"{int(time.time())}-{os.getpid()}"
        # dump state. The lock serializes dump() only — the loop thread's
        # flush_pending and the obs server's /postmortem handler may race,
        # and both derive the bundle name/tmp dir from len(self.bundles)
        self._dump_lock = threading.Lock()
        self._pending: list[tuple[str, int]] = []
        self._last_dump_tick: dict[str, int] = {}
        self.bundles: list[str] = []
        self.dumps_skipped = 0
        self._obs_bundles: dict = {}
        self._obs_last_tick = self.registry.gauge(
            "rtap_obs_postmortem_last_tick",
            "tick index of the most recent postmortem bundle dump")
        self._obs_skipped = self.registry.counter(
            "rtap_obs_postmortem_dump_skipped_total",
            "postmortem dumps suppressed by throttling (per-reason gap or "
            "the per-run bundle cap)")
        self._obs_dump_seconds = self.registry.histogram(
            "rtap_obs_postmortem_dump_seconds",
            "wall seconds per postmortem bundle dump (trace export + "
            "writes + atomic rename)")

    # ----------------------------------------------------------- record --
    def record_tick(self, tick: int, elapsed_s: float,
                    phase_seconds: dict[str, float],
                    scored_by_group, missed: bool) -> None:
        """One tick's facts into the ring; also advances the missed-tick
        burst detector (which queues a dump, never writes inline)."""
        if self._phases is None:
            self._phase_names = tuple(phase_seconds)
            self._phases = np.zeros((self.n_ticks, len(self._phase_names)),
                                    np.float64)
        if self._scored is None:
            self._scored = np.zeros((self.n_ticks, len(scored_by_group)),
                                    np.int64)
        i = self._n % self.n_ticks
        self._tick[i] = tick
        self._elapsed[i] = elapsed_s
        self._missed[i] = missed
        for j, p in enumerate(self._phase_names):
            self._phases[i, j] = phase_seconds.get(p, 0.0)
        ng = min(len(scored_by_group), self._scored.shape[1])
        self._scored[i, :ng] = scored_by_group[:ng]
        self._n += 1
        self._last_tick = int(tick)
        if missed:
            self._miss_run += 1
            if self._miss_run == self.miss_burst:
                self.request_dump("missed_tick_burst", tick)
        else:
            self._miss_run = 0

    def record_event(self, event: dict) -> None:
        """Capture one structured event line (same dicts that ride the
        alert JSONL stream). Bounded: the ring keeps the last `n_events`,
        each at most `max_event_bytes`. A longer line (an incident's member
        list) is kept as a stub naming its kind, tick and length: a line cut
        mid-JSON would make the whole bundle fail validation, which is what
        the JAX package's recorder does (ROADMAP.md section C)."""
        kind = str(event.get("event", "?"))
        self._events_by_kind[kind] = self._events_by_kind.get(kind, 0) + 1
        self._events_total += 1
        try:
            line = json.dumps(event)
        except (TypeError, ValueError):
            line = json.dumps({"event": kind, "repr": repr(event)[:256]})
        if len(line) > self.max_event_bytes:
            tick = event.get("tick")
            stubs = (json.dumps({"event": kind[:64],
                                 "tick": tick if isinstance(tick, int) else None,
                                 "truncated_bytes": len(line)}),
                     json.dumps({"event": kind[:16], "truncated_bytes": len(line)}))
            line = next((x for x in stubs if len(x) <= self.max_event_bytes), "{}")
        self._events.append(line)

    def nbytes(self) -> int:
        """Preallocated tick-ring memory (the bound the unit test pins;
        the event ring adds at most n_events * max_event_bytes on top)."""
        n = self._tick.nbytes + self._elapsed.nbytes + self._missed.nbytes
        if self._phases is not None:
            n += self._phases.nbytes
        if self._scored is not None:
            n += self._scored.nbytes
        return n

    # ------------------------------------------------------------- dump --
    def request_dump(self, reason: str, tick: int) -> None:
        """Queue a dump; the loop drains the queue at tick end
        (:meth:`flush_pending`) so bundle writes never land inside a
        phase's accounting."""
        self._pending.append((reason, int(tick)))

    def flush_pending(self) -> list[str]:
        """Write every queued dump (throttled); returns bundle paths."""
        paths = []
        pending, self._pending = self._pending, []
        for reason, tick in pending:
            p = self.dump(reason, tick)
            if p is not None:
                paths.append(p)
        return paths

    def _allowed(self, reason: str, tick: int) -> bool:
        if self.out_dir is None:
            return False
        if reason == "unhandled_exception":
            # the crash black box is the whole point: a soak that spent
            # its bundle budget on quarantine churn must STILL leave its
            # dying evidence behind — exempt from cap and gap alike
            return True
        if len(self.bundles) >= self.max_bundles:
            return False
        last = self._last_dump_tick.get(reason)
        return last is None or tick - last >= self.min_dump_gap_ticks

    def _window(self) -> np.ndarray:
        """Indices of the retained ring rows, oldest first."""
        n = min(self._n, self.n_ticks)
        if n == 0:
            return np.empty(0, np.int64)
        start = self._n - n
        return (start + np.arange(n)) % self.n_ticks

    def summary(self, reason: str = "snapshot",
                tick: int | None = None) -> dict:
        """The bundle's summary.json content (also the /postmortem and
        postmortem.py surface — one schema everywhere)."""
        idx = self._window()
        out: dict = {
            "reason": reason,
            "tick": int(self._last_tick if tick is None else tick),
            "created_unix": time.time(),
            "bundle_seq": len(self.bundles),
            "info": self.info,
            "ticks": {
                "count": int(idx.size),
                "first": int(self._tick[idx[0]]) if idx.size else None,
                "last": int(self._tick[idx[-1]]) if idx.size else None,
                "missed": int(self._missed[idx].sum()) if idx.size else 0,
                "miss_run": self._miss_run,
            },
            "events": {
                "total_seen": self._events_total,
                "retained": len(self._events),
                "by_kind": dict(sorted(self._events_by_kind.items())),
            },
            "trace": None if self.trace is None else {
                "records": self.trace.total,
                "dropped": self.trace.dropped,
            },
        }
        if idx.size:
            el = self._elapsed[idx]
            out["tick_ms"] = {"mean": round(float(el.mean()) * 1e3, 3),
                              "max": round(float(el.max()) * 1e3, 3)}
            if self._phases is not None:
                out["phase_ms"] = {
                    p: {"mean": round(float(self._phases[idx, j].mean()) * 1e3, 3),
                        "max": round(float(self._phases[idx, j].max()) * 1e3, 3)}
                    for j, p in enumerate(self._phase_names)
                }
            if self._scored is not None:
                out["scored_by_group_window"] = [
                    int(x) for x in self._scored[idx].sum(axis=0)]
        try:
            from rtap_tpu_torch.obs.expo import summarize_snapshot

            out["registry"] = summarize_snapshot(self.registry.snapshot())
        except Exception:  # noqa: BLE001 — a summary must not kill a dump
            out["registry"] = None
        if self.health_provider is not None:
            try:
                out["health"] = self.health_provider()
            except Exception:  # noqa: BLE001 — must not kill a dump
                out["health"] = None
        if self.latency_provider is not None:
            try:
                out["latency"] = self.latency_provider()
            except Exception:  # noqa: BLE001 — must not kill a dump
                out["latency"] = None
        if self.predict_provider is not None:
            try:
                out["predict"] = self.predict_provider()
            except Exception:  # noqa: BLE001 — must not kill a dump
                out["predict"] = None
        return out

    def dump(self, reason: str, tick: int | None = None) -> str | None:
        """Write one atomic postmortem bundle; returns its path, or None
        when throttled / no out_dir. Never raises: a failing disk must
        not take down the serve loop it is documenting. Thread-safe
        (loop thread + the obs server's /postmortem handler)."""
        with self._dump_lock:
            return self._dump_locked(reason, tick)

    def _dump_locked(self, reason: str, tick: int | None) -> str | None:
        tick = int(self._last_tick if tick is None else tick)
        if not self._allowed(reason, tick):
            self.dumps_skipped += 1
            self._obs_skipped.inc()
            return None
        t0 = time.perf_counter()
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:48]
        name = (f"postmortem-{self._run_tag}-{len(self.bundles):03d}"
                f"-t{max(tick, 0):08d}-{safe}")
        final = os.path.join(self.out_dir, name)
        tmp = os.path.join(self.out_dir, f".tmp-{name}-{os.getpid()}")
        try:
            os.makedirs(tmp, exist_ok=True)
            # window the trace to the flight ring's tick span: the span
            # ring may hold more history than the bundle claims to cover
            idx = self._window()
            span_ticks = None
            if idx.size:
                span_ticks = int(self._last_tick - int(self._tick[idx[0]]) + 1)
            if self.trace is not None:
                with open(os.path.join(tmp, "trace.json"), "w") as f:
                    json.dump(self.trace.chrome_trace(last_ticks=span_ticks), f)
            with open(os.path.join(tmp, "events.jsonl"), "w") as f:
                # materialize first: list(deque) is one C-level copy
                # (GIL-atomic), while iterating the live deque races
                # the loop thread's record_event appends — a concurrent
                # mutation raises RuntimeError mid-dump
                for line in list(self._events):
                    f.write(line + "\n")
            with open(os.path.join(tmp, "summary.json"), "w") as f:
                json.dump(self.summary(reason, tick), f, indent=2)
            os.rename(tmp, final)
        except OSError:
            self.dumps_skipped += 1
            self._obs_skipped.inc()
            try:  # best-effort cleanup of the torn temp dir
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
            except Exception:  # noqa: BLE001
                pass
            return None
        self.bundles.append(final)
        self._last_dump_tick[reason] = tick
        c = self._obs_bundles.get(reason)
        if c is None:
            c = self._obs_bundles[reason] = self.registry.counter(
                "rtap_obs_postmortem_bundles_total",
                "postmortem bundles dumped, by trigger reason",
                reason=safe)
        c.inc()
        self._obs_last_tick.set(tick)
        self._obs_dump_seconds.observe(time.perf_counter() - t0)
        return final

    def stats(self) -> dict:
        """End-of-run accounting for the loop's stats dict."""
        return {
            "bundles": len(self.bundles),
            "bundle_paths": list(self.bundles),
            "dumps_skipped": self.dumps_skipped,
            "events_seen": self._events_total,
            "ticks_recorded": self._n,
        }


def validate_bundle(path: str) -> dict:
    """Machine-check one bundle: every file present and parseable, the
    trace is Chrome trace-event JSON with at least one complete span.
    Returns ``{"ok": bool, "problems": [...], "spans": n, "instants": n,
    "events": n, "reason": ..., "tick": ...}`` — the chaos soak and the
    tier-1 postmortem tests assert on it."""
    out: dict = {"ok": False, "problems": [], "spans": 0, "instants": 0,
                 "events": 0, "reason": None, "tick": None}
    if not os.path.isdir(path):
        out["problems"].append(f"not a directory: {path}")
        return out
    summary = None
    for fn in _BUNDLE_FILES:
        if not os.path.isfile(os.path.join(path, fn)):
            out["problems"].append(f"missing {fn}")
    try:
        with open(os.path.join(path, "summary.json")) as f:
            summary = json.load(f)
        out["reason"] = summary.get("reason")
        out["tick"] = summary.get("tick")
    except (OSError, ValueError) as e:
        out["problems"].append(f"summary.json unreadable: {e}")
    try:
        with open(os.path.join(path, "events.jsonl")) as f:
            for line in f:
                if line.strip():
                    json.loads(line)
                    out["events"] += 1
    except (OSError, ValueError) as e:
        out["problems"].append(f"events.jsonl unreadable: {e}")
    trace_expected = summary is None or summary.get("trace") is not None
    trace_path = os.path.join(path, "trace.json")
    if os.path.isfile(trace_path):
        try:
            with open(trace_path) as f:
                tj = json.load(f)
            evs = tj.get("traceEvents")
            if not isinstance(evs, list):
                out["problems"].append("trace.json has no traceEvents list")
            else:
                out["spans"] = sum(1 for e in evs if e.get("ph") == "X")
                out["instants"] = sum(1 for e in evs if e.get("ph") == "i")
                if out["spans"] == 0:
                    out["problems"].append("trace.json contains no spans")
        except (OSError, ValueError) as e:
            out["problems"].append(f"trace.json unreadable: {e}")
    elif trace_expected:
        out["problems"].append("missing trace.json")
    out["ok"] = not out["problems"]
    return out
