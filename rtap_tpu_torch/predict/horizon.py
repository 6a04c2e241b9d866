"""Per-stream divergence tracking -> ``precursor`` events.

The port's copy of the JAX package's ``predict/horizon.py``. The on-device
predict reducer (ops/predict.py) scores, every tick,
how well the TM's horizon-old forward model predicted the columns that
actually fired — and folds the miss rate into a per-stream EWMA. A
stream in a learned stable regime holds that EWMA low; a slow pre-fault
drift (resource-exhaustion ramps, degrading dependencies) erodes the
TM's forward model ticks before the anomaly score itself spikes.

:class:`PredictTracker` is the host side: it folds the per-(group,
tick) leaves (``StreamGroup.last_predict``) into per-stream divergence
trajectories and pages with the HealthTracker discipline —

- **warm-up gating**: a stream must accumulate ``warmup_ticks`` scored
  samples before it may alarm (the device already holds scoring back a
  full horizon after (re)init; this is the host-side settling window on
  top);
- **debounce**: the EWMA must sit at/above ``threshold`` for
  ``min_ticks`` CONSECUTIVE scored ticks (one noisy excursion is not a
  precursor);
- **edge-triggered hysteresis**: one ``precursor`` event on entry; the
  stream re-arms only after its EWMA falls below ``rearm_frac *
  threshold`` (an EWMA oscillating at the line must not storm the alert
  stream).

Each event carries a stable ``alert_id`` (``precursor:<stream>:<tick>``
— a journal replay reproduces it bit-for-bit, so resume suppression
works by construction), the predicted lead time in ticks, and requests
a flight-recorder postmortem dump (a precursor is a black-box moment —
the window that led here is exactly what the operator wants captured).

When a :class:`~rtap_tpu_torch.predict.blast.BlastFuser` is attached, every
precursor is also offered to it; a returned ``predicted_incident``
event is emitted through the same sink/suppression path (the fuser
itself stays pure — it decides, the tracker emits).

Thread model: :meth:`fold` runs on the serve loop thread; the obs HTTP
server calls :meth:`snapshot`/:meth:`scorecard` concurrently. Unlike
the HealthTracker (torn reads by documented contract), both sides hold
one reentrant lock — a snapshot is a consistent cut, and the lock is
uncontended on the hot path (one fold per collected chunk per group).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from rtap_tpu_torch.obs.metrics import TelemetryRegistry, get_registry

__all__ = ["PredictTracker", "PREDICT_EVENTS"]

#: predictive event vocabulary (docs/TELEMETRY.md, docs/PREDICT.md)
PREDICT_EVENTS = ("precursor", "predicted_incident")


def _is_pad(stream_id) -> bool:
    """Pad slots never page (they are fed NaN so they never score, but a
    just-released slot's id must not leak into an in-flight event)."""
    return stream_id is None or str(stream_id).startswith("__pad")


class _GroupPredict:
    """One group's folded predictor state (bounded: a few [G] vectors)."""

    __slots__ = ("ticks", "run", "alarmed", "samples", "ewma", "overlap",
                 "col_frac", "last_tick", "ids")

    def __init__(self, G: int):
        self.ticks = 0                          # predict leaves folded
        self.run = np.zeros(G, np.int64)        # consecutive hot scored ticks
        self.alarmed = np.zeros(G, bool)        # edge-trigger latch
        self.samples = np.zeros(G, np.int64)    # scored ticks seen (warm-up)
        self.ewma = np.full(G, np.nan, np.float64)     # latest divergence
        self.overlap = np.full(G, np.nan, np.float64)  # latest overlap
        self.col_frac = np.full(G, np.nan, np.float64)
        self.last_tick = -1
        self.ids: list = [None] * G             # latest slot -> stream id


class PredictTracker:
    """Folds per-(group, tick) predict leaves into lead-time precursors.

    Construction registers the fleet gauges once; :meth:`fold` is the
    only hot-path call (one per collected chunk per group — a few numpy
    ops over [T, G] leaves).

    `sink` (callable taking one JSON-able event dict), `flight`
    (obs.FlightRecorder) and `blast`
    (:class:`~rtap_tpu_torch.predict.blast.BlastFuser`) may be attached after
    construction — ``live_loop`` wires them exactly like the
    HealthTracker's.
    """

    def __init__(self, horizon: int, registry: TelemetryRegistry | None = None,
                 sink=None, flight=None, blast=None,
                 threshold: float = 0.35,
                 min_ticks: int = 12,
                 warmup_ticks: int = 32,
                 rearm_frac: float = 0.5):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1; got {horizon}")
        if not (0.0 < threshold <= 1.0):
            raise ValueError(
                f"threshold must be in (0, 1]; got {threshold}")
        if min_ticks < 1:
            raise ValueError(f"min_ticks must be >= 1; got {min_ticks}")
        if warmup_ticks < 0:
            raise ValueError(
                f"warmup_ticks must be >= 0; got {warmup_ticks}")
        if not (0.0 <= rearm_frac < 1.0):
            raise ValueError(
                f"rearm_frac must be in [0, 1); got {rearm_frac}")
        self.horizon = int(horizon)
        self.threshold = float(threshold)
        self.min_ticks = int(min_ticks)
        self.warmup_ticks = int(warmup_ticks)
        self.rearm_frac = float(rearm_frac)
        self.sink = sink
        #: optional: takes a list of events and writes them at once
        #: (AlertWriter.emit_events; live_loop wires it with ``sink``)
        self.sink_batch = None
        self.flight = flight
        self.blast = blast
        # fold runs on the serve loop thread; snapshot/scorecard/stats on
        # the obs HTTP thread — one reentrant guard covers both sides
        # (stats -> snapshot -> scorecard nest under the same holder)
        self._lock = threading.RLock()
        self._groups: dict[int, _GroupPredict] = {}
        self.events_total = 0
        self.events_suppressed = 0
        self._events_by_kind: dict[str, int] = {}
        #: armed replay-suppression ids (service/alerts.scan_event_ids):
        #: a journal replay reproduces each event bit-for-bit; ids already
        #: on disk update state but skip the sink/flight re-emission
        self._suppress: set[str] = set()
        reg = registry or get_registry()
        self._obs_events = {
            kind: reg.counter(
                "rtap_obs_predict_events_total",
                "predictive events by kind (precursor / "
                "predicted_incident)", event=kind)
            for kind in PREDICT_EVENTS
        }
        self._obs_ewma_max = reg.gauge(
            "rtap_obs_predict_miss_ewma_max",
            "worst per-stream predicted->actual miss EWMA across the "
            "fleet (the divergence trajectory precursors page on)")
        self._obs_overlap = reg.gauge(
            "rtap_obs_predict_overlap_mean",
            "fleet mean horizon-old predicted-column overlap at the "
            "latest folded tick (scored streams only)")
        self._obs_alarmed = reg.gauge(
            "rtap_obs_predict_streams_alarmed",
            "streams currently inside a precursor alarm (edge-triggered; "
            "re-arm below rearm_frac * threshold)")
        self._obs_fold_seconds = reg.histogram(
            "rtap_obs_predict_fold_seconds",
            "wall seconds per PredictTracker.fold call (one per collected "
            "chunk per group)")

    # ---------------------------------------------------------- resume --
    def arm_suppression(self, ids) -> None:
        """Arm replay suppression for already-on-disk event ids (the
        serve resume path scans the alert sink tail with
        service/alerts.scan_event_ids and hands the ids here): a
        replayed fold still updates tracker state — the latch positions
        must match the pre-crash process — but the duplicate event line
        is not re-emitted."""
        with self._lock:
            self._suppress.update(str(i) for i in ids)

    # ------------------------------------------------------------ fold --
    def fold(self, group: int, leaves: dict, tick: int = -1,
             ids=None) -> None:
        """Fold one collected chunk's predict leaves ([T, G] arrays from
        ``StreamGroup.last_predict``) into group `group`'s trajectories
        and run the per-stream edge triggers once per tick row.

        `tick` is the LAST tick of the chunk (row i happened at
        ``tick - (T - 1 - i)``); `ids` the slot -> stream-id mapping
        (length G; pads None or pad-prefixed — they never page)."""
        with self._lock:
            self._fold_locked(group, leaves, tick, ids)

    def _fold_locked(self, group: int, leaves: dict, tick: int,
                     ids) -> None:
        t0 = time.perf_counter()
        scored = np.atleast_2d(np.asarray(leaves["scored"], bool))
        ewma = np.atleast_2d(np.asarray(leaves["miss_ewma"], np.float64))
        overlap = np.atleast_2d(np.asarray(leaves["overlap"], np.float64))
        col_frac = np.atleast_2d(
            np.asarray(leaves["pred_col_frac"], np.float64))
        T, G = scored.shape
        g = self._groups.get(group)
        if g is None or len(g.ids) != G:
            g = self._groups[group] = _GroupPredict(G)
        if ids is not None:
            g.ids = list(ids)
        thr = self.threshold
        for i in range(T):
            g.ticks += 1
            row_tick = int(tick - (T - 1 - i)) if tick >= 0 else -1
            s = scored[i]
            e = ewma[i]
            hot = s & np.isfinite(e) & (e >= thr)
            # consecutive-hot run: a scored cool tick resets; an
            # UNSCORED tick (source gap) holds the run rather than
            # resetting — an outage must not silently disarm a ramp
            g.run = np.where(hot, g.run + 1, np.where(s, 0, g.run))
            g.samples += s
            fire = (~g.alarmed) & (g.run >= self.min_ticks) \
                & (g.samples >= self.warmup_ticks)
            rearm = g.alarmed & s & np.isfinite(e) \
                & (e < self.rearm_frac * thr)
            for slot in np.nonzero(fire)[0]:
                sid = g.ids[slot] if slot < len(g.ids) else None
                if _is_pad(sid):
                    continue
                g.alarmed[slot] = True
                self._precursor(group, int(slot), str(sid), row_tick,
                                float(e[slot]), float(overlap[i, slot]))
            g.alarmed[rearm] = False
            g.run[rearm] = 0
        # latest-scored adoption (the HealthTracker discipline): an
        # all-NaN outage row must not zero the scorecard
        live = np.nonzero(scored.any(-1))[0]
        g.last_tick = int(tick)
        if live.size:
            i = int(live[-1])
            s = scored[i]
            g.ewma = np.where(s, ewma[i], g.ewma)
            g.overlap = np.where(s, overlap[i], g.overlap)
            g.col_frac = np.where(s, col_frac[i], g.col_frac)
        self._set_fleet_gauges()
        self._obs_fold_seconds.observe(time.perf_counter() - t0)

    # ------------------------------------------------- event emission --
    def _precursor(self, group: int, slot: int, stream: str, tick: int,
                   ewma: float, overlap: float) -> None:
        ev = {
            "event": "precursor",
            "tick": int(tick),
            "group": int(group),
            "slot": int(slot),
            "stream": stream,
            "alert_id": f"precursor:{stream}:{tick}",
            "miss_ewma": round(ewma, 6),
            "overlap": None if not np.isfinite(overlap)
            else round(overlap, 6),
            "threshold": self.threshold,
            "horizon_ticks": self.horizon,
            # the divergence was measured against a prediction captured
            # a full horizon ago: the drift is at least that old, so the
            # page leads the score spike by up to k ticks
            "predicted_lead_ticks": self.horizon,
        }
        evs = [ev]
        if self.blast is not None:
            inc = self.blast.precursor(stream, tick, ev)
            if inc is not None:
                evs.append(inc)
        kept = [e for e in evs if self._emit(e)]
        if self.sink_batch is not None and len(kept) > 1:
            # the page and the incident it opens in one write: a process
            # killed between two writes would leave the page without its
            # incident, and the resumed tracker (latches not checkpointed)
            # opens another one ticks later
            self.sink_batch(kept)
        elif self.sink is not None:
            for e in kept:
                self.sink(e)

    def _emit(self, ev: dict) -> bool:
        """Count and record one event; False for a suppressed replay. The
        caller hands the kept events to the sink."""
        kind = ev["event"]
        aid = ev.get("alert_id")
        if aid is not None and aid in self._suppress:
            # replay of an already-delivered event: state latched above,
            # line already on disk — do not page twice
            self._suppress.discard(aid)
            self.events_suppressed += 1
            return False
        self.events_total += 1
        self._events_by_kind[kind] = self._events_by_kind.get(kind, 0) + 1
        counter = self._obs_events.get(kind)
        if counter is not None:
            counter.inc()
        if self.flight is not None:
            # a precursor is a black-box moment like a health incident:
            # capture the window that led here
            self.flight.record_event(ev)
            self.flight.request_dump(kind, ev.get("tick", -1))
        return True

    def _set_fleet_gauges(self) -> None:
        gs = list(self._groups.values())
        if not gs:
            return
        ewmas = np.concatenate([g.ewma for g in gs])
        overlaps = np.concatenate([g.overlap for g in gs])
        self._obs_ewma_max.set(
            float(np.nanmax(ewmas)) if np.isfinite(ewmas).any() else 0.0)
        self._obs_overlap.set(
            float(np.nanmean(overlaps))
            if np.isfinite(overlaps).any() else 0.0)
        self._obs_alarmed.set(int(sum(int(g.alarmed.sum()) for g in gs)))

    # -------------------------------------------------------- surface --
    def scorecard(self, gi: int) -> dict:
        """One group's JSON scorecard (the /predict per-group unit)."""
        with self._lock:
            return self._scorecard_locked(gi)

    def _scorecard_locked(self, gi: int) -> dict:
        g = self._groups[gi]
        fin = np.isfinite(g.ewma)
        alarmed = [
            {"slot": int(s), "stream": None if _is_pad(g.ids[s]) else
             str(g.ids[s]), "miss_ewma": round(float(g.ewma[s]), 6)
             if np.isfinite(g.ewma[s]) else None}
            for s in np.nonzero(g.alarmed)[0]
        ]
        return {
            "group": int(gi),
            "ticks": g.ticks,
            "last_tick": g.last_tick,
            "streams_scored": int(fin.sum()),
            "miss_ewma": {
                "max": round(float(np.nanmax(g.ewma)), 6)
                if fin.any() else None,
                "mean": round(float(np.nanmean(g.ewma)), 6)
                if fin.any() else None,
            },
            "overlap_mean": round(float(np.nanmean(g.overlap)), 6)
            if np.isfinite(g.overlap).any() else None,
            "pred_col_frac_mean": round(float(np.nanmean(g.col_frac)), 6)
            if np.isfinite(g.col_frac).any() else None,
            "alarmed": alarmed,
            "verdict": "ok" if not alarmed else "precursor",
        }

    def snapshot(self) -> dict:
        """The GET /predict body: fleet rollup + per-group scorecards.
        Also embedded in postmortem bundle summaries (obs/flight.py)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        gids = sorted(list(self._groups))
        groups = [self._scorecard_locked(gi) for gi in gids]
        attention = [g["group"] for g in groups if g["verdict"] != "ok"]
        maxes = [g["miss_ewma"]["max"] for g in groups
                 if g["miss_ewma"]["max"] is not None]
        out = {
            "fleet": {
                "groups": len(groups),
                "ticks_folded": sum(g["ticks"] for g in groups),
                "horizon_ticks": self.horizon,
                "threshold": self.threshold,
                "miss_ewma_max": max(maxes) if maxes else None,
                "streams_alarmed": sum(len(g["alarmed"]) for g in groups),
                "groups_attention": attention,
                "events_total": self.events_total,
                "events_by_kind": dict(sorted(self._events_by_kind.items())),
                "verdict": "ok" if not attention else "precursor",
            },
            "groups": groups,
        }
        if self.blast is not None:
            out["blast"] = self.blast.snapshot()
        return out

    def stats(self) -> dict:
        """End-of-run accounting for the loop's stats dict (compact)."""
        with self._lock:
            fleet = self._snapshot_locked()["fleet"] \
                if self._groups else {}
            return {
                "groups": len(self._groups),
                "ticks_folded": sum(
                    g.ticks for g in list(self._groups.values())),
                "horizon_ticks": self.horizon,
                "events": dict(sorted(self._events_by_kind.items())),
                "events_suppressed": self.events_suppressed,
                **({"verdict": fleet.get("verdict"),
                    "miss_ewma_max": fleet.get("miss_ewma_max"),
                    "streams_alarmed": fleet.get("streams_alarmed")}
                   if fleet else {}),
            }
