"""Tick watchdog: deadline/starvation/stall events for the live serve loop.

The port's copy of the JAX package's ``obs/watchdog.py``. The 1 s-cadence serve loop is a
real-time contract whose failures are structured: a tick over budget, a
dead feeder (an all-NaN source vector), an inline checkpoint save that eats
a tick. The watchdog turns them into registry counters and structured JSONL
events on the alert stream (``"event"`` key):

- ``missed_tick``      — a tick's host work exceeded the cadence budget
- ``source_starved``   — the source returned all-NaN ``starved_after``
  consecutive ticks, and again every ``starved_after`` ticks while it lasts
- ``checkpoint_stall`` — an inline checkpoint save exceeded the cadence
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from rtap_tpu_torch.obs.metrics import TelemetryRegistry, get_registry

__all__ = ["TickWatchdog"]


class TickWatchdog:
    """Consumes per-tick facts from ``live_loop``; raises structured events.

    `event_sink` is any callable taking one JSON-able dict (the serve loop
    passes ``AlertWriter.emit_event``); None keeps counters only. Called
    from the loop thread only — no locking needed.
    """

    def __init__(self, cadence_s: float,
                 registry: TelemetryRegistry | None = None,
                 event_sink: Callable[[dict], None] | None = None,
                 starved_after: int = 3,
                 checkpoint_stall_s: float | None = None,
                 trace=None, flight=None):
        if starved_after < 1:
            raise ValueError(f"starved_after must be >= 1; got {starved_after}")
        reg = registry or get_registry()
        self.cadence_s = float(cadence_s)
        self.checkpoint_stall_s = float(
            checkpoint_stall_s if checkpoint_stall_s is not None else cadence_s)
        self.starved_after = int(starved_after)
        self._sink = event_sink
        # optional timeline hooks (obs/trace.py, obs/flight.py): every
        # watchdog event also lands as an instant on the span timeline and
        # in the flight recorder's bounded event ring
        self._trace = trace
        self._flight = flight
        self._starved_run = 0
        self._missed = reg.counter(
            "rtap_obs_missed_ticks_total",
            "ticks whose host work exceeded the cadence budget")
        self._events = {
            kind: reg.counter(
                "rtap_obs_watchdog_events_total",
                "structured watchdog events by kind", event=kind)
            for kind in ("missed_tick", "source_starved", "checkpoint_stall")
        }

    def set_cadence(self, cadence_s: float) -> None:
        """Adopt a new cadence mid-run (the degradation ladder's tick_widen
        step changes the real-time contract, and misses are judged against
        the contract in force). The stall budget follows when it was
        tracking the cadence; an explicit checkpoint_stall_s stays put."""
        tracking = self.checkpoint_stall_s == self.cadence_s
        self.cadence_s = float(cadence_s)
        if tracking:
            self.checkpoint_stall_s = self.cadence_s

    def _emit(self, kind: str, tick: int, **fields) -> None:
        self._events[kind].inc()
        if self._trace is not None:
            self._trace.add_instant(kind, int(tick), fields)
        if self._flight is not None:
            self._flight.record_event({"event": kind, "tick": int(tick), **fields})
        if self._sink is not None:
            self._sink({"event": kind, "tick": int(tick), **fields})

    def observe_tick(self, tick: int, elapsed_s: float) -> bool:
        """One tick's wall seconds vs the cadence budget; True = missed."""
        if elapsed_s <= self.cadence_s:
            return False
        self._missed.inc()
        self._emit("missed_tick", tick,
                   elapsed_s=round(float(elapsed_s), 6),
                   cadence_s=self.cadence_s)
        return True

    def observe_source(self, tick: int, values: np.ndarray) -> None:
        """One tick's polled value vector. An all-NaN vector is a tick with
        NO data from ANY stream; `starved_after` in a row means the pipe
        itself is dead."""
        values = np.asarray(values)
        if values.size and bool(np.isnan(values).all()):
            self._starved_run += 1
            if self._starved_run % self.starved_after == 0:
                self._emit("source_starved", tick,
                           consecutive_ticks=self._starved_run)
        else:
            self._starved_run = 0

    def observe_checkpoint(self, tick: int, seconds: float) -> None:
        """One inline checkpoint save's wall seconds (drain + write)."""
        if seconds > self.checkpoint_stall_s:
            self._emit("checkpoint_stall", tick,
                       seconds=round(float(seconds), 6),
                       budget_s=self.checkpoint_stall_s)
