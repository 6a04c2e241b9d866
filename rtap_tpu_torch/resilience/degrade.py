"""Graceful degradation: shed load in declared steps under sustained misses.

The port's copy of the JAX package's ``resilience/degrade.py`` (same
ladder, same hysteresis, same events). The 1 s cadence is a real-time contract, and the watchdog already NAMES the
failure (missed_tick events); this controller REACTS to it. When deadline
misses persist, the loop sheds load down a declared ladder instead of
missing every deadline at full quality:

    level 0  normal           — full-rate learning, declared cadence
    level 1  learn_thin       — learn only every ``thin_factor``-th tick
                                (applied at dispatch time through the
                                per-chunk learn flag)
    level 2  score_only       — freeze learning entirely (the TM learning
                                kernel is not launched); scores and alerts
                                still flow, likelihood keeps adapting
    level 3  tick_widen       — widen the effective cadence by
                                ``widen_factor`` (score every sample we
                                can, admit the contract changed — and say
                                so on the alert stream)

Hysteresis keeps the ladder from flapping: escalate after ``degrade_after``
misses inside a sliding window of ``window`` ticks, de-escalate one level
only after ``recover_after`` CONSECUTIVE clean ticks. Every transition
emits a structured ``degraded``/``recovered`` event (alert JSONL stream)
and moves the ``rtap_obs_degradation_level`` gauge, so a scraper sees the
ladder position and the alert file says when and why it moved.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

from rtap_tpu_torch.obs import get_registry

__all__ = ["DegradationController", "LADDER"]

#: the declared ladder, in escalation order (level = index + 1)
LADDER = ("learn_thin", "score_only", "tick_widen")


class DegradationController:
    """Hysteresis state machine from per-tick miss facts to a shed level.

    Drive it with :meth:`observe` once per tick; read the effects through
    :meth:`learn_allowed` and :meth:`cadence_scale`. ``event_sink`` is any
    JSON-able-dict callable (the loop passes ``AlertWriter.emit_event``).
    """

    def __init__(self, window: int = 10, degrade_after: int = 3,
                 recover_after: int = 15, thin_factor: int = 4,
                 widen_factor: float = 2.0,
                 event_sink: Callable[[dict], None] | None = None):
        if window < 1 or degrade_after < 1 or recover_after < 1:
            raise ValueError(
                "window, degrade_after, recover_after must all be >= 1; got "
                f"{window}, {degrade_after}, {recover_after}")
        if degrade_after > window:
            raise ValueError(
                f"degrade_after ({degrade_after}) can never trigger inside a "
                f"window of {window} ticks")
        if thin_factor < 2:
            raise ValueError(f"thin_factor must be >= 2; got {thin_factor}")
        if widen_factor <= 1.0:
            raise ValueError(f"widen_factor must be > 1; got {widen_factor}")
        self.window = int(window)
        self.degrade_after = int(degrade_after)
        self.recover_after = int(recover_after)
        self.thin_factor = int(thin_factor)
        self.widen_factor = float(widen_factor)
        #: event sink (JSON-able-dict callable); live_loop fills it with
        #: AlertWriter.emit_event when the caller left it None
        self.sink = event_sink
        self.level = 0
        self.max_level_seen = 0
        self.transitions = 0
        self._recent = deque(maxlen=self.window)  # sliding miss window
        self._clean_run = 0
        obs = get_registry()
        self._obs_level = obs.gauge(
            "rtap_obs_degradation_level",
            "current load-shedding ladder position (0 = normal; "
            "1 learn_thin, 2 score_only, 3 tick_widen)")
        self._obs_level.set(0)
        self._obs_events = {
            kind: obs.counter(
                "rtap_obs_resilience_events_total",
                "structured resilience events by kind", event=kind)
            for kind in ("degraded", "recovered")
        }

    def _emit(self, kind: str, tick: int, **fields) -> None:
        self._obs_events[kind].inc()
        if self.sink is not None:
            self.sink({"event": kind, "tick": int(tick), **fields})

    def _step_name(self, level: int) -> str:
        return "normal" if level == 0 else LADDER[level - 1]

    def observe(self, tick: int, missed: bool) -> int:
        """One tick's deadline verdict; returns the (possibly new) level.

        Escalation clears the miss window (the NEW level gets a fresh
        window to prove itself — without this, one bad burst would ride
        the ladder to the bottom in consecutive ticks regardless of
        whether shedding helped). Recovery is one level at a time.
        """
        self._recent.append(bool(missed))
        if missed:
            self._clean_run = 0
            if sum(self._recent) >= self.degrade_after \
                    and self.level < len(LADDER):
                self.level += 1
                self.max_level_seen = max(self.max_level_seen, self.level)
                self.transitions += 1
                self._recent.clear()
                self._obs_level.set(self.level)
                self._emit("degraded", tick, level=self.level,
                           step=self._step_name(self.level))
        else:
            self._clean_run += 1
            if self.level > 0 and self._clean_run >= self.recover_after:
                self.level -= 1
                self.transitions += 1
                self._clean_run = 0
                self._obs_level.set(self.level)
                self._emit("recovered", tick, level=self.level,
                           step=self._step_name(self.level))
        return self.level

    def learn_allowed(self, tick: int) -> bool:
        """Whether the loop may dispatch this tick's chunk with learning.

        Level 1 thins to every ``thin_factor``-th tick; level >= 2 freezes
        learning entirely. (Composes with the caller's own ``learn`` flag —
        the controller only ever REMOVES learning, never adds it.)"""
        if self.level == 0:
            return True
        if self.level == 1:
            return tick % self.thin_factor == 0
        return False

    @property
    def cadence_scale(self) -> float:
        """Multiplier on the declared cadence (level 3 widens the tick)."""
        return self.widen_factor if self.level >= 3 else 1.0

    def stats(self) -> dict:
        return {"level": self.level, "max_level": self.max_level_seen,
                "transitions": self.transitions}
