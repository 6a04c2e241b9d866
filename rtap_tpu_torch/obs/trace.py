"""Per-tick tracing: a near-zero-overhead host span recorder.

The port's copy of the JAX package's ``obs/trace.py``. Every span is a
HOST wall interval: on CUDA a ``dispatch`` span measures how long the
host took to enqueue the group's chunk, not the device's execution, and a
``collect`` span measures the host's wait for the chunk's results. No
span synchronises the device (no ``torch.cuda.synchronize()``, no
readback of its own): a synchronising span would change the tick it
measures. Device time is ``python -m rtap_tpu_torch.profile_tick``'s job.

The obs registry (obs/metrics.py) answers "how much / how often"; this
module answers "what was happening *around* tick 48120": every loop phase
and per-group dispatch/collect becomes a SPAN (start + duration, tagged
with its tick index — the trace correlation id), and every watchdog /
resilience event becomes an INSTANT on the same timeline, so a
``group_quarantined`` mark lands visually inside the phase span that
raised it. Export is Chrome trace-event JSON (:meth:`chrome_trace`),
loadable directly in ui.perfetto.dev — via ``serve --trace-out FILE`` or
``GET /trace?last=N`` on the obs HTTP server (obs/expo.py).

Design constraints (same bar as the metrics seam — ≤ 1% of the tick
budget, obs/selfbench.py measures it):

- **No locks on the hot path.** Every writer thread owns a private ring
  shard keyed by ``threading.get_ident()`` — the metrics.py cell-sharding
  trick applied to span records. The loop thread and the dispatch-pool
  threads never touch each other's shards; export merges and sorts (cold
  path only).
- **Preallocated, strictly bounded memory.** Each shard is ONE numpy
  structured array of ``capacity`` records (:data:`REC_DTYPE`, 33 bytes
  each) plus a parallel instant-payload ring whose entries are truncated
  to ``max_arg_bytes``. Appending past capacity overwrites the oldest
  record and counts it in :attr:`dropped` — the recorder can run for an
  unbounded soak without growing.
- **Append is a handful of scalar stores.** One interned-name lookup
  (lock-free dict hit after the first use of a name), one structured-row
  tuple store, one integer increment. No allocation after a (thread,
  name) pair's first record.

Span names come from a small vocabulary (the six loop phases, "tick",
event kinds); the intern table is bounded at ``max_names`` and overflow
maps to ``"<other>"`` so a pathological caller cannot grow host memory
through the name channel.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

__all__ = ["TraceRecorder", "REC_DTYPE"]

#: one trace record: interned name id, kind (0 span / 1 instant), tick
#: correlation id, start offset vs the recorder epoch (perf_counter
#: seconds), duration (0 for instants), group id (-1 = the loop track)
REC_DTYPE = np.dtype([
    ("name", np.int32),
    ("kind", np.int8),
    ("tick", np.int64),
    ("t0", np.float64),
    ("dur", np.float64),
    ("group", np.int32),
])

_KIND_SPAN = 0
_KIND_INSTANT = 1


class _Shard:
    """One writer thread's private ring (no cross-thread writes)."""

    __slots__ = ("recs", "aux", "n")

    def __init__(self, capacity: int):
        self.recs = np.zeros(capacity, REC_DTYPE)
        self.aux: list = [None] * capacity  # instant payloads (json str)
        self.n = 0  # total appended; ring index = n % capacity


class TraceRecorder:
    """Lock-free bounded span/instant ring with Chrome trace-event export.

    ``capacity`` is PER WRITER THREAD (the loop thread plus each dispatch
    pool worker gets its own ring); total memory is
    ``n_threads * capacity * (REC_DTYPE.itemsize + max_arg_bytes)`` worst
    case (the bound the trace tests assert).
    """

    def __init__(self, capacity: int = 65536, max_names: int = 1024,
                 max_arg_bytes: int = 256,
                 process_name: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self.max_names = int(max_names)
        self.max_arg_bytes = int(max_arg_bytes)
        #: Perfetto process label (fleet stitching keys member traces by
        #: it); settable after construction — serve learns its role late
        self.process_name = process_name
        # perf_counter is the span clock (monotonic, sub-us); the unix
        # anchor lets a reader align the trace with alert-line timestamps
        self.epoch_perf = time.perf_counter()
        self.epoch_unix = time.time()
        self._shards: dict[int, _Shard] = {}
        self._names: dict[str, int] = {"<other>": 0}
        self._names_rev: list[str] = ["<other>"]
        self._names_lock = threading.Lock()

    # ------------------------------------------------------------ write --
    def _shard(self) -> _Shard:
        tid = threading.get_ident()
        shard = self._shards.get(tid)
        if shard is None:
            shard = self._shards.setdefault(tid, _Shard(self.capacity))
        return shard

    def _name_id(self, name: str) -> int:
        nid = self._names.get(name)
        if nid is not None:
            return nid
        with self._names_lock:
            nid = self._names.get(name)
            if nid is None:
                if len(self._names_rev) >= self.max_names:
                    return 0  # bounded vocabulary: overflow -> "<other>"
                nid = len(self._names_rev)
                self._names_rev.append(name)
                self._names[name] = nid
        return nid

    def add_span(self, name: str, tick: int, t0: float, dur: float,
                 group: int = -1) -> None:
        """Record one completed span. `t0` is a ``time.perf_counter()``
        reading (the caller already holds one from its own phase
        accounting — re-reading the clock here would double the cost)."""
        shard = self._shard()
        i = shard.n % self.capacity
        shard.recs[i] = (self._name_id(name), _KIND_SPAN, tick,
                         t0 - self.epoch_perf, dur, group)
        shard.aux[i] = None
        shard.n += 1

    def add_instant(self, name: str, tick: int, fields: dict | None = None,
                    group: int = -1) -> None:
        """Record one instant event (watchdog/resilience marks). `fields`
        is serialized now, truncated to `max_arg_bytes` — bounded memory
        beats a perfectly preserved payload (the full event also rides
        the alert JSONL stream)."""
        shard = self._shard()
        i = shard.n % self.capacity
        shard.recs[i] = (self._name_id(name), _KIND_INSTANT, tick,
                         time.perf_counter() - self.epoch_perf, 0.0, group)
        aux = None
        if fields:
            try:
                aux = json.dumps(fields)[: self.max_arg_bytes]
            except (TypeError, ValueError):
                aux = repr(fields)[: self.max_arg_bytes]
        shard.aux[i] = aux
        shard.n += 1

    # ------------------------------------------------------------- read --
    def _shard_list(self) -> list[_Shard]:
        for _ in range(8):
            try:
                return list(self._shards.values())
            except RuntimeError:  # dict resize under a brand-new writer
                continue
        return list(dict(self._shards).values())

    @property
    def total(self) -> int:
        """Records ever appended (spans + instants, including dropped)."""
        return sum(s.n for s in self._shard_list())

    @property
    def dropped(self) -> int:
        """Records overwritten by ring wrap-around."""
        return sum(max(0, s.n - self.capacity) for s in self._shard_list())

    def nbytes(self) -> int:
        """Current preallocated ring memory (structured arrays only; the
        instant-payload rings add at most capacity * max_arg_bytes per
        shard on top). The bound tests assert against this."""
        return sum(s.recs.nbytes for s in self._shard_list())

    def records(self, last_ticks: int | None = None) -> list[dict]:
        """Merged retained records as dicts, sorted by start time.

        `last_ticks=N` keeps only records whose tick is within the last N
        ticks seen across the whole recorder (instants and spans alike);
        records with tick < 0 (unticked) are always kept.
        """
        shards = [(s, min(s.n, self.capacity)) for s in self._shard_list()]
        lo = None
        if last_ticks is not None:
            # window at the numpy layer BEFORE building dicts: a live
            # /trace?last=10 poll must cost O(window), not O(full ring)
            # of GIL-holding dict construction under the serve loop
            hi = max((int(s.recs["tick"][:n].max())
                      for s, n in shards if n), default=None)
            if hi is None:
                return []
            lo = hi - int(last_ticks) + 1
        out = []
        for shard, n in shards:
            if lo is not None:
                ticks = shard.recs["tick"][:n]
                idx = np.nonzero((ticks >= lo) | (ticks < 0))[0]
            else:
                idx = range(n)
            for j in idx:
                r = shard.recs[j]
                rec = {
                    "name": self._names_rev[int(r["name"])],
                    "kind": "span" if r["kind"] == _KIND_SPAN else "instant",
                    "tick": int(r["tick"]),
                    "t0": float(r["t0"]),
                    "dur": float(r["dur"]),
                    "group": int(r["group"]),
                }
                if shard.aux[j] is not None:
                    rec["args_json"] = shard.aux[j]
                out.append(rec)
        out.sort(key=lambda r: r["t0"])
        return out

    def chrome_trace(self, last_ticks: int | None = None) -> dict:
        """The retained timeline as Chrome trace-event JSON (the object
        form: ``{"traceEvents": [...]}``), loadable in ui.perfetto.dev.

        Track layout: tid 0 is the loop thread (phase spans + tick spans
        + untargeted instants); each group `g` gets tid ``g + 1`` for its
        dispatch/collect child spans and group-targeted instants.
        Timestamps are microseconds since the recorder epoch. ``pid`` is
        the REAL process id and a ``process_name`` metadata event labels
        the track — two traces from a leader/standby pair drop onto one
        Perfetto timeline as distinct processes (the otherData epoch
        anchors are what a fleet trace stitcher aligns clocks with).
        """
        recs = self.records(last_ticks=last_ticks)
        pid = os.getpid()
        events: list[dict] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": self.process_name or f"rtap-{pid}"},
        }, {
            "ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
            "args": {"name": "serve loop"},
        }]
        seen_groups: set[int] = set()
        for r in recs:
            g = r["group"]
            tid = 0 if g < 0 else g + 1
            if g >= 0 and g not in seen_groups:
                seen_groups.add(g)
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": f"group{g}"},
                })
            args: dict = {"tick": r["tick"]}
            if g >= 0:
                args["group"] = g
            if "args_json" in r:
                try:
                    args.update(json.loads(r["args_json"]))
                except ValueError:
                    args["info"] = r["args_json"]
            ev = {
                "name": r["name"],
                "cat": "phase" if g < 0 else "group",
                "pid": pid,
                "tid": tid,
                "ts": round(r["t0"] * 1e6, 3),
                "args": args,
            }
            if r["kind"] == "span":
                ev["ph"] = "X"
                ev["dur"] = round(r["dur"] * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "g"  # global scope: the mark spans all tracks
                ev["cat"] = "event"
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "pid": pid,
                "process_name": self.process_name or f"rtap-{pid}",
                "epoch_unix": self.epoch_unix,
                "epoch_perf": self.epoch_perf,
                "total_records": self.total,
                "dropped_records": self.dropped,
            },
        }
