"""Alert emission + throughput accounting (host side).

The port's copy of the JAX package's ``service/alerts.py``: one JSONL
object per alert, byte for byte the JAX package's lines
(:func:`format_alert_line`), structured events on the same stream, the
alert-delivery cursor and resume suppression that make alerts exactly-once
across a crash, the incident correlator's fold of every delivered alert,
and the "anomaly-scored metrics/sec" counter, with the per-alert
``top_fields`` attribution, the detection-latency hook and the leader
fence (a lease-holder probe consulted before every sink write).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import IO

import numpy as np

from rtap_tpu_torch.obs import get_registry
from rtap_tpu_torch.resilience.policies import CircuitBreaker


def format_alert_line(alert_id, stream: str, ts: int, value,
                      raw_score: float, log_likelihood: float,
                      top_fields=None) -> str:
    """THE alert-line serialization, identical to the JAX package's for
    identical inputs. ``value`` may be a scalar or a 1-D multivariate
    row."""
    val = np.asarray(value)
    return json.dumps(
        {
            **({"alert_id": alert_id} if alert_id is not None else {}),
            "stream": stream,
            "ts": int(ts),
            "value": float(val) if val.ndim == 0
            else [float(x) for x in val],
            "raw_score": float(raw_score),
            "log_likelihood": float(log_likelihood),
            **({"top_fields": top_fields} if top_fields is not None else {}),
        }
    ) + "\n"


def heal_torn_tail(path: str) -> int:
    """Append a newline if `path` ends mid-line (a writer killed
    mid-``write``): the fragment becomes its own unparseable — and
    therefore skipped — line instead of merging with the next append and
    corrupting both records. Returns bytes added (0 or 1); a missing,
    empty or unwritable path heals nothing."""
    try:
        with open(path, "rb") as f:
            f.seek(-1, 2)
            if f.read(1) == b"\n":
                return 0
    except (OSError, ValueError):
        return 0
    try:
        with open(path, "a") as f:
            f.write("\n")
    except OSError:
        return 0
    return 1


class AlertWriter:
    """JSONL alert sink. One line per (stream, tick) whose score crosses the
    threshold; `None` path writes nowhere but still counts. Structured
    events (`emit_event`) share the stream, discriminated by their "event"
    key.

    The sink is non-fatal: a full disk must never kill scoring. Every write
    goes through retry-then-quarantine — one immediate retry on
    ``OSError``, then a circuit breaker (3 consecutive failed batches open
    it): lines are counted and dropped (``dropped``) until the cooldown
    admits a probe batch. ``count`` tracks threshold crossings regardless
    of sink health.

    `flush_every=N` flushes once per N batches instead of per batch; events
    always flush.

    Durability: every alert line carries a stable ``alert_id``
    (``group:stream:tick`` — the group index, the stream id and the
    group's own tick counter) whenever the caller supplies ``group`` and
    ``tick``. The writer tracks its byte offset into the sink
    (``sink_offset``; checkpoint meta records it at drained save instants)
    and can be armed with a resume suppression set (``arm_suppression``):
    ids already on disk from a crashed run are counted and NOT re-written
    during journal replay. Opening an existing sink whose last line was
    torn first heals it with a newline.

    `correlator` (correlate.IncidentCorrelator): every alert batch that
    reached the sink, suppressed lines left out, also folds into the
    correlator's windows, with the sink offset before the batch as its
    crash-resume anchor — so the fold mirrors the disk exactly once.

    `attributor` (service.attribution.AlertAttributor, serve
    --alert-attribution): alert lines gain a ``top_fields`` block; its
    history advances on every batch, alert or not.

    `latency` (obs.LatencyTracker, serve --latency): every batch that
    reached the sink observes wall clock minus each alert's source
    timestamp into the end-to-end ``detect`` sketch. Pure observation: the
    bytes on the stream are the same with it or without it.
    """

    def __init__(self, path: str | None = None, flush_every: int = 1, breaker=None,
                 attributor=None, fence=None, correlator=None, latency=None):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1; got {flush_every}")
        self.path = path
        # leader fencing (resilience/replicate.py): consulted before every
        # sink write; False means this process lost the leadership lease —
        # a paused old leader that wakes up after a standby promoted must
        # not append to the sink the new leader owns. Fenced lines are
        # dropped and counted, never written (the loop also exits on fence
        # loss; this is the last-line guard under it)
        self._fence = fence
        self.fenced_drops = 0
        self._attributor = attributor
        self._correlator = correlator
        self._latency = latency
        self._offset = 0  # bytes handed to the sink (the alert cursor)
        self.torn_heals = 0
        if path:
            try:
                self._offset = os.path.getsize(path)
            except OSError:
                self._offset = 0
            self.torn_heals = heal_torn_tail(path)
            self._offset += self.torn_heals
        self._fh: IO[str] | None = open(path, "a") if path else None
        self.count = 0
        self.suppressed = 0  # resume-suppressed (already-delivered) lines
        self._suppress: set[str] = set()
        self.dropped = 0
        self.sink_quarantines = 0  # times the breaker opened on the sink
        self.flush_every = int(flush_every)
        self._batches_since_flush = 0
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            fail_threshold=3, cooldown_s=5.0, name="alert_sink")
        obs = get_registry()
        self._obs_alerts = obs.counter(
            "rtap_obs_alerts_total", "alert lines emitted (threshold "
            "crossings that survived debounce)")
        self._obs_events = obs.counter(
            "rtap_obs_alert_stream_events_total",
            "structured watchdog/ops events written to the alert stream")
        self._obs_emit = obs.histogram(
            "rtap_obs_alert_emit_seconds",
            "wall seconds per emit_batch call (JSONL format + write + flush)")
        self._obs_sink_errors = obs.counter(
            "rtap_obs_alert_sink_errors_total",
            "OSError write/flush failures against the alert sink (each "
            "failed batch counts once, after its immediate retry)")
        self._obs_dropped = obs.counter(
            "rtap_obs_alert_lines_dropped_total",
            "alert/event lines dropped while the sink was failing or "
            "quarantined (full disk etc. — scoring continued)")
        self._obs_suppressed = obs.counter(
            "rtap_obs_alerts_suppressed_total",
            "already-delivered alert ids suppressed during journal/"
            "checkpoint resume (exactly-once across a crash)")
        self._obs_quarantined = {
            kind: obs.counter(
                "rtap_obs_resilience_events_total",
                "structured resilience events by kind", event=kind)
            for kind in ("alert_sink_quarantined", "alert_sink_restored")
        }
        self._obs_fenced = obs.counter(
            "rtap_obs_alert_lines_fenced_total",
            "alert/event lines refused because this process lost the "
            "leadership lease (a fenced old leader must never append to "
            "the sink a promoted standby now owns)")

    def wrap_sink(self, wrap) -> None:
        """Wrap the underlying file object (the chaos engine's injection
        seam: faults land UNDER the retry/quarantine path, proving it)."""
        if self._fh is not None:
            self._fh = wrap(self._fh)

    def _safe_write(self, lines: list[str], force_flush: bool = False) -> bool:
        """Write + maybe flush, retry once, quarantine via the breaker.
        Never raises; failed/skipped lines are counted in ``dropped``.
        Returns True iff the lines were handed to the sink (one
        writelines call of one string: all or nothing)."""
        if self._fh is None or not lines:
            return False
        if self._fence is not None and not self._fence():
            self.fenced_drops += len(lines)
            self._obs_fenced.inc(len(lines))
            return False
        if not self._breaker.allow():
            self.dropped += len(lines)
            self._obs_dropped.inc(len(lines))
            return False
        was_closed = self._breaker.state == self._breaker.CLOSED
        wrote = False  # a flush-only failure must not re-write the lines
        for attempt in (1, 2):
            try:
                if not wrote:
                    # the batch as ONE string: line by line, the text layer
                    # hands the OS ~8 KB at a time, and a leader paused
                    # mid-batch would finish a tick's lines after its
                    # standby took over
                    self._fh.writelines(["".join(lines)])
                    wrote = True
                    self._offset += sum(len(ln.encode("utf-8", "replace"))
                                        for ln in lines)
                    self._batches_since_flush += 1
                if force_flush or self._batches_since_flush >= self.flush_every:
                    self._fh.flush()
                    self._batches_since_flush = 0
                self._breaker.record_success()
                if not was_closed:
                    self._obs_quarantined["alert_sink_restored"].inc()
                    self.emit_event({"event": "alert_sink_restored",
                                     "lines_dropped": self.dropped})
                return True
            except OSError:
                if attempt == 2:
                    self._obs_sink_errors.inc()
                    if not wrote:
                        # flush-only failures leave the lines in the stdio
                        # buffer: they land on a later successful flush
                        self.dropped += len(lines)
                        self._obs_dropped.inc(len(lines))
                    self._breaker.record_failure()
                    if self._breaker.state == self._breaker.OPEN:
                        self.sink_quarantines += 1
                        self._obs_quarantined["alert_sink_quarantined"].inc()
        return wrote

    def arm_suppression(self, alert_ids: set[str]) -> None:
        """Arm the resume suppression set: lines whose ``alert_id`` is in
        the set are counted as already delivered and NOT re-written (the
        set shrinks as ids match)."""
        self._suppress |= set(alert_ids)

    def sink_offset(self) -> int:
        """Bytes handed to the sink so far — the alert-delivery cursor
        recorded in checkpoint meta (flush first via :meth:`flush_sink` so
        the cursor equals the on-disk size at a drained instant)."""
        return self._offset

    def flush_sink(self) -> None:
        """Force the sink's stdio buffer to the kernel (best effort —
        failures feed the breaker on the next write, never raise)."""
        if self._fh is None:
            return
        try:
            self._fh.flush()
            self._batches_since_flush = 0
        except OSError:
            pass

    def emit_batch(self, stream_ids: list[str], ts: np.ndarray, values: np.ndarray,
                   raw: np.ndarray, log_likelihood: np.ndarray, alerts: np.ndarray,
                   group: int | str | None = None, tick: int | None = None) -> int:
        """Write one JSONL line per alerting stream; returns the alert
        count. ``group`` + ``tick`` (the group index and the group's own
        tick counter for this row) give every line its stable
        ``alert_id``."""
        t0 = time.perf_counter()
        idx = np.nonzero(alerts)[0]
        self.count += idx.size  # crossings scored, sink/suppression aside
        suppressed_this = 0
        attr = None
        if self._attributor is not None:
            # history advances on every batch; the per-alert decode only
            # when a sink will carry it
            attr = self._attributor.update_and_attribute(
                stream_ids, values, idx if self._fh is not None else idx[:0])
        if self._fh is not None and idx.size:
            ts = np.broadcast_to(np.asarray(ts), alerts.shape)
            values = np.asarray(values)
            with_id = group is not None and tick is not None
            lines = []
            folds = []
            lat_ts = [] if self._latency is not None else None
            for g in idx:
                aid = f"{group}:{stream_ids[g]}:{int(tick)}" if with_id else None
                if aid is not None and self._suppress and aid in self._suppress:
                    # already delivered by the run that crashed: counted,
                    # never duplicated (exactly-once across the crash)
                    self._suppress.discard(aid)
                    self.suppressed += 1
                    suppressed_this += 1
                    self._obs_suppressed.inc()
                    continue
                tf = attr.get(int(g), []) if attr is not None else None
                if self._correlator is not None:
                    folds.append((aid, stream_ids[g], int(ts[g]), tf))
                if lat_ts is not None:
                    lat_ts.append(int(ts[g]))
                lines.append(format_alert_line(
                    aid, stream_ids[g], int(ts[g]), values[g],
                    float(raw[g]), float(log_likelihood[g]), top_fields=tf))
            off0 = self._offset
            # a dropped batch must not seed windows with ids that exist
            # nowhere on the stream: the resume re-fold reads the disk
            if self._safe_write(lines):
                for aid, sid, tsi, tf in folds:
                    self._correlator.observe_alert(aid, sid, tsi, top_fields=tf,
                                                   sink_offset=off0)
                if lat_ts:
                    # e2e detect latency at the delivery moment: wall clock
                    # minus each alert's source timestamp
                    self._latency.observe_detect(
                        time.time() - np.asarray(lat_ts, np.float64))
        emitted = int(idx.size) - suppressed_this
        if emitted:
            self._obs_alerts.inc(emitted)
        self._obs_emit.observe(time.perf_counter() - t0)
        return int(idx.size)

    def emit_event(self, event: dict) -> None:
        """Write one structured event line. Events carry an "event" key,
        serialized first whatever the caller's dict order (consumers split
        on the literal prefix '{"event"'), and flush immediately."""
        self.emit_events([event])

    def emit_events(self, events: list[dict]) -> None:
        """Write several event lines in one write and flush: a process
        killed during the call leaves all of them in the sink or none (a
        precursor and the predicted_incident it opens go together)."""
        for event in events:
            if "event" not in event:
                raise ValueError(f"structured events need an 'event' key: {event}")
        self._obs_events.inc(len(events))
        self._safe_write(
            [json.dumps({"event": ev["event"], **ev}) + "\n" for ev in events],
            force_flush=True)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def iter_alert_records(path: str, offset: int = 0):
    """THE tolerant alert-stream line iterator: yields ``(kind, record)``
    in file order from byte ``offset``: ``"event"`` (a dict carrying an
    "event" key), ``"alert"`` (a dict) or ``"garbage"`` (the raw line: a
    torn fragment or a non-object). A missing file yields nothing."""
    try:
        with open(path) as f:
            f.seek(max(0, int(offset)))
            for line in f:
                stripped = line.strip()
                if not stripped:
                    continue
                try:
                    d = json.loads(stripped)
                except ValueError:
                    yield "garbage", line
                    continue
                if not isinstance(d, dict):
                    yield "garbage", line
                    continue
                yield ("event" if "event" in d else "alert"), d
    except OSError:
        return


def scan_alert_ids(path: str, offset: int = 0) -> set[str]:
    """Alert ids already on disk at/after byte `offset` — the resume
    suppression set (the checkpoint meta's alert cursor bounds the scan to
    the post-checkpoint window). Events and torn fragments are skipped: a
    torn line never fully delivered its alert, so replay re-emits it."""
    ids: set[str] = set()
    for kind, d in iter_alert_records(path, offset):
        if kind != "alert":
            continue
        aid = d.get("alert_id")
        if aid:
            ids.add(aid)
    return ids


def scan_event_ids(path: str, offset: int = 0) -> set[str]:
    """Event-line alert ids already on disk at/after byte `offset` — the
    resume suppression set for the id-carrying ``precursor`` and
    ``predicted_incident`` lines, whose ids are pure functions of (stream,
    group tick), so a journal replay reproduces them. Same walker and
    cursor as :func:`scan_alert_ids`; alert records and other events are
    skipped."""
    ids: set[str] = set()
    for kind, d in iter_alert_records(path, offset):
        if kind != "event" or d.get("event") not in ("precursor", "predicted_incident"):
            continue
        aid = d.get("alert_id")
        if aid:
            ids.add(aid)
    return ids


@dataclass
class ThroughputCounter:
    """Counts scored metrics against wall clock -> metrics/sec."""

    start: float = field(default_factory=time.perf_counter)
    scored: int = 0

    def add(self, n: int) -> None:
        self.scored += int(n)

    @property
    def elapsed(self) -> float:
        return max(time.perf_counter() - self.start, 1e-9)

    @property
    def metrics_per_sec(self) -> float:
        return self.scored / self.elapsed

    def stats(self) -> dict:
        return {
            "scored": self.scored,
            "elapsed_s": round(self.elapsed, 3),
            "metrics_per_sec": round(self.metrics_per_sec, 1),
        }
