"""Windowed topology-aware incident correlation.

The port's copy of the JAX package's ``correlate/incidents.py``.

The blast radius of a real distributed-systems fault is a correlated
burst of per-stream alerts across ADJACENT nodes — a scenario no
per-stream detector covers (ROADMAP item 4). This host-side layer folds
the alert line stream into cluster-level incident records:

- every emitted alert (keyed by its stable ``alert_id``, which is
  what makes the fold crash/replay/failover-safe by construction) lands
  in the open window of its stream's topology cluster
  (:class:`~rtap_tpu_torch.correlate.topology.TopologyMap`);
- a window closes after ``window_s`` seconds of cluster QUIESCENCE (no
  new member) — hysteresis: a re-burst inside the window extends the
  same incident instead of paging a second one — or at the
  ``max_span_s`` hard bound under continuous alerting;
- a closed window with >= ``min_streams`` distinct streams emits ONE
  ``incident`` event line on the alert stream (the operator pages once
  per fault, not once per stream), carrying the member alert_ids, the
  blast-radius node set, onset/end timestamps, and the attributed
  fields aggregated from the members' ``top_fields``; below-threshold
  windows expire silently (the per-stream alert lines already told
  that story).

Crash safety: the incident_id is a pure content hash of the member
alert_ids, and :meth:`IncidentCorrelator.resume_from` re-folds the
alert sink tail through the SAME shared tolerant line walker the resume
suppression scan uses (service/alerts.iter_alert_records). The scan
starts at the ``<alerts>.corr`` sidecar floor — the sink offset at/
under the oldest open window's first member, persisted on window open/
close transitions — because the checkpoints' alert cursors can sit
PAST an open window's earlier members. Replayed already-delivered
alerts are suppressed upstream and re-enter the fold from disk instead;
incidents whose event line landed pre-crash dedupe by id (and the event
line settles its cluster's window mid-scan, pinning the re-fold to the
live closure point); incidents that closed pre-crash but never hit the
disk re-emit. The incident stream is therefore exactly-once across
kill-9. Known residual: a window that expired BELOW
min_streams leaves no marker line, so a pipeline-lagged alert whose ts
lands within one tick of the quiescence boundary can merge with the
expired window's members on a re-fold that spans it — a one-tick band,
reachable only when a crash interleaves exactly there, and bounded by
sizing window_s above the pipeline staleness.

Every timestamp here is the SOURCE clock (the loop's monotonic-clamped
tick ts), never the wall clock, so a journal replay reproduces every
close decision bit-for-bit. Choose ``window_s`` comfortably above the
serve pipeline's alert staleness (``pipeline_depth * micro_chunk``
ticks) — a lagged member must still land inside its window.
"""

from __future__ import annotations

import hashlib
import threading
from collections import deque

from rtap_tpu_torch.obs.metrics import get_registry

__all__ = ["IncidentCorrelator", "incident_id_of"]

#: hard bound on one window's member list — beyond it, members are
#: counted (``members_dropped``), not stored; a pathological fleet-wide
#: alert storm must not grow host memory without bound
MAX_MEMBERS_PER_WINDOW = 8192

#: remembered already-emitted incident ids (dedupe across resume); FIFO
#: eviction — the window only needs to cover incidents whose members can
#: still be re-folded from the scanned sink tail
MAX_EMITTED_TRACKED = 8192


def incident_id_of(alert_ids) -> str:
    """Deterministic content-derived incident id: a 48-bit blake2b over
    the SORTED member alert_ids. The same fault re-folded after a crash/
    replay/failover reproduces the same id — the dedupe key of the
    exactly-once incident stream. 48 bits (not a 32-bit CRC) because a
    dedupe-key collision SILENTLY suppresses a real incident: at the
    MAX_EMITTED_TRACKED=8192 dedupe horizon the birthday odds are ~0.8%
    for 32 bits vs ~1e-7 here."""
    blob = ",".join(sorted(alert_ids)).encode()
    return f"inc-{hashlib.blake2b(blob, digest_size=6).hexdigest()}"


class _Window:
    __slots__ = ("first_ts", "last_ts", "alert_ids", "streams", "nodes",
                 "fields", "dropped", "start_off")

    def __init__(self, ts: int, start_off: int | None = None):
        self.first_ts = ts
        self.last_ts = ts
        self.alert_ids: list[str] = []
        self.streams: set[str] = set()
        self.nodes: set[str] = set()
        self.fields: dict[str, int] = {}
        self.dropped = 0
        #: alert-sink byte offset BEFORE this window's first member (the
        #: crash-resume re-fold must start at/before it — see sidecar)
        self.start_off = start_off


class IncidentCorrelator:
    """Fold per-stream alerts into cluster-level incidents (module doc).

    Wiring (serve ``--topology``): the AlertWriter calls
    :meth:`observe_alert` per emitted line, the live loop calls
    :meth:`on_tick` once per tick (and per replayed journal row) with
    the tick's source timestamp, and incident events leave through
    ``sink`` (the writer's ``emit_event`` — one stream tells the whole
    story in order). ``snapshot`` backs ``GET /incidents``.
    """

    def __init__(self, topology, window_s: int = 30, min_streams: int = 3,
                 max_span_s: int | None = None, blast_dump_nodes: int = 4,
                 sink=None, flight=None, registry=None,
                 sidecar_path: str | None = None):
        if window_s < 1:
            raise ValueError(f"window_s must be >= 1; got {window_s}")
        if min_streams < 2:
            raise ValueError(
                f"min_streams must be >= 2 (one stream is a per-stream "
                f"alert, not an incident); got {min_streams}")
        self.topology = topology
        self.window_s = int(window_s)
        self.min_streams = int(min_streams)
        # continuous alerting must not hold a window open forever: the
        # hard span bound force-closes (and a genuinely ongoing fault
        # then opens a follow-up incident — operators prefer a second
        # page over a silent hour)
        self.max_span_s = int(max_span_s) if max_span_s is not None \
            else 10 * self.window_s
        if self.max_span_s < self.window_s:
            raise ValueError(
                f"max_span_s must be >= window_s; got {self.max_span_s} "
                f"< {self.window_s}")
        self.blast_dump_nodes = int(blast_dump_nodes)
        self.sink = sink
        self.flight = flight
        # crash-resume scan floor (``<alerts>.corr``, the ``.epoch``
        # sidecar idiom): the sink byte offset at/under the oldest OPEN
        # window's first member. The checkpoints' alert cursors alone
        # are NOT a safe re-fold start — a checkpoint taken mid-window
        # has a cursor PAST that window's earlier members, and a re-fold
        # from it would rebuild a smaller member set whose content-hash
        # incident_id differs from the uninterrupted run's (a duplicate/
        # divergent page). A stale-small sidecar only lengthens the
        # scan, never breaks it, so updates happen on the rare window
        # open/close transitions, not per fold.
        self.sidecar_path = sidecar_path
        self._sidecar_written: int | None = None
        self._open: dict[str, _Window] = {}
        # the loop thread folds/closes while a reader thread may snapshot:
        # one re-entrant lock (resume_from re-enters observe_alert/on_tick)
        # keeps the container iteration safe
        self._lock = threading.RLock()
        self._emitted: set[str] = set()
        self._emitted_order: deque = deque()
        #: recent incident records (bounded), newest last — /incidents
        self._recent: deque = deque(maxlen=256)
        self._replaying = False
        self._replay_pending: list[dict] = []
        # counters/gauges (docs/TELEMETRY.md incident section)
        obs = registry if registry is not None else get_registry()
        self._obs_incidents = obs.counter(
            "rtap_obs_incidents_total",
            "cluster-level incidents emitted onto the alert stream")
        self._obs_correlated = obs.counter(
            "rtap_obs_incident_alerts_correlated_total",
            "alert lines folded into correlation windows")
        self._obs_open = obs.gauge(
            "rtap_obs_incident_open_windows",
            "correlation windows currently open (one per alerting "
            "topology cluster)")
        self._obs_members = obs.histogram(
            "rtap_obs_incident_members",
            "member alert count per emitted incident")
        self._obs_blast = obs.histogram(
            "rtap_obs_incident_blast_nodes",
            "blast-radius node count per emitted incident")
        self._obs_expired = obs.counter(
            "rtap_obs_incident_windows_expired_total",
            "correlation windows that closed below min_streams (the "
            "per-stream alerts already told that story)")
        self._obs_deduped = obs.counter(
            "rtap_obs_incident_resume_deduped_total",
            "incidents suppressed on resume because their event line "
            "already reached the sink (exactly-once across a crash)")
        # plain-int mirrors for stats()
        self.incidents = 0
        self.correlated = 0
        self.expired = 0
        self.deduped = 0
        self.members_dropped = 0

    # ---- the fold ----
    def observe_alert(self, alert_id: str | None, stream: str, ts: int,
                      top_fields=None, sink_offset: int | None = None) -> None:
        """Fold one emitted alert into its cluster's open window.
        ``sink_offset`` is the alert sink's byte offset BEFORE the batch
        carrying this alert (the AlertWriter passes it) — it anchors the
        crash-resume sidecar floor."""
        with self._lock:
            self._observe_alert(alert_id, stream, ts, top_fields,
                                sink_offset)

    def _observe_alert(self, alert_id, stream, ts, top_fields,
                       sink_offset=None) -> None:
        ts = int(ts)
        cluster = self.topology.cluster_of(stream)
        w = self._open.get(cluster)
        if w is None:
            w = self._open[cluster] = _Window(ts, start_off=sink_offset)
            self._obs_open.set(len(self._open))
            self._update_sidecar()
        w.last_ts = max(w.last_ts, ts)
        w.first_ts = min(w.first_ts, ts)
        if len(w.alert_ids) < MAX_MEMBERS_PER_WINDOW:
            if alert_id is not None:
                w.alert_ids.append(alert_id)
        else:
            # storm bound: members beyond the cap are counted, not
            # stored — but the blast radius (streams/nodes) and field
            # attribution keep accumulating below (bounded by fleet
            # size), so min_streams decisions and blast_dump_nodes
            # triggers never under-count in a fleet-wide storm
            w.dropped += 1
            self.members_dropped += 1
        w.streams.add(stream)
        w.nodes.add(self.topology.node_of(stream))
        for tf in top_fields or ():
            name = tf.get("name", f"f{tf.get('field', '?')}")
            w.fields[name] = w.fields.get(name, 0) + 1
        self.correlated += 1
        self._obs_correlated.inc()

    def on_tick(self, now_ts: int | None, tick: int = 0,
                sink_offset: int | None = None) -> list[dict]:
        """Advance the correlation clock; close quiesced/over-span
        windows. Returns the incident records emitted this call (the
        soaks assert on them without re-parsing the sink).
        ``sink_offset`` (the writer's current offset, passed by the
        loop) advances the crash-resume sidecar floor once no windows
        remain open."""
        if now_ts is None:
            return []
        now_ts = int(now_ts)
        emitted = []
        with self._lock:
            closed_any = False
            for cluster in sorted(self._open):
                w = self._open[cluster]
                if (now_ts - w.last_ts > self.window_s
                        or now_ts - w.first_ts > self.max_span_s):
                    del self._open[cluster]
                    closed_any = True
                    rec = self._close(cluster, w, tick)
                    if rec is not None:
                        emitted.append(rec)
            if closed_any:
                self._obs_open.set(len(self._open))
                self._update_sidecar(idle_offset=sink_offset)
        return emitted

    def _update_sidecar(self, idle_offset: int | None = None) -> None:
        """Persist the re-fold floor: the min start offset over open
        windows, or ``idle_offset`` (the current sink end) when none are
        open. Atomic tmp+rename; failures are ignored (a stale-small
        floor is safe — it only lengthens the resume scan)."""
        if self.sidecar_path is None:
            return
        starts = [w.start_off for w in self._open.values()
                  if w.start_off is not None]
        if starts:
            floor = min(starts)
        elif not self._open and idle_offset is not None:
            floor = int(idle_offset)
        else:
            return  # unknown floor: keep the last persisted (safe)
        if floor == self._sidecar_written:
            return
        import json
        import os
        try:
            tmp = self.sidecar_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps({"offset": floor}))
            os.replace(tmp, self.sidecar_path)
            self._sidecar_written = floor
        except OSError:
            pass

    def resume_scan_offset(self, cursor_offset: int) -> int:
        """Where the crash-resume re-fold must start: the persisted
        sidecar floor when present (it covers windows open at the
        crash), clamped to the checkpoints' alert cursor. NO sidecar
        means no window ever opened under correlation — the common case
        is arming --topology on a deployment whose sink already carries
        history, and a byte-0 scan there would close each long-past
        burst's window as the scan clock walks by and PAGE a stale
        incident per historical fault (nothing on the stream dedupes
        them: correlation was never armed). Scan from the cursor — the
        post-checkpoint tail is the only span whose alerts can still
        belong to a live window."""
        import json
        try:
            with open(self.sidecar_path) as f:
                off = int(json.load(f).get("offset", 0))
            return max(0, min(off, cursor_offset))
        except (OSError, ValueError, TypeError):
            return max(0, int(cursor_offset))

    def _close(self, cluster: str, w: _Window, tick: int) -> dict | None:
        if len(w.streams) < self.min_streams:
            self.expired += 1
            self._obs_expired.inc()
            return None
        rec = {
            "event": "incident",
            "incident_id": incident_id_of(w.alert_ids),
            "cluster": cluster,
            "members": len(w.alert_ids),
            "alert_ids": sorted(w.alert_ids),
            "streams": sorted(w.streams),
            "nodes": sorted(w.nodes),
            "onset_ts": int(w.first_ts),
            "end_ts": int(w.last_ts),
            "span_s": int(w.last_ts - w.first_ts),
            # attributed field names ranked by how many members named
            # them (count-desc, then name for determinism) — the counts
            # are the ranking, the list stays a plain name list
            "fields": sorted(w.fields, key=lambda n: (-w.fields[n], n)),
            **({"members_dropped": w.dropped} if w.dropped else {}),
        }
        if self._replaying:
            # a close reached during the resume scan may belong to an
            # incident whose event line appears LATER in the file —
            # buffer, and let resume_from settle emission once the
            # already-emitted id set is complete
            self._replay_pending.append(rec)
            return None
        return self._emit(rec, tick)

    def _emit(self, rec: dict, tick: int) -> dict | None:
        iid = rec["incident_id"]
        if iid in self._emitted:
            self.deduped += 1
            self._obs_deduped.inc()
            return None
        self._emitted.add(iid)
        self._emitted_order.append(iid)
        while len(self._emitted_order) > MAX_EMITTED_TRACKED:
            self._emitted.discard(self._emitted_order.popleft())
        self.incidents += 1
        self._obs_incidents.inc()
        self._obs_members.observe(rec["members"])
        self._obs_blast.observe(len(rec["nodes"]))
        self._recent.append(rec)
        if self.sink is not None:
            self.sink(rec)
        if self.flight is not None and \
                len(rec["nodes"]) >= self.blast_dump_nodes:
            # a large-blast incident is a black-box moment: capture the
            # window that produced it, like a quarantine does
            self.flight.request_dump("incident", tick)
        return rec

    # ---- crash/replay resume ----
    def resume_from(self, path: str, offset: int = 0) -> dict:
        """Rebuild correlation state from the alert sink tail (one
        shared tolerant walker — service/alerts.iter_alert_records):
        already-emitted incident ids seed the dedupe set, trailing alert
        lines re-fold into windows, and incidents that closed pre-crash
        without their event line reaching the disk re-emit. Returns a
        small summary for stats/logs."""
        from rtap_tpu_torch.service.alerts import iter_alert_records

        with self._lock:
            return self._resume_from(path, offset, iter_alert_records)

    def _resume_from(self, path, offset, iter_alert_records) -> dict:
        self._replaying = True
        scanned = alerts = 0
        try:
            for kind, rec in iter_alert_records(path, offset):
                scanned += 1
                if kind == "event":
                    if rec.get("event") == "incident" \
                            and rec.get("incident_id"):
                        iid = rec["incident_id"]
                        if iid not in self._emitted:
                            self._emitted.add(iid)
                            self._emitted_order.append(iid)
                        self._recent.append(rec)
                        # the event line marks EXACTLY where live closed
                        # this cluster's window: settle it (its members
                        # are this incident's — deduped above). Without
                        # this, a pipeline-lagged alert whose ts sits
                        # just inside the window band would merge into
                        # the already-closed window on re-fold (the scan
                        # clock only advances at alert timestamps, which
                        # trail the live tick clock) and emit a
                        # divergent-id duplicate.
                        if rec.get("cluster") in self._open:
                            del self._open[rec["cluster"]]
                    continue
                if kind != "alert":
                    continue
                ts = rec.get("ts")
                stream = rec.get("stream")
                if ts is None or stream is None:
                    continue
                alerts += 1
                # drive closure with the stream clock as the scan walks
                # forward — to ts-1, NOT ts: live folds a tick's alerts
                # BEFORE its on_tick, so the last close decision live
                # made before folding this record saw the PREVIOUS
                # second. Advancing to ts here would close a window this
                # record merged into live (a member landing at a gap of
                # exactly window_s+1), re-folding a smaller member set
                # whose content hash diverges from the emitted id.
                self.on_tick(int(ts) - 1)
                # anchor any window this re-fold re-opens at the scan
                # start: its earliest member sits at/after that byte, and
                # a start_off=None window would drop out of the sidecar
                # floor min — a cluster opening LIVE later would then
                # persist a floor past this window's members, and a
                # second crash would re-fold a smaller member set and
                # hash a divergent incident_id (exactly-once violated)
                self.observe_alert(rec.get("alert_id"), stream, int(ts),
                                   top_fields=rec.get("top_fields"),
                                   sink_offset=offset)
        finally:
            self._replaying = False
        re_emitted = 0
        for rec in self._replay_pending:
            if self._emit(rec, 0) is not None:
                re_emitted += 1
        self._replay_pending.clear()
        self._obs_open.set(len(self._open))
        return {"scanned": scanned, "alerts_refolded": alerts,
                "incidents_known": len(self._emitted),
                "re_emitted": re_emitted}

    # ---- exposition ----
    def snapshot(self) -> dict:
        """Point-in-time view for ``GET /incidents`` (same diagnostic
        read contract as /trace and /health; the lock makes a read taken
        mid-fold from the obs HTTP thread safe, not stale-free)."""
        with self._lock:
            return {
                "incidents": list(self._recent),
                "open_windows": {
                    cluster: {
                        "members": len(w.alert_ids),
                        "streams": len(w.streams),
                        "nodes": sorted(w.nodes),
                        "first_ts": int(w.first_ts),
                        "last_ts": int(w.last_ts),
                    }
                    for cluster, w in sorted(self._open.items())
                },
                "window_s": self.window_s,
                "min_streams": self.min_streams,
                "topology": self.topology.stats(),
                **self.stats(),
            }

    def stats(self) -> dict:
        return {
            "incidents_emitted": self.incidents,
            "alerts_correlated": self.correlated,
            "windows_expired": self.expired,
            "resume_deduped": self.deduped,
            "members_dropped": self.members_dropped,
            "open_clusters": len(self._open),
        }
