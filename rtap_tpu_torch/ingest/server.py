"""BinaryBatchSource: the production wire-speed ingest front end.

The port's copy of the JAX package's ``ingest/server.py``. Listener threads
touch numpy buffers only; every torch call stays on the loop's thread. One
change of order: a new connection is registered before its hello MAP is
sent, and every MAP send reads the map under the send lock, so a producer
always ends on the newest map (ROADMAP.md section C).

The live_loop source contract (``source(tick) -> (values [G] f32, ts)``)
fed by the ``RB1`` binary batch protocol instead of per-record JSON:

- **Persistent sockets.** A threaded listener accepts any number of
  producer connections; each connection's bytes run through one
  :class:`~rtap_tpu_torch.ingest.protocol.FrameWalker` (native C scanner when
  the toolchain allows, pure Python otherwise) and every validated DATA
  frame decodes with one ``np.frombuffer`` + one fancy-index scatter
  into the per-(group, slot) dispatch buffer — zero per-record Python.
- **Shared-memory ring** (:mod:`rtap_tpu_torch.ingest.shm`): co-located
  exporters hand the same frames over shm; the ring is drained once per
  tick through the same walker + admission path.
- **Timestamp alignment / backfill** (``backfill_horizon=H`` SECONDS
  of row timestamp): rows are bucketed by their wire timestamp (unix
  seconds) and emission trails the newest observed timestamp by H, so
  a row arriving up to H seconds late lands in the slot its timestamp
  names instead of overwriting the newest value (the JSONL listener's
  clamp). At the standard 1 s cadence a second is a tick. ``H=0``
  (default) keeps the JSONL source's exact latest-wins/drain
  semantics — the live_loop equivalence test pins bit-identical alert
  streams on that mode.
- **Admission control.** Per-tenant row quotas per tick
  (``quota_rows``; a frame's tenant header names the payer), drop-
  oldest backpressure on the backfill buckets, and ``rtap_obs_ingest_*``
  counters/gauges riding the normal snapshot path (docs/TELEMETRY.md).

Membership follows the registry's SLOT MAP (``set_slot_map`` — the
(shard, group, slot) addressing), and the auto-register
protocol is shared with the JSONL listener: producers announce unknown
stream ids in NAMES frames, ``drain_unknown`` feeds serve
--auto-register, and connecting producers receive the current id->code
MAP frame (re-requestable with an empty MAP frame).

The write-ahead journal integration (``take_tick_frames``): the raw
DATA frames that composed a tick's emission are handed to the journal
verbatim (cheaper write-ahead than re-encoding the full-width vector);
ticks whose emission is NOT a pure frame replay (backfill merges,
quota-truncated frames) synthesize one compact frame from the emitted
vector instead, so journal replay is bit-identical either way.
"""

from __future__ import annotations

import json
import socket as socket_module
import socketserver
import threading
import time

import numpy as np

from rtap_tpu_torch.ingest.dispatch import DispatchTable
from rtap_tpu_torch.ingest.protocol import (
    KIND_MAP,
    KIND_NAMES,
    FrameWalker,
    build_frame,
    data_frame,
)
from rtap_tpu_torch.obs import get_registry


class BinaryBatchSource:
    """See module docstring. Construct with the registry's slot map
    (``StreamGroupRegistry.slot_map()``), then ``start()`` / ``close()``
    (or use as a context manager)."""

    #: bound on remembered unknown-id NAMES (same threat model as
    #: TcpJsonlSource.MAX_UNKNOWN_TRACKED)
    MAX_UNKNOWN_TRACKED = 4096
    #: distinct tenants tracked per quota window; overflow tenants share
    #: one fold-over bucket (an id-spraying producer must not grow host
    #: memory through tenant labels either)
    TENANT_TRACK_CAP = 1024
    #: raw frames retained per tick for the journal; a tick exceeding
    #: this synthesizes one compact frame instead (bounded memory)
    MAX_TICK_FRAME_ROWS = 1 << 20

    def __init__(self, slot_map: dict, host: str = "127.0.0.1",
                 port: int | None = 0, shm=None, shm_bytes: int = 8 << 20,
                 quota_rows: int = 0, backfill_horizon: int = 0,
                 track_unknown: bool = False, native: bool | None = None,
                 max_pending_buckets: int | None = None):
        if quota_rows < 0:
            raise ValueError(f"quota_rows must be >= 0; got {quota_rows}")
        if backfill_horizon < 0:
            raise ValueError(
                f"backfill_horizon must be >= 0; got {backfill_horizon}")
        self._table = DispatchTable(slot_map)
        self._lock = threading.Lock()
        self._native = native
        self.quota_rows = int(quota_rows)
        self.horizon = int(backfill_horizon)  # seconds of row timestamp
        self.max_pending = int(max_pending_buckets) if max_pending_buckets \
            else max(2 * self.horizon + 8, 16)
        self._track_unknown = bool(track_unknown)
        self._unknown_seen: set[str] = set()
        # hot-path state (all guarded by _lock)
        self._latest = np.full(self._table.n, np.nan, np.float32)
        self._latest_ts = 0
        self._max_row_ts = 0
        self._emit_floor = None  # newest bucket ts already emitted (H>0)
        self._buckets: dict[int, list] = {}  # ts -> [vec f32, n_rows]
        self._tenant_used: dict[str, int] = {}
        self._tick_frames: list[bytes] = []
        self._tick_frame_rows = 0
        self._tick_pure = True  # emission == replay of _tick_frames
        self._last_tick_frames = None
        # detection-latency stage surfaces (obs/latency.py):
        # the latest DATA frame's wire-transit lag (arrival wall clock
        # minus its freshest row ts) and, in backfill mode, the hold the
        # horizon imposed on the last emitted tick. The LatencyTracker
        # getattr-probes once per tick WITHOUT the lock, so the
        # (wall, ts) pair lives in ONE tuple rebound atomically — two
        # separate attributes could tear between a handler's write and
        # the loop's read and report a lag computed from mismatched
        # halves.
        self._arrival: tuple[float, int] | None = None  # (wall, row ts)
        self._release_hold: float | None = None
        # map epoch 1..65535 (0 is reserved for epoch-unaware
        # producers): bumped on every membership change so a producer
        # still sending with a cached map goes loudly deaf instead of
        # feeding a re-claimed slot's NEW stream (docs/INGEST.md)
        self._map_epoch = 1
        #: failover redirect: when this serve loses leadership
        #: the MAP gains "__leader__": "host:port" naming who producers
        #: should reconnect to (announce_leader); None = we are it
        self._leader_addr: str | None = None
        self._map_blob = self._render_map()
        # accounting (ints, mirrored into the registry instruments below)
        self.rows_applied = 0
        self.frames_applied = 0
        self.rows_unknown = 0
        self.rows_stale_epoch = 0
        self.rows_quota_dropped = 0
        self.rows_late_dropped = 0
        self.rows_backfilled = 0
        self.rows_backpressure_dropped = 0
        obs = get_registry()
        # rows share the JSONL listener's record counter on purpose:
        # "successfully ingested records" must mean the same thing
        # across transports (satellite: and across parser backends)
        self._obs_rows = obs.counter(
            "rtap_obs_ingest_records_total",
            "successfully parsed ingest records (JSONL records and "
            "binary batch rows, both parser backends)")
        self._obs_frames = obs.counter(
            "rtap_obs_ingest_frames_total",
            "validated RB1 frames applied (DATA/NAMES/MAP)")
        self._obs_bad_frames = obs.counter(
            "rtap_obs_ingest_bad_frames_total",
            "RB1 frames rejected by the walker (CRC mismatch)")
        self._obs_garbage = obs.counter(
            "rtap_obs_ingest_garbage_bytes_total",
            "stream bytes skipped while resyncing to the next frame "
            "magic (torn producers, line noise)")
        self._obs_version_skew = obs.counter(
            "rtap_obs_ingest_version_skew_total",
            "well-framed RB1 frames skipped for an unknown protocol "
            "version or frame kind (forward compatibility, counted)")
        self._obs_unknown = obs.counter(
            "rtap_obs_ingest_unknown_ids_total",
            "records for unregistered stream ids (claim candidates under "
            "--auto-register, otherwise dropped)")
        self._obs_stale = obs.counter(
            "rtap_obs_ingest_stale_epoch_total",
            "rows dropped whole-frame because the producer's map epoch "
            "predates a membership change (slot codes may have been "
            "re-claimed by different streams — refuse, never misroute)")
        self._obs_quota = obs.counter(
            "rtap_obs_ingest_quota_dropped_total",
            "rows dropped by per-tenant admission quotas "
            "(--ingest-quota rows/tenant/tick)")
        self._obs_late = obs.counter(
            "rtap_obs_ingest_late_dropped_total",
            "rows older than the backfill horizon (their tick slot was "
            "already emitted) — dropped, never mis-clocked")
        self._obs_backfilled = obs.counter(
            "rtap_obs_ingest_backfilled_rows_total",
            "late rows the backfill horizon landed in their correct "
            "(earlier) tick slot")
        self._obs_backpressure = obs.counter(
            "rtap_obs_ingest_backpressure_dropped_total",
            "rows dropped by drop-oldest backpressure (pending backfill "
            "buckets exceeded the bound)")
        self._obs_buffered = obs.gauge(
            "rtap_obs_ingest_buffered_rows",
            "rows currently buffered in backfill buckets awaiting their "
            "emission tick")
        self._obs_tenants = obs.gauge(
            "rtap_obs_ingest_tenants",
            "distinct tenants seen in the current quota window")
        # a probe walker decides native availability once (and loudly if
        # native=True); per-connection walkers inherit the choice
        self._walker_native = FrameWalker(native=native).native_active \
            if native is not False else None
        if self._walker_native is None:
            self._walker_native = False
        self._walkers: list[FrameWalker] = []  # live conns, for counter sums
        # shm + feed_frames path (NOT in _walkers: summed separately)
        self._local_walker = FrameWalker(native=bool(self._walker_native))
        # shared-memory ring (created here; co-located exporters attach)
        self._ring = None
        if shm is not None:
            from rtap_tpu_torch.ingest.shm import ShmRing

            self._ring = shm if isinstance(shm, ShmRing) \
                else ShmRing.create(shm, shm_bytes)
        # TCP listener (port=None: shm/local-only source, no socket)
        self._server = None
        self._thread = None
        self.address = None
        self._conns: set = set()  # live producer sockets, for MAP pushes
        # serializes ALL server->client control writes (handler map
        # replies vs membership pushes share sockets across threads; an
        # interleaved sendall would tear frames on the wire)
        self._send_lock = threading.Lock()
        #: live handler threads, for the deterministic close() join —
        #: socketserver's own daemon_threads bookkeeping does not track
        #: daemon handlers, and a handler blocked in recv() would
        #: otherwise outlive close() nondeterministically (the conftest
        #: no-leaked-thread fixture's flake mode under repeated
        #: open/close in tests)
        self._handler_threads: set = set()
        self._closing = False  # close() raises it BEFORE joining: even a
        # handler that connected in the shutdown race (registered after
        # the join snapshot, socket never woken) exits within one recv
        # timeout instead of blocking forever
        if port is not None:
            outer = self

            class Handler(socketserver.BaseRequestHandler):
                def handle(self):
                    with outer._lock:
                        outer._handler_threads.add(threading.current_thread())
                    walker = None
                    # ONE finally owns the bookkeeping for every exit
                    # path, including a hello that fails before the
                    # loop (a connect-then-die producer must not leak
                    # its thread entry forever)
                    try:
                        # register BEFORE the hello: a membership push or an
                        # announce_leader from now on reaches this socket,
                        # and _send_map reads the map under the send lock,
                        # so the producer always ends on the newest MAP (the
                        # JAX listener sends first and registers after, and
                        # loses an announce landing in between)
                        with outer._lock:
                            outer._conns.add(self.request)
                        # hello: the current id -> slot-code map, so the
                        # producer can encode without out-of-band config
                        try:
                            outer._send_map(self.request)
                        except OSError:
                            return
                        walker = outer._new_walker()
                        self.request.settimeout(0.5)
                        while True:
                            try:
                                data = self.request.recv(1 << 20)
                            except socket_module.timeout:
                                if outer._closing:
                                    break
                                continue  # idle producer: keep waiting
                            if not data:
                                break
                            frames = walker.feed(data)
                            # MAP re-requests answer OUTSIDE the hot
                            # lock (a slow client's send must not stall
                            # every producer's apply)
                            for fr in frames:
                                if fr.kind == KIND_MAP and fr.count == 0:
                                    outer._send_map(self.request)
                            with outer._lock:
                                for fr in frames:
                                    outer._apply(fr)
                    except OSError:
                        # connection death is a producer's normal end;
                        # the finally below books the disconnect
                        pass
                    finally:
                        with outer._lock:
                            outer._conns.discard(self.request)
                            outer._handler_threads.discard(
                                threading.current_thread())
                        if walker is not None:
                            outer._drop_walker(walker)

            class Server(socketserver.ThreadingTCPServer):
                allow_reuse_address = True
                daemon_threads = True

            self._server = Server((host, port), Handler)
            self.address = self._server.server_address
            # a 0.05 s poll: close() returns within it, not the default 0.5 s
            self._thread = threading.Thread(
                target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
                name="rtap-ingest-accept", daemon=True)

    # ---- lifecycle ---------------------------------------------------
    def start(self) -> "BinaryBatchSource":
        if self._thread is not None:
            self._thread.start()
        return self

    def close(self) -> None:
        """Deterministic shutdown: stop accepting, WAKE every handler
        (socket shutdown makes its blocking recv return b"" — the
        wakeup), then join the accept thread and every handler thread
        with a bounded wait. Repeated open/close in one process (the
        test suite's pattern) leaves no thread behind to trip the
        conftest no-leaked-thread fixture; threads stay daemonized so a
        truly wedged one still cannot hang interpreter exit."""
        if self._server is not None:
            self._closing = True
            if self._thread is not None and self._thread.is_alive():
                self._server.shutdown()  # unblocks serve_forever
            with self._lock:
                conns = list(self._conns)
                handlers = list(self._handler_threads)
            for sock in conns:
                try:
                    sock.shutdown(socket_module.SHUT_RDWR)
                except OSError:
                    pass
            if self._thread is not None and self._thread.is_alive():
                self._thread.join(timeout=5.0)
            for t in handlers:
                t.join(timeout=5.0)
            self._server.server_close()
        if self._ring is not None:
            self._ring.close()

    def __enter__(self) -> "BinaryBatchSource":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def ring_name(self) -> str | None:
        return self._ring.name if self._ring is not None else None

    # ---- walker bookkeeping ------------------------------------------
    def _new_walker(self) -> FrameWalker:
        # the probe in __init__ already decided (and failed loudly for
        # native=True); per-connection walkers just follow it
        w = FrameWalker(native=bool(self._walker_native))
        with self._lock:
            self._walkers.append(w)
        return w

    def _drop_walker(self, w: FrameWalker) -> None:
        with self._lock:
            # fold the dead connection's walker tallies into durable sums
            self._dead_garbage = getattr(self, "_dead_garbage", 0) \
                + w.garbage_bytes
            self._dead_bad_crc = getattr(self, "_dead_bad_crc", 0) + w.bad_crc
            self._dead_skew = getattr(self, "_dead_skew", 0) + w.version_skew
            try:
                self._walkers.remove(w)
            except ValueError:
                # a double-drop in the close() race; tallies above
                # already folded once
                pass

    def _walker_sum(self, attr: str, dead: str) -> int:
        return getattr(self, dead, 0) + sum(
            getattr(w, attr) for w in self._walkers)

    # ---- membership (the registry slot-map protocol) -----------------
    def _render_map(self) -> bytes:
        return json.dumps({"__epoch__": self._map_epoch,
                           **({"__leader__": self._leader_addr}
                              if self._leader_addr else {}),
                           **self._table.code_of},
                          separators=(",", ":")).encode("utf-8")

    def announce_leader(self, addr: str) -> None:
        """Failover re-point: a FENCED old leader pushes a MAP
        naming the new leader's ingest address and bumping the epoch, so
        every connected RB1 producer both goes loudly deaf here (stale
        epoch) and learns where to reconnect
        (BinaryFeedConnection.leader_hint; send_binary follows the
        redirect). Best-effort: producers whose connection already died
        learn the same thing from their reconnect failing."""
        with self._lock:
            self._leader_addr = str(addr)
            self._map_epoch = self._map_epoch % 0xFFFF + 1
            self._map_blob = self._render_map()
        self._push_map()

    def _push_map(self) -> None:
        """Send the current map to every connected producer (best-effort —
        a dead socket's handler cleans up). The map and the sockets are read
        under the send lock, so of two concurrent pushes the later send
        carries the newer map."""
        with self._send_lock:
            with self._lock:
                conns = list(self._conns)
                frame = build_frame(KIND_MAP, self._map_blob)
            for sock in conns:
                try:
                    sock.sendall(frame)
                except OSError:
                    pass

    def _send_map(self, sock) -> None:
        # the map is read under the send lock: a push that renders a newer
        # map after this read sends after this send, never before it
        with self._send_lock:
            with self._lock:
                blob = self._map_blob
            sock.sendall(build_frame(KIND_MAP, blob))

    def set_slot_map(self, slot_map: dict) -> None:
        """Adopt the registry's new slot map (membership changed).

        Latest values and pending buckets carry over BY ID — a retained
        stream must not lose the sample that arrived this tick; new ids
        start NaN. New connections (and MAP re-requests) see the new
        map immediately; rows addressed at released slots start
        counting as unknown."""
        table = DispatchTable(slot_map)
        with self._lock:
            old = self._table
            remap = np.full(table.n, -1, np.int64)
            old_pos = {sid: i for i, sid in enumerate(old.ids)}
            for j, sid in enumerate(table.ids):
                i = old_pos.get(sid)
                if i is not None:
                    remap[j] = i

            def carry(vec):
                out = np.full(table.n, np.nan, np.float32)
                m = remap >= 0
                out[m] = vec[remap[m]]
                return out

            self._latest = carry(self._latest)
            for ts in list(self._buckets):
                vec, nrows = self._buckets[ts]
                self._buckets[ts] = [carry(vec), nrows]
            self._table = table
            # bump the epoch (1..65535, skipping the epoch-unaware 0):
            # frames stamped with the old epoch are stale from here on
            self._map_epoch = self._map_epoch % 0xFFFF + 1
            self._map_blob = self._render_map()
            # a membership change invalidates raw-frame journaling for
            # the in-progress tick (old codes): synthesize at snapshot
            self._tick_pure = False
        # PUSH the fresh map to every connected producer (outside the
        # hot lock; best-effort — a dead socket's handler cleans up):
        # without this, a producer whose NAMES were not the trigger
        # (e.g. an auto-release elsewhere in the fleet) would keep
        # stamping the old epoch and go deaf until it happened to
        # re-request. Producers drain pushes via
        # BinaryFeedConnection.poll_map() before sending.
        self._push_map()

    def drain_unknown(self) -> list[str]:
        """Pop unknown-id names announced in NAMES frames since the last
        drain (sorted; empty unless track_unknown)."""
        if not self._track_unknown:
            return []
        with self._lock:
            seen = sorted(self._unknown_seen)
            self._unknown_seen.clear()
        return seen

    # ---- frame application (lock held) -------------------------------
    def _apply(self, fr) -> None:
        # (DATA frames count below, AFTER the stale-epoch gate — a
        # refused frame must not read as "applied" in the triage pair
        # frames-applied vs rows-applied)
        if fr.kind == KIND_NAMES:
            self.frames_applied += 1
            self._obs_frames.inc()
            if self._track_unknown:
                for name in bytes(fr.payload).decode(
                        "utf-8", "ignore").split("\n"):
                    if name and len(self._unknown_seen) \
                            < self.MAX_UNKNOWN_TRACKED:
                        self._unknown_seen.add(name)
            return
        if fr.kind == KIND_MAP:
            self.frames_applied += 1
            self._obs_frames.inc()
            return  # map requests are answered by the handler thread
        # ---- DATA ----
        rows = fr.rows()
        n = len(rows)
        if n == 0:
            self.frames_applied += 1
            self._obs_frames.inc()
            return
        if fr.epoch and fr.epoch != self._map_epoch:
            # the producer's map predates a membership change: its slot
            # codes may now address DIFFERENT streams (released +
            # re-claimed). Refuse the whole frame, loudly — misrouting
            # a stranger's model is the one failure worse than deafness
            self.rows_stale_epoch += n
            self._obs_stale.inc(n)
            return
        self.frames_applied += 1
        self._obs_frames.inc()
        kept = n
        if self.quota_rows:
            tenant = fr.tenant
            if tenant not in self._tenant_used \
                    and len(self._tenant_used) >= self.TENANT_TRACK_CAP:
                tenant = "__other__"
            used = self._tenant_used.get(tenant, 0)
            kept = max(0, min(n, self.quota_rows - used))
            self._tenant_used[tenant] = used + kept
            if kept < n:
                self.rows_quota_dropped += n - kept
                self._obs_quota.inc(n - kept)
                self._tick_pure = False  # raw frame != admitted rows
                if kept == 0:
                    return
                rows = rows[:kept]
        # the packed rows' fields are 10-byte-strided, misaligned views:
        # copied once into aligned arrays, every pass below runs several
        # times faster (the port's addition; the same values)
        slots = rows["slot"].copy()
        dt = rows["dt"].copy()
        pos = self._table.lookup(slots)
        valid = pos >= 0
        applied = int(np.count_nonzero(valid))
        n_unknown = len(rows) - applied
        if n_unknown:
            self.rows_unknown += n_unknown
            self._obs_unknown.inc(n_unknown)
        # the backfill comparison point is the clock BEFORE this frame:
        # a frame's own timestamp spread must not count as late rows
        prev_max = self._max_row_ts
        # the newest row ts, base_ts + the largest delta
        ts_max = fr.base_ts + int(dt.max())
        self._max_row_ts = max(self._max_row_ts, ts_max)
        # stage surface: when THIS frame's freshest row arrived, in wall
        # time (one clock read per frame, not per row); one tuple rebind —
        # the unlocked reader sees a coherent pair
        self._arrival = (time.time(), ts_max)
        if applied:
            values = rows["value"].copy()
            if self.horizon == 0:
                # latest-wins in arrival order (numpy fancy-assign keeps
                # the last duplicate) — the JSONL listener's semantics;
                # a frame of known rows only (the common case) skips the
                # boolean masks
                if n_unknown:
                    self._latest[pos[valid]] = values[valid]
                    ts_max = fr.base_ts + int(dt[valid].max())
                else:
                    self._latest[pos] = values
                self._latest_ts = max(self._latest_ts, ts_max)
            else:
                # only rows that actually LANDED in a bucket count as
                # ingested (late drops are drops, not successes; rows a
                # later backpressure eviction removes were genuinely
                # accepted and ride the backpressure counter instead)
                ts_rows = fr.base_ts + dt.astype(np.int64)
                applied = self._bucket_rows(pos[valid], values[valid], ts_rows[valid], prev_max)
            self.rows_applied += applied
            self._obs_rows.inc(applied)
        # journal capture: the raw frame reproduces this application
        # exactly iff nothing was truncated (unknown rows are dropped
        # identically at replay, so they don't break purity)
        if self.horizon == 0 and self._tick_pure:
            if self._tick_frame_rows + n <= self.MAX_TICK_FRAME_ROWS:
                self._tick_frames.append(fr.raw)
                self._tick_frame_rows += n
            else:
                self._tick_pure = False

    def _bucket_rows(self, pos, values, ts_rows, prev_max: int) -> int:
        """Scatter rows into their per-timestamp buckets -> rows landed."""
        floor = self._emit_floor
        if floor is not None:
            late = ts_rows <= floor
            n_late = int(late.sum())
            if n_late:
                # beyond the horizon: that tick slot was already emitted
                self.rows_late_dropped += n_late
                self._obs_late.inc(n_late)
                keep = ~late
                pos, values, ts_rows = pos[keep], values[keep], ts_rows[keep]
                if not len(pos):
                    return 0
        # late relative to data seen BEFORE this frame (an on-time
        # frame whose rows span several seconds is not backfill)
        backfilled = int((ts_rows < prev_max).sum())
        if backfilled:
            self.rows_backfilled += backfilled
            self._obs_backfilled.inc(backfilled)
        for ts in np.unique(ts_rows):
            m = ts_rows == ts
            b = self._buckets.get(int(ts))
            if b is None:
                b = self._buckets[int(ts)] = [
                    np.full(self._table.n, np.nan, np.float32), 0]
            b[0][pos[m]] = values[m]
            b[1] += int(m.sum())
        # drop-oldest backpressure: pending buckets are bounded; the
        # freshest data wins (a stalled consumer must not grow host
        # memory, and real-time serving prefers now over then)
        while len(self._buckets) > self.max_pending:
            oldest = min(self._buckets)
            _vec, nrows = self._buckets.pop(oldest)
            self.rows_backpressure_dropped += nrows
            self._obs_backpressure.inc(nrows)
            self._emit_floor = max(self._emit_floor or 0, oldest)
        return len(pos)

    # ---- local/shm ingestion -----------------------------------------
    def feed_frames(self, blobs) -> None:
        """Apply raw frame bytes in-process (co-located producers and
        the deterministic soak feeders; same validation/admission path
        as the socket)."""
        for blob in blobs:
            frames = self._local_walker.feed(blob)
            with self._lock:
                for fr in frames:
                    self._apply(fr)

    def _drain_ring(self) -> None:
        if self._ring is None:
            return
        while True:
            data = self._ring.drain()
            if not data:
                return
            frames = self._local_walker.feed(data)
            with self._lock:
                for fr in frames:
                    self._apply(fr)

    # ---- the live_loop source contract -------------------------------
    def __call__(self, tick: int):
        """Snapshot AND DRAIN (horizon 0) or emit the due backfill
        bucket(s) (horizon H): see module docstring."""
        self._drain_ring()
        with self._lock:
            if self.horizon == 0:
                values = self._latest.copy()
                self._latest[:] = np.nan
                ts = self._latest_ts or int(time.time())
                if self._tick_pure and self._tick_frames:
                    self._last_tick_frames = self._tick_frames
                else:
                    # synthesis is LAZY (take_tick_frames): a serve
                    # without a journal must not pay a pack + crc pass
                    # per tick for frames nothing will ever read
                    self._last_tick_frames = ("synth", values, ts)
            else:
                values, ts = self._emit_due()
                self._last_tick_frames = ("synth", values, ts)
            self._tick_frames = []
            self._tick_frame_rows = 0
            self._tick_pure = True
            self._obs_tenants.set(len(self._tenant_used))
            self._tenant_used.clear()
            self._obs_buffered.set(
                sum(b[1] for b in self._buckets.values()))
        self.sync_obs()
        return values, ts

    def _emit_due(self):
        """Merge + pop every bucket at/below the watermark (newest row
        ts minus the horizon); ascending ts, newer wins per stream."""
        watermark = self._max_row_ts - self.horizon
        due = sorted(t for t in self._buckets if t <= watermark)
        if not due:
            ts = self._emit_floor or self._latest_ts or int(time.time())
            return np.full(self._table.n, np.nan, np.float32), ts
        merged = np.full(self._table.n, np.nan, np.float32)
        for t in due:
            vec, _n = self._buckets.pop(t)
            # presence = not-NaN, NOT isfinite: a producer may push inf
            # (legal f32) and it must survive to scoring and replay
            m = ~np.isnan(vec)
            merged[m] = vec[m]
        self._emit_floor = due[-1]
        self._latest_ts = max(self._latest_ts, due[-1])
        # stage surface: the hold the horizon imposed on this emission
        # (newest data seen minus the tick just released, ~= horizon)
        self._release_hold = float(max(0, self._max_row_ts - due[-1]))
        return merged, due[-1]

    def _synth_frames(self, values, ts) -> list[bytes]:
        """One compact DATA frame reproducing an emitted vector exactly
        (used when raw passthrough would not: backfill merges, quota
        truncation, membership changes, overflow)."""
        # not-NaN, NOT isfinite: an emitted inf must replay as inf or
        # the journal's bit-exactness contract breaks on that tick
        m = ~np.isnan(values)
        if not m.any():
            return []
        return [data_frame(self._table.codes[m], values[m], int(ts))]

    def take_tick_frames(self) -> list[bytes]:
        """The raw DATA frames whose replay reproduces the LAST emitted
        tick bit-identically — the journal's cheap write-ahead payload
        (service/loop.py calls this right after the source poll).
        Ticks whose emission was not a pure frame replay synthesize one
        compact frame here, lazily — only journal users pay for it."""
        out = self._last_tick_frames
        self._last_tick_frames = None
        if isinstance(out, tuple):
            _tag, values, ts = out
            return self._synth_frames(values, ts)
        return out or []

    # ---- detection-latency stage surfaces (obs/latency.py probes) ----
    @property
    def last_arrival_lag_s(self) -> float | None:
        """Wire-transit lag of the freshest DATA frame (arrival wall
        clock minus its newest row's source ts, clamped >= 0); None
        before any data arrived. Lock-free: the (wall, ts) pair is one
        atomically-rebound tuple, so a concurrent handler write can at
        worst make this one frame stale, never mismatched."""
        pair = self._arrival
        if pair is None:
            return None
        wall, ts = pair
        return max(0.0, wall - ts)

    @property
    def last_release_hold_s(self) -> float | None:
        """Backfill hold of the last emitted tick (newest row ts seen
        minus the released tick's ts); None in latest-wins mode."""
        return self._release_hold

    # ---- health surface (serve stats line parity with TcpJsonlSource)
    @property
    def records_parsed(self) -> int:
        return self.rows_applied

    @property
    def parse_errors(self) -> int:
        with self._lock:
            bad = self._walker_sum("bad_crc", "_dead_bad_crc") \
                + self._local_walker.bad_crc
            skew = self._walker_sum("version_skew", "_dead_skew") \
                + self._local_walker.version_skew
        # mirrored into the registry lazily (walker tallies live on the
        # per-connection objects; this property is the per-tick surface)
        return bad + skew

    @property
    def garbage_bytes(self) -> int:
        with self._lock:
            return self._walker_sum("garbage_bytes", "_dead_garbage") \
                + self._local_walker.garbage_bytes

    @property
    def unknown_ids(self) -> int:
        return self.rows_unknown

    @property
    def native_active(self) -> bool:
        return bool(self._walker_native)

    def sync_obs(self) -> None:
        """Once-per-tick delta sync of walker-level tallies (bad CRC,
        version skew, garbage bytes) into the registry counters — the
        walkers tally on per-connection objects for hot-path cheapness,
        like the JSONL listener's C counters."""
        synced = getattr(self, "_obs_synced",
                         {"bad": 0, "skew": 0, "garbage": 0})
        with self._lock:
            bad = self._walker_sum("bad_crc", "_dead_bad_crc") \
                + self._local_walker.bad_crc
            skew = self._walker_sum("version_skew", "_dead_skew") \
                + self._local_walker.version_skew
            garbage = self._walker_sum("garbage_bytes", "_dead_garbage") \
                + self._local_walker.garbage_bytes
        self._obs_bad_frames.inc(max(0, bad - synced["bad"]))
        self._obs_version_skew.inc(max(0, skew - synced["skew"]))
        self._obs_garbage.inc(max(0, garbage - synced["garbage"]))
        self._obs_synced = {"bad": bad, "skew": skew, "garbage": garbage}
