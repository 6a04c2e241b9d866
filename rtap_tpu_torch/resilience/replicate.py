"""Hot-standby replication and the fenced leadership lease.

The port of the JAX package's ``resilience/replicate.py``, with the same
wire bytes, lease file and failover semantics. The journal made a serve
process resumable on the same host; this module makes the fleet survive
losing the PROCESS with warm state: the leader's
:class:`~rtap_tpu_torch.resilience.journal.TickJournal` appends are teed —
the exact framed ``RJ`` record bytes — over a persistent socket to a
standby process that applies every shipped tick through the normal
journal-replay scoring path (``StreamGroup.dispatch_chunk`` /
``collect_chunk`` in m = 1 chunks, so on the card one TM learning-kernel
launch per group per applied learning tick): its model state is
bit-identical to the leader's by construction, and takeover is a lease
flip, not a cold replay.

Roles (``serve --replicate-to HOST:PORT`` / ``serve --standby
--replicate-listen PORT``, sharing the alert sink and checkpoint dir):

- **Leader**: journal appends tee into a bounded drop-oldest send buffer
  drained by a sender thread — a slow or dead standby never stalls the
  tick (``rtap_obs_repl_*`` counters size the lag). Compaction is clamped
  to the standby's acked position while one is connected; a reconnecting
  standby whose position was compacted away gets ``SNAP`` and reloads the
  shared checkpoint dir, then re-requests the stream from there.
- **Standby**: applies TICK/FRAME records in order (mirroring them into
  its own journal first), acks its position, tracks the leader's
  alert-delivery CURSOR records and emits nothing while following: the
  alert lines it would have written are buffered per tick and pruned as
  cursors confirm delivery.

Failover: the lease file (JSON ``{epoch, owner, ts, ...}``) is refreshed by
the leader's heartbeat thread. The standby promotes when it goes stale: it
bumps the monotonic fencing epoch, splices the alert stream exactly-once
(scan the sink past the last cursor into a suppression set, flush only the
buffered lines the dead leader never delivered), checkpoints its warm
fleet at the takeover tick and serves live. A paused old leader that wakes
up finds the epoch advanced and is FENCED: its loop breaks
(``leader_fenced``), the AlertWriter's fence refuses every further sink
write, serve exits :data:`FENCED_RC`, and its binary source pushes a MAP
naming the new leader.

Wire format: the journal's own ``RJ`` framing (``RJ | type u8 | len u32 |
payload | crc32``), CRC-checked and torn-tail tolerant on both sides;
control records (HELLO/ACK/SNAP) use type codes that never land in a
journal file. A corrupt record is skipped by CRC, surfaces as a tick gap,
and the standby re-requests the stream from its position (the leader
re-reads its journal from disk).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from collections import deque
from pathlib import Path

import numpy as np

from rtap_tpu_torch.obs import get_registry
from rtap_tpu_torch.resilience.journal import (
    _CRC,
    _CURSOR,
    _FRAME,
    _HEADER,
    _MAGIC,
    _MAX_PAYLOAD,
    _TICK,
    JournaledFrames,
    TickJournal,
    first_journal_tick,
    iter_raw_records,
)

__all__ = ["FENCED_RC", "FencingLease", "Lease", "ReplicationSender",
           "StandbyFollower", "WIRE_HELLO", "WIRE_ACK", "WIRE_SNAP",
           "WireWalker", "pack_wire"]

#: serve's exit code when a leader discovers a promoted standby fenced it
#: out (distinct from crashes, budget exhaustion and the chaos proc_exit)
FENCED_RC = 7

#: wire-only record types (never written to a journal file; the journal
#: types 1..3 pass through verbatim)
WIRE_HELLO = 16  # standby -> leader: payload <q> = first tick I need
WIRE_ACK = 17    # standby -> leader: payload <q> = tick applied+journaled
WIRE_SNAP = 18   # leader -> standby: payload <q> = checkpoint tick to fetch
# from the SHARED checkpoint dir (the journal can no longer backfill your
# position); re-HELLO after loading
_WIRE_TYPES = (_TICK, _CURSOR, _FRAME, WIRE_HELLO, WIRE_ACK, WIRE_SNAP)
_Q = struct.Struct("<q")


def pack_wire(typ: int, payload: bytes) -> bytes:
    """Frame a control record in the journal's RJ framing."""
    head = _HEADER.pack(_MAGIC, typ, len(payload))
    return head + payload + _CRC.pack(zlib.crc32(head[2:] + payload))


class WireWalker:
    """Incremental RJ-record stream walker (the replication socket's
    consumer): feed() recv chunks, get ``(typ, payload)`` records out. Torn
    tails wait for more bytes; bad magic/type/CRC resyncs to the next magic
    (counted — the chaos ``corrupt_bytes`` fault lands here and surfaces as
    a tick gap upstream, never as corruption)."""

    def __init__(self):
        self._buf = bytearray()
        self.records = 0
        self.garbage_bytes = 0
        self.bad_crc = 0

    def _resync(self, buf: bytes, off: int) -> int:
        nxt = buf.find(_MAGIC, off + 1)
        skip_to = nxt if nxt != -1 else max(off + 1, len(buf) - 1)
        self.garbage_bytes += skip_to - off
        return skip_to

    def feed(self, data: bytes) -> list[tuple[int, bytes]]:
        self._buf += data
        buf = bytes(self._buf)
        n = len(buf)
        out: list[tuple[int, bytes]] = []
        off = 0
        while off + _HEADER.size + _CRC.size <= n:
            magic, typ, ln = _HEADER.unpack_from(buf, off)
            if magic != _MAGIC or typ not in _WIRE_TYPES or ln > _MAX_PAYLOAD:
                off = self._resync(buf, off)
                continue
            end = off + _HEADER.size + ln + _CRC.size
            if end > n:
                break  # torn tail: wait for more bytes
            payload = buf[off + _HEADER.size:end - _CRC.size]
            (crc,) = _CRC.unpack_from(buf, end - _CRC.size)
            if crc != zlib.crc32(buf[off + 2:off + _HEADER.size] + payload):
                self.bad_crc += 1
                off = self._resync(buf, off)
                continue
            out.append((typ, payload))
            off = end
        del self._buf[:off]
        self.records += len(out)
        return out


# ---------------------------------------------------------------- lease
class FencingLease:
    """The fencing-epoch state machine every lease backend shares: the
    sticky ``fenced`` flag, the loss/staleness predicates, the cached
    :meth:`still_mine` probe, the heartbeat thread and the meta-rebinding
    discipline. A backend (the file :class:`Lease` below; a control-plane
    lease later) implements :meth:`read`, :meth:`try_acquire` and
    :meth:`refresh`."""

    def __init__(self, owner: str, timeout_s: float = 5.0, meta: dict | None = None):
        if timeout_s <= 0:
            raise ValueError(f"lease timeout_s must be > 0; got {timeout_s}")
        self.owner = str(owner)
        self.timeout_s = float(timeout_s)
        self.meta = dict(meta or {})
        self.epoch = 0
        self.fenced = False
        self.refreshes = 0
        # still_mine() runs per alert batch: at most one backend read per
        # min(0.2, timeout/4) seconds
        self._probe_interval = min(0.2, self.timeout_s / 4.0)
        self._last_probe = 0.0
        self._lock = threading.Lock()
        self._hb_stop: threading.Event | None = None
        self._hb_thread: threading.Thread | None = None

    # ---- backend surface ---------------------------------------------
    def read(self) -> dict | None:
        """Current lease entry (``{epoch, owner, ts, ...}``) or None."""
        raise NotImplementedError

    def try_acquire(self) -> bool:
        raise NotImplementedError

    def refresh(self) -> bool:
        raise NotImplementedError

    # ---- shared fencing logic ----------------------------------------
    def _stale(self, cur: dict) -> bool:
        return time.time() - float(cur.get("ts", 0)) > self.timeout_s

    def is_stale(self) -> bool:
        """True when nobody is refreshing the lease (the standby's
        promotion trigger)."""
        cur = self.read()
        return cur is None or self._stale(cur)

    def _lost(self, cur: dict | None) -> bool:
        if cur is None:
            return False  # unreadable/missing: not evidence of a taker
        if int(cur.get("epoch", 0)) > self.epoch:
            return True
        return int(cur.get("epoch", 0)) == self.epoch and cur.get("owner") != self.owner

    def start_heartbeat(self) -> "FencingLease":
        """Refresh from a daemon thread at timeout/3, so liveness means
        PROCESS alive, not tick-loop fast: a leader mid-checkpoint must not
        go stale and get fenced by its own standby. SIGKILL and SIGSTOP
        silence the thread too — exactly the deaths the lease must expose.
        The thread reads before every write, so a woken zombie discovers
        the fence instead of clobbering the new leader's entry."""
        if self._hb_thread is not None:
            return self
        self._hb_stop = threading.Event()

        def _beat():
            while not self._hb_stop.is_set():
                if not self.refresh():
                    return  # fenced: never write again
                if self._hb_stop.wait(self.timeout_s / 3.0):
                    return

        self._hb_thread = threading.Thread(target=_beat, name="rtap-replicate-heartbeat",
                                           daemon=True)
        self._hb_thread.start()
        return self

    def stop_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None

    def set_meta(self, **kv) -> None:
        """Update lease metadata while the heartbeat runs. Rebinds
        ``self.meta`` to a fresh dict (never mutates in place): the
        heartbeat's write unpacks ``**self.meta`` without a lock, and an
        in-place insert mid-iteration would raise and silently kill the
        thread."""
        with self._lock:
            self.meta = {**self.meta, **kv}

    def still_mine(self) -> bool:
        """Cheap cached ownership probe (the AlertWriter's fence)."""
        if self.fenced:
            return False
        now = time.monotonic()
        if now - self._last_probe < self._probe_interval:
            return True
        with self._lock:
            if self.fenced:
                return False
            self._last_probe = now
            if self._lost(self.read()):
                self.fenced = True
                return False
        return True

    def holder(self) -> str | None:
        cur = self.read()
        return cur.get("owner") if cur else None

    def holder_meta(self) -> dict:
        return self.read() or {}


class Lease(FencingLease):
    """File-based leadership lease with a monotonic fencing epoch.

    The holder rewrites ``{epoch, owner, ts, meta...}`` every refresh; a
    process whose refresh (or :meth:`still_mine` probe) finds the epoch
    advanced — or the owner changed at its own epoch — is FENCED for good.
    Acquiring a stale or absent lease BUMPS the epoch, which is what fences
    the previous holder. Single-standby topology: the acquire path is
    read-check-replace, not a distributed lock."""

    def __init__(self, path: str | Path, owner: str, timeout_s: float = 5.0,
                 meta: dict | None = None):
        super().__init__(owner, timeout_s=timeout_s, meta=meta)
        self.path = Path(path)
        #: highest epoch ever observed in the file — the acquire bump floor.
        #: Without it, one unreadable read at promotion would restart epochs
        #: at 1 and INVERT the fence.
        self._seen_epoch = 0
        # its own lock: read() runs both inside self._lock (refresh,
        # still_mine) and outside it (is_stale, holder)
        self._seen_lock = threading.Lock()

    def read(self) -> dict | None:
        try:
            cur = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return None
        try:
            seen = int(cur.get("epoch", 0))
        except (TypeError, ValueError):
            # a malformed epoch cannot advance the floor; the entry still
            # serves the caller's staleness logic
            return cur
        # a read-modify-write shared by the heartbeat thread and unlocked
        # main-side probes: unguarded, an interleaving could regress the
        # floor and re-invert the fence at promotion
        with self._seen_lock:
            self._seen_epoch = max(self._seen_epoch, seen)
        return cur

    def _write(self) -> None:
        tmp = self.path.with_name(self.path.name + f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps({"epoch": self.epoch, "owner": self.owner,
                                   "ts": time.time(), **self.meta}))
        os.replace(tmp, self.path)

    def try_acquire(self) -> bool:
        """Claim leadership: succeeds when the lease is absent, stale or
        already ours. A fresh claim bumps the epoch past the previous
        holder's — the fence."""
        if self.fenced:
            return False
        cur = self.read()
        if cur is not None and cur.get("owner") != self.owner and not self._stale(cur):
            return False
        if cur is not None and cur.get("owner") == self.owner:
            self.epoch = max(self.epoch, int(cur.get("epoch", 0)))
        else:
            self.epoch = max(int(cur.get("epoch", 0) if cur else 0),
                             self._seen_epoch, self.epoch) + 1
        try:
            self._write()
        except OSError:
            return False
        return True

    def refresh(self) -> bool:
        """Re-stamp ts, or discover the fence. Returns False exactly when
        fenced. Thread-safe: the loop's fence check and the heartbeat
        thread share it."""
        with self._lock:
            if self.fenced:
                return False
            if self._lost(self.read()):
                self.fenced = True
                return False
            try:
                self._write()
            except OSError:
                # an unwritable lease is an infrastructure fault, not a
                # fence: keep serving (the standby promotes on staleness and
                # THEN we fence — the safe order)
                pass
            self.refreshes += 1
            self._last_probe = time.monotonic()
            return True


# --------------------------------------------------------------- sender
class ReplicationSender:
    """The leader half: tee journal records into a bounded buffer, ship
    them to the standby from a daemon thread, track acks, clamp
    compaction. The tick path's only cost is one deque append under a
    lock; socket stalls, reconnects and backfills live on the sender
    thread."""

    #: identical-position HELLOs tolerated before escalating to the
    #: checkpoint fallback: a standby stuck re-requesting the SAME tick
    #: means the journal cannot serve it (re-reading the same hole forever
    #: would be a livelock)
    MAX_STALLED_HELLOS = 3

    def __init__(self, address, journal: TickJournal, checkpoint_dir: str | None = None,
                 max_buffer: int = 8192, chaos=None, connect_timeout_s: float = 2.0):
        if max_buffer < 16:
            raise ValueError(f"max_buffer must be >= 16; got {max_buffer}")
        self.address = (address[0], int(address[1]))
        self.journal = journal
        self.checkpoint_dir = checkpoint_dir
        self.max_buffer = int(max_buffer)
        self.chaos = chaos
        self.connect_timeout_s = float(connect_timeout_s)
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wire = WireWalker()
        # per-type high-water marks of what the current connection shipped
        # (dedup between the disk backfill and the live queue)
        self._sent_data = self._sent_cursor = -1
        self.connected = False
        self.acked_tick = -1
        self.shipped_records = 0
        self.shipped_bytes = 0
        self.dropped_records = 0
        self.send_errors = 0
        self.snapshot_fallbacks = 0
        self.backfilled_records = 0
        obs = get_registry()
        self._obs_shipped = obs.counter(
            "rtap_obs_repl_shipped_records_total",
            "journal records shipped to the standby (live tee + disk backfill)")
        self._obs_bytes = obs.counter(
            "rtap_obs_repl_shipped_bytes_total", "replication bytes shipped to the standby")
        self._obs_dropped = obs.counter(
            "rtap_obs_repl_dropped_records_total",
            "journal records dropped from the bounded send buffer "
            "(drop-oldest: a slow/absent standby never stalls the "
            "leader; the standby heals via disk backfill on reconnect)")
        self._obs_errors = obs.counter(
            "rtap_obs_repl_send_errors_total",
            "replication socket errors (each starts a reconnect cycle)")
        self._obs_snap = obs.counter(
            "rtap_obs_repl_snapshot_fallbacks_total",
            "standby reconnects whose position was compacted out of the "
            "journal — resynced via the shared-checkpoint fetch")
        self._obs_backfill = obs.counter(
            "rtap_obs_repl_backfilled_records_total",
            "records re-read from the journal on disk to catch a "
            "reconnecting standby up")
        self._obs_lag = obs.gauge(
            "rtap_obs_repl_lag_records", "records waiting in the replication send buffer")
        self._obs_acked = obs.gauge(
            "rtap_obs_repl_acked_tick",
            "highest tick the standby has acked (applied + journaled)")

    # ---- the journal tee (loop thread) -------------------------------
    def tee(self, typ: int, tick: int, rec: bytes) -> None:
        with self._cond:
            self._q.append((typ, tick, rec))
            while len(self._q) > self.max_buffer:
                self._q.popleft()
                self.dropped_records += 1
                self._obs_dropped.inc()
            self._obs_lag.set(len(self._q))
            self._cond.notify()

    def compact_floor(self):
        """Journal compaction clamp: while a standby is CONNECTED the leader
        may not drop ticks past its ack; with no standby attached the clamp
        lifts (the reconnect path heals via backfill or checkpoint fetch)."""
        return (self.acked_tick + 1) if self.connected else None

    # ---- lifecycle ----------------------------------------------------
    def start(self) -> "ReplicationSender":
        self._thread = threading.Thread(target=self._run, name="rtap-replicate-sender",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def ack_lag_ticks(self) -> float | None:
        """Leader-side replication-ack lag in ticks (the journal's next write
        position minus the standby's last ack), the lag gauge the latency
        layer polls. None until a standby has acked once."""
        if self.acked_tick < 0:
            return None
        return float(max(0, self.journal.next_tick - 1 - self.acked_tick))

    def stats(self) -> dict:
        return {
            "connected": self.connected,
            "acked_tick": self.acked_tick,
            "shipped_records": self.shipped_records,
            "shipped_bytes": self.shipped_bytes,
            "dropped_records": self.dropped_records,
            "send_errors": self.send_errors,
            "snapshot_fallbacks": self.snapshot_fallbacks,
            "backfilled_records": self.backfilled_records,
            "buffered": len(self._q),
        }

    # ---- sender thread -----------------------------------------------
    def _run(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                sock = socket.create_connection(self.address, timeout=self.connect_timeout_s)
            except OSError:
                if self._stop.wait(backoff):
                    return
                backoff = min(1.0, backoff * 2)
                continue
            backoff = 0.05
            self._wire = WireWalker()  # no stale partial frames across connections
            try:
                self._serve_conn(sock)
            except OSError:
                self.send_errors += 1
                self._obs_errors.inc()
            finally:
                self.connected = False
                try:
                    sock.close()
                except OSError:
                    pass

    def _ship(self, sock, tick: int, rec: bytes) -> None:
        data = rec
        if self.chaos is not None:
            # the chaos wire seam: may sleep (stall_socket — the tick never
            # stalls), raise (conn_drop — reconnect + backfill), or corrupt
            # bytes (corrupt_bytes — the standby's CRC skip + resync)
            data = self.chaos.on_wire(tick, data)
        sock.sendall(data)
        self.shipped_records += 1
        self.shipped_bytes += len(data)
        self._obs_shipped.inc()
        self._obs_bytes.inc(len(data))

    def _fold_inbound(self, data: bytes) -> int | None:
        """Fold standby->leader records; returns a HELLO tick if any."""
        hello = None
        for typ, payload in self._wire.feed(data):
            if typ == WIRE_ACK and len(payload) >= 8:
                self.acked_tick = max(self.acked_tick, _Q.unpack_from(payload)[0])
                self._obs_acked.set(self.acked_tick)
            elif typ == WIRE_HELLO and len(payload) >= 8:
                hello = int(_Q.unpack_from(payload)[0])
        return hello

    def _poll_inbound(self, sock) -> int | None:
        """Drain any standby->leader records without blocking; returns a
        HELLO tick when the standby requested a (re)stream."""
        hello = None
        while True:
            try:
                sock.setblocking(False)
                data = sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            finally:
                sock.settimeout(0.2)
            if not data:
                raise ConnectionError("standby closed the connection")
            h = self._fold_inbound(data)
            if h is not None:
                hello = h
        return hello

    def _await_hello(self, sock) -> int:
        deadline = time.monotonic() + 30.0
        sock.settimeout(0.2)
        while not self._stop.is_set() and time.monotonic() < deadline:
            try:
                data = sock.recv(1 << 16)
            except socket.timeout:
                continue
            if not data:
                raise ConnectionError("standby closed before HELLO")
            hello = self._fold_inbound(data)
            if hello is not None:
                return hello
        raise ConnectionError("no HELLO from standby")

    def _serve_conn(self, sock) -> None:
        pending_hello: int | None = self._await_hello(sock)
        self.connected = True
        stalled_at: int | None = None
        stalled = 0
        while not self._stop.is_set():
            start = pending_hello
            pending_hello = None
            if start is not None:
                if start == stalled_at:
                    stalled += 1
                else:
                    stalled_at, stalled = start, 0
                first = first_journal_tick(self.journal.path)
                if (first >= 0 and start < first) or stalled >= self.MAX_STALLED_HELLOS:
                    # the standby's position was compacted away: the
                    # full-checkpoint fallback (it reloads the SHARED
                    # checkpoint dir, then re-HELLOs from there)
                    from rtap_tpu_torch.service.checkpoint import peek_resume_ticks

                    ck = peek_resume_ticks(self.checkpoint_dir) if self.checkpoint_dir else 0
                    self._ship(sock, start, pack_wire(WIRE_SNAP, _Q.pack(int(ck))))
                    self.snapshot_fallbacks += 1
                    self._obs_snap.inc()
                    pending_hello = self._await_hello(sock)
                    continue
                self._sent_data = self._sent_cursor = start - 1
                # disk backfill: the journal IS the retransmit buffer
                for typ, tick, rec in iter_raw_records(self.journal.path, start):
                    if self._stop.is_set():
                        return
                    self._ship(sock, tick, rec)
                    self.backfilled_records += 1
                    self._obs_backfill.inc()
                    if typ == _CURSOR:
                        self._sent_cursor = max(self._sent_cursor, tick)
                    else:
                        self._sent_data = max(self._sent_data, tick)
                    hello = self._poll_inbound(sock)
                    if hello is not None:
                        pending_hello = hello
                        break
                if pending_hello is not None:
                    continue
            # live streaming from the tee queue
            pending_hello = self._stream_live(sock)
            if pending_hello is None:
                return

    def _stream_live(self, sock) -> int | None:
        # per-type high-water marks dedup the overlap between the disk
        # backfill and records the tee queued meanwhile (TICK/FRAME and
        # CURSOR share tick numbering, so they dedup separately — a cursor
        # for the tick just shipped must still go out)
        while not self._stop.is_set():
            with self._cond:
                if not self._q:
                    self._cond.wait(0.1)
                batch = []
                while self._q and len(batch) < 256:
                    batch.append(self._q.popleft())
                self._obs_lag.set(len(self._q))
            for typ, tick, rec in batch:
                if typ == _CURSOR:
                    if tick <= self._sent_cursor:
                        continue
                    self._sent_cursor = tick
                elif typ in (_TICK, _FRAME):
                    if tick <= self._sent_data:
                        continue
                    self._sent_data = tick
                self._ship(sock, tick, rec)
            hello = self._poll_inbound(sock)
            if hello is not None:
                return hello
        return None


# ------------------------------------------------------------- follower
class _PromoteNow(Exception):
    """Internal: the lease went stale mid-follow."""

    def __init__(self, detect_s: float):
        self.detect_s = detect_s


class StandbyFollower:
    """The standby half: listen for the leader, mirror its journal, apply
    every tick through the normal scoring path, buffer undelivered alert
    lines, and promote on lease loss. Single-threaded; ``run()`` blocks
    until promotion ("promoted") or a stop request ("stopped")."""

    def __init__(self, registry, journal: TickJournal, *, lease: Lease, port: int = 0,
                 host: str = "127.0.0.1", alert_path: str | None = None,
                 checkpoint_dir: str | None = None, learn: bool = True,
                 cadence_s: float = 1.0, stop_event=None, max_buffered_alerts: int = 65536):
        self.reg = registry
        self.journal = journal
        self.lease = lease
        self.alert_path = alert_path
        self.checkpoint_dir = checkpoint_dir
        self.learn = bool(learn)
        self.cadence_s = float(cadence_s)
        self.stop_event = stop_event
        self.max_buffered_alerts = int(max_buffered_alerts)
        self.host, self.port = host, int(port)
        self.address = None
        self.groups = registry.groups
        self.gpos: list[int] = []
        self.expected = 0
        self.applied = 0
        self.duplicates = 0
        self.resyncs = 0
        self.snap_failures = 0
        self.skipped_rows = 0
        self.buffered_dropped = 0
        #: group-ticks applied with learning on (one TM learning-kernel
        #: launch each at learn_every 1 on the card)
        self.learned_group_ticks = 0
        self.apply_s = 0.0  # wall seconds in _apply_row (dispatch + collect)
        self.last_cursor: tuple[int, int] | None = None  # (tick, offset)
        self._alert_buf: deque = deque()  # (tick, alert_id, line)
        self._last_record_t = time.monotonic()
        self._last_hello_t = 0.0
        self._stale_since = None  # first stale lease observation
        self.stale_log: list = []  # lease ages at stale observations
        self._table = None  # DispatchTable for FRAME decode, lazy
        self._routing = None
        self.width = 0
        self.promote_detect_s = 0.0
        self.promote_re_emitted = self.promote_suppressed = 0
        self.promote_splice_s = self.promote_checkpoint_s = 0.0
        self.resume_suppression: set[str] = set()
        obs = get_registry()
        self._obs_applied = obs.counter(
            "rtap_obs_repl_applied_ticks_total",
            "shipped ticks the standby applied through the scoring path")
        self._obs_resyncs = obs.counter(
            "rtap_obs_repl_resyncs_total",
            "stream re-requests the standby sent after a gap (dropped/"
            "corrupt records; the leader re-reads its journal)")
        self._obs_buffered = obs.gauge(
            "rtap_obs_repl_buffered_alerts",
            "alert lines buffered on the standby awaiting the leader's "
            "delivery cursor (flushed exactly-once at promotion)")
        self._obs_promoted = obs.counter(
            "rtap_obs_repl_promotions_total", "standby promotions to leader (lease takeover)")
        self._obs_garbage = obs.counter(
            "rtap_obs_repl_wire_garbage_bytes_total",
            "replication stream bytes skipped while resyncing to the "
            "next record magic (corrupt producers, line noise)")

    # ---- catch-up from the shared checkpoints -------------------------
    def _adopt_checkpoints(self, attempts: int = 8) -> bool:
        """Load the shared checkpoint dir into the registry (the loop's
        resume, reduced to static membership); True if any group loaded.
        Retries per group: the standby reads this dir while the LIVE leader
        may be saving to it, and the atomic swap can remove files under a
        read, which fails loudly; a re-read lands on the new copy. A torn
        adoption across groups is fine — per-group ``gpos`` positions each
        group and the stream converges them."""
        if not self.checkpoint_dir or not os.path.isdir(self.checkpoint_dir):
            return False
        from rtap_tpu_torch.service.checkpoint import (
            checkpoint_exists,
            load_group,
            validate_resume,
        )
        from rtap_tpu_torch.service.shardpath import group_checkpoint_path

        loaded = False
        for gi, grp in enumerate(self.groups):
            ck_path = group_checkpoint_path(self.checkpoint_dir, gi)
            if not checkpoint_exists(ck_path):
                continue
            for attempt in range(attempts):
                try:
                    resumed = load_group(ck_path, device=grp.device)
                    resumed.health = grp.health
                    validate_resume(resumed, ck_path, grp, allow_claimed_extras=not self.learn)
                    break
                except Exception:  # a read racing the leader's swap
                    if attempt == attempts - 1:
                        raise
                    time.sleep(0.25)
            self.groups[gi] = resumed
            for slot in self.reg._slots.values():
                if slot.group is grp:
                    slot.group = resumed
            loaded = True
        return loaded

    def _build_routing(self) -> None:
        maps, off = [], 0
        for g in self.groups:
            slots = g.live_slots()
            maps.append((slots, [g.stream_ids[i] for i in slots], off))
            off += len(slots)
        self._routing = maps
        self.width = off

    def _reposition_from_checkpoints(self) -> bool:
        """Adopt the shared checkpoints and derive the stream position from
        them — the one implementation behind both the startup catch-up and
        the SNAP reconnect fallback: per-group ``gpos`` from the saved
        global journal cursors, routing, the HELLO frontier and the
        suppression base (the checkpoints' alert cursor). A local mirror
        tail beyond the adopted position is discarded: after a failover it
        belongs to the pre-takeover timeline. Returns whether any
        checkpoint was adopted."""
        loaded = self._adopt_checkpoints()
        self.gpos = [grp.resume_journal_tick if grp.resume_journal_tick is not None
                     else grp.ticks for grp in self.groups]
        self._build_routing()
        self._table = None
        self.expected = min(self.gpos) if self.gpos else 0
        offs = [g.resume_alerts_offset for g in self.groups
                if g.resume_alerts_offset is not None]
        if offs:
            self.last_cursor = (self.expected - 1, int(min(offs)))
        if self.journal.next_tick > self.expected:
            self.journal.wipe()
        else:
            self.journal.release_recovered()
        return loaded

    # ---- scoring (the normal path, m = 1 chunks) ----------------------
    def _apply_row(self, jt: int, jts: int, jvals, buffer_alerts: bool = True) -> None:
        from rtap_tpu_torch.service.alerts import format_alert_line
        from rtap_tpu_torch.service.registry import alert_gid

        t0 = time.perf_counter()
        if isinstance(jvals, JournaledFrames):
            from rtap_tpu_torch.ingest.dispatch import DispatchTable, decode_frames_to_row

            if jvals.width != self.width:
                self.skipped_rows += 1
                return
            if self._table is None:
                self._table = DispatchTable.from_registry(self.reg)
            jvals = decode_frames_to_row([jvals.blob], jvals.width, self._table)
        else:
            jvals = np.asarray(jvals, np.float32)
        if len(jvals) != self.width:
            self.skipped_rows += 1
            return
        for gi, grp in enumerate(self.groups):
            if self.gpos[gi] != jt:
                continue  # a torn checkpoint adoption leaves groups at
                # different positions; each applies only its own next row
            slots, ids, off = self._routing[gi]
            v = np.full((1, grp.G) + jvals.shape[1:], np.nan, np.float32)
            v[0, slots] = jvals[off:off + len(slots)]
            t = np.full((1, grp.G), int(jts), np.int64)
            h = grp.dispatch_chunk(v, t, learn=self.learn)
            r_raw, r_ll, r_al = grp.collect_chunk(h)
            # the ticks its cadence learns on (every tick at full rate)
            self.learned_group_ticks += h["learned"]
            self.gpos[gi] += 1
            if buffer_alerts:
                gid = alert_gid(gi, grp)
                for j in np.nonzero(r_al[0, slots])[0]:
                    sid = ids[j]
                    aid = f"{gid}:{sid}:{grp.ticks - 1}"
                    self._alert_buf.append((jt, aid, format_alert_line(
                        aid, sid, int(jts), jvals[off + int(j)],
                        float(r_raw[0, slots][j]), float(r_ll[0, slots][j]))))
                while len(self._alert_buf) > self.max_buffered_alerts:
                    # cursors stopped coming: bounded memory wins
                    # (drop-oldest, counted)
                    self._alert_buf.popleft()
                    self.buffered_dropped += 1
        self._obs_buffered.set(len(self._alert_buf))
        self.apply_s += time.perf_counter() - t0

    # ---- the follow loop ----------------------------------------------
    def _stale_check(self) -> None:
        # staleness must PERSIST for an extra timeout/2 before promoting: a
        # single stale read can be a live leader whose heartbeat thread was
        # starved for one beat, and a false promotion fences a healthy
        # leader. A dead leader stays stale; the grace costs ~timeout/2 of
        # detection latency.
        cur = self.lease.read()
        if cur is None or self.lease._stale(cur):
            now = time.monotonic()
            # the forensic trail of the promotion decision: the lease's age
            # (or unreadable) at each stale observation
            if len(self.stale_log) < 64:
                ts = cur.get("ts") if cur is not None else None
                self.stale_log.append(round(time.time() - float(ts), 3)
                                      if ts is not None else None)
            if self._stale_since is None:
                self._stale_since = now
            elif now - self._stale_since >= self.lease.timeout_s / 2.0:
                raise _PromoteNow(now - self._last_record_t)
        else:
            self._stale_since = None

    def _stopped(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()

    def _send_hello(self, conn) -> None:
        conn.sendall(pack_wire(WIRE_HELLO, _Q.pack(int(self.expected))))

    def _request_resync(self, conn) -> None:
        now = time.monotonic()
        if now - self._last_hello_t < 0.5:
            return  # rate-limited: one request per gap episode
        self._last_hello_t = now
        self.resyncs += 1
        self._obs_resyncs.inc()
        self._send_hello(conn)

    def _handle(self, conn, typ: int, payload: bytes) -> None:
        if typ == WIRE_SNAP:
            # our position was compacted out of the leader's journal:
            # reload the shared dir, then re-request from the new position
            if not self._reposition_from_checkpoints():
                # the shared dir is empty (the leader never saved a round
                # yet): stay alive and keep asking — the leader's next save
                # round unblocks the fallback
                self.snap_failures += 1
                time.sleep(0.25)
            else:
                # pre-checkpoint alerts were delivered (the cursor in meta
                # is at/after them)
                self._alert_buf.clear()
                self._obs_buffered.set(0)
            self._last_hello_t = 0.0
            self._send_hello(conn)
            return
        rec = TickJournal._parse(typ, payload)
        if rec is None:
            return  # malformed payload inside a valid frame: drop
        if typ == _CURSOR:
            ct, coff = rec
            if self.last_cursor is None or ct >= self.last_cursor[0]:
                self.last_cursor = (int(ct), int(coff))
            self.journal.append_cursor(int(ct), int(coff))
            while self._alert_buf and self._alert_buf[0][0] <= ct:
                self._alert_buf.popleft()  # delivered by the leader
            self._obs_buffered.set(len(self._alert_buf))
            return
        jt, jts, jvals = rec
        if jt < self.expected:
            self.duplicates += 1
            return
        if jt > self.expected:
            self._request_resync(conn)
            return
        # mirror to the local journal FIRST (the leader's write-ahead
        # order), then score; guarded so a re-stream over rows already
        # mirrored never appends a duplicate index
        if jt >= self.journal.next_tick:
            if isinstance(jvals, JournaledFrames):
                self.journal.append_tick_frames(jt, jts, jvals.width, [jvals.blob])
            else:
                self.journal.append_tick(jt, jts, jvals)
        self._apply_row(jt, jts, jvals)
        self.expected = jt + 1
        self.applied += 1
        self._obs_applied.inc()
        self._last_record_t = time.monotonic()
        self._last_hello_t = 0.0
        conn.sendall(pack_wire(WIRE_ACK, _Q.pack(self.expected - 1)))

    def _follow_conn(self, conn) -> None:
        conn.settimeout(0.1)  # bounds lease-staleness detection while a
        # dead connection lingers
        self._send_hello(conn)
        wire = WireWalker()
        garbage0 = 0
        while not self._stopped():
            self._stale_check()
            try:
                data = conn.recv(1 << 20)
            except socket.timeout:
                continue
            if not data:
                return  # leader gone; the lease watch decides what's next
            for typ, payload in wire.feed(data):
                self._handle(conn, typ, payload)
            if wire.garbage_bytes > garbage0:
                self._obs_garbage.inc(wire.garbage_bytes - garbage0)
                garbage0 = wire.garbage_bytes
                self._request_resync(conn)

    def run(self) -> str:
        """Follow until promoted or stopped. Returns "promoted" (the caller
        continues into live leader serving — the checkpoints and the
        spliced alert stream are on disk) or "stopped"."""
        self._reposition_from_checkpoints()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(1)
        srv.settimeout(0.1)
        self.address = srv.getsockname()
        self._last_record_t = time.monotonic()
        try:
            while not self._stopped():
                try:
                    self._stale_check()
                    try:
                        conn, _addr = srv.accept()
                    except socket.timeout:
                        continue
                    try:
                        self._follow_conn(conn)
                    finally:
                        try:
                            conn.close()
                        except OSError:
                            pass
                except _PromoteNow as p:
                    self._stale_since = None
                    if self.lease.try_acquire():
                        # hold the lease alive through the promotion itself:
                        # the splice and the warm-fleet checkpoint take
                        # seconds at full width
                        self.lease.start_heartbeat()
                        self._promote(p.detect_s)
                        return "promoted"
                    # lost the race (another standby won): keep following
                    self._last_record_t = time.monotonic()
                except OSError:
                    continue  # connection-level fault: re-accept
            return "stopped"
        finally:
            try:
                srv.close()
            except OSError:
                pass

    # ---- promotion -----------------------------------------------------
    def _promote(self, detect_s: float) -> None:
        """Take over: splice the alert stream exactly-once, checkpoint the
        warm fleet at the takeover tick."""
        from rtap_tpu_torch.service.alerts import heal_torn_tail, scan_alert_ids
        from rtap_tpu_torch.service.loop import _save_all

        t0 = time.perf_counter()
        self.promote_detect_s = float(detect_s)
        re_emitted = suppressed = 0
        sink_size = 0
        # alert ids the dead leader delivered for ticks we NEVER received
        # (killed between its emit and its ship): the live loop re-scores
        # those ticks and must suppress them
        self.resume_suppression = set()
        if self.alert_path is not None:
            heal_torn_tail(self.alert_path)  # the dead leader's torn line
            # every alert byte past the last delivery cursor belongs to the
            # buffered window: suppress exactly the ids the dead leader
            # delivered, flush the rest
            base_off = self.last_cursor[1] if self.last_cursor else 0
            suppress = scan_alert_ids(self.alert_path, base_off)
            buffered_ids = {aid for _t, aid, _l in self._alert_buf}
            self.resume_suppression = suppress - buffered_ids
            try:
                with open(self.alert_path, "a") as f:
                    for _tick, aid, line in self._alert_buf:
                        if aid in suppress:
                            suppressed += 1
                            continue
                        f.write(line)
                        re_emitted += 1
                    f.write(json.dumps({
                        "event": "standby_promoted",
                        "tick": int(self.expected),
                        "epoch": int(self.lease.epoch),
                        "detect_s": round(detect_s, 3),
                        "detect_ticks": round(detect_s / self.cadence_s, 2)
                        if self.cadence_s > 0 else None,
                        "re_emitted": re_emitted,
                        "suppressed": suppressed,
                    }) + "\n")
                    f.flush()
            except OSError:
                pass  # the live loop's sink discipline: the next resume scan retries
            try:
                sink_size = os.path.getsize(self.alert_path)
            except OSError:
                sink_size = 0
        self._alert_buf.clear()
        self._obs_buffered.set(0)
        self.promote_re_emitted = re_emitted
        self.promote_suppressed = suppressed
        t1 = time.perf_counter()
        self.promote_splice_s = t1 - t0
        if self.checkpoint_dir:
            # the takeover checkpoint: the warm fleet at the spliced instant,
            # so the caller's live_loop resumes bit-identically
            _save_all(self.groups, self.checkpoint_dir, alerts_offset=sink_size,
                      journal_tick=self.expected)
        self.promote_checkpoint_s = time.perf_counter() - t1
        self._obs_promoted.inc()

    def stats(self) -> dict:
        return {
            "applied_ticks": self.applied,
            "duplicates": self.duplicates,
            "resyncs": self.resyncs,
            "snap_failures": self.snap_failures,
            "skipped_rows": self.skipped_rows,
            "buffered_alerts": len(self._alert_buf),
            "buffered_dropped": self.buffered_dropped,
            "expected_tick": self.expected,
            "last_cursor": list(self.last_cursor) if self.last_cursor else None,
            "stale_log": list(self.stale_log),
            "learned_group_ticks": self.learned_group_ticks,
            "apply_ms_per_tick": round(self.apply_s / self.applied * 1e3, 3)
            if self.applied else None,
        }
