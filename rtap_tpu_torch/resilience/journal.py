"""Crash-consistent tick journal: a per-tick write-ahead log for serve.

The port's copy of the JAX package's ``resilience/journal.py``, with the
same byte format, so a journal written by either package is read by the
other. HTM temporal-memory state is sequential: every tick lost at a crash
is temporal context the model cannot recover. Checkpoints bound the loss to
a save round; the journal closes the remaining gap: every ingested tick row
(raw values + source timestamp) is appended BEFORE it is scored, so a
restarted serve restores the newest checkpoint and replays the journaled
ticks past its tick cursor through the normal scoring path
(service/loop.py owns the replay; this module owns the format and its
recovery).

Durability model: every append is ``flush()``-ed to the kernel, so a
SIGKILL loses at most the record being written at that instant. Machine
crashes are governed by the fsync policy: ``os`` (never fsync; default),
``every-tick``, ``every-N``.

Recovery tolerates torn writes: a corrupt or truncated segment tail is
truncated back to the last valid record, counted, never a refusal to
start. Corruption in the middle of the log truncates at the first bad
record and drops the later segments; recovered ticks are a clean prefix.

Record framing (little-endian)::

    b"RJ" | type u8 | payload_len u32 | payload | crc32 u32

crc32 covers type + payload_len + payload. Record types:

- TICK   (1): tick i64, ts i64, ndim u8, dims i32*, float32 values
- CURSOR (2): tick i64, alert-sink byte offset i64 (the alert-delivery
  cursor after each emitted chunk; a diagnostic trail — the load-bearing
  cursor lives in the checkpoint meta)
- FRAME  (3): tick i64, ts i64, width i32, raw binary-ingest frame bytes
  (a tick fed by ``ingest.BinaryBatchSource``: 10 B per row that arrived
  instead of 4 B per stream; the loop's replay re-runs the ingest scatter
  over them through the registry's dispatch table).

Segments rotate at ``segment_bytes`` and are bounded by ``max_segments``
(oldest dropped + counted). ``compact(upto_tick)`` drops segments whose
records all predate the latest checkpoint; the serve loop calls it after
every successful save round.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from pathlib import Path

import numpy as np

from rtap_tpu_torch.obs import get_registry

__all__ = ["TickJournal", "JournaledFrames", "parse_fsync",
           "last_journal_tick", "FSYNC_POLICIES"]


class JournaledFrames:
    """A FRAME record's payload: the raw RB1 wire frames of one tick plus
    the dispatch width they were ingested at. The loop's journal replay
    materializes the value vector through the binary source's dispatch
    table (the codes are meaningless without it)."""

    __slots__ = ("width", "blob")

    def __init__(self, width: int, blob: bytes):
        self.width = int(width)
        self.blob = blob

_MAGIC = b"RJ"
_TICK = 1
_CURSOR = 2
_FRAME = 3
_TYPES = (_TICK, _CURSOR, _FRAME)
_HEADER = struct.Struct("<2sBI")  # magic, type, payload length
_CRC = struct.Struct("<I")
_TICK_HEAD = struct.Struct("<qqB")  # tick, ts, ndim
_DIM = struct.Struct("<i")
_CURSOR_PAYLOAD = struct.Struct("<qq")  # tick, alert-sink byte offset
_FRAME_HEAD = struct.Struct("<qqi")  # tick, ts, dispatch width
#: a payload larger than this is treated as frame corruption, not a
#: record (a flipped length byte must not make recovery try to allocate
#: gigabytes): 256 MiB comfortably exceeds any real fleet's tick row
_MAX_PAYLOAD = 256 << 20

FSYNC_POLICIES = ("os", "every-tick", "every-n")


def parse_fsync(spec: str) -> tuple[str, int]:
    """Parse the operator-facing fsync policy string: ``os``,
    ``every-tick``, or ``every-<N>`` (fsync once per N tick records).
    Returns (policy, n); raises ValueError on anything else."""
    spec = str(spec).strip().lower()
    if spec == "os":
        return "os", 0
    if spec == "every-tick":
        return "every-tick", 0
    if spec.startswith("every-"):
        try:
            n = int(spec[len("every-"):])
        except ValueError:
            n = 0
        if n >= 1:
            return "every-n", n
    raise ValueError(
        f"journal fsync policy must be 'os', 'every-tick', or 'every-<N>' "
        f"(N >= 1); got {spec!r}")


def _seg_name(seq: int) -> str:
    return f"seg-{seq:08d}.rjl"


def _list_segments(path: Path) -> list[Path]:
    try:
        names = sorted(
            n for n in os.listdir(path)
            if n.startswith("seg-") and n.endswith(".rjl"))
    except OSError:
        return []
    return [path / n for n in names]


def _walk_headers(path: Path):
    """Yield (type, payload_len, file_handle) per structurally valid
    record across a journal dir's segments — headers only: payloads are
    seeked over, CRCs skipped, a torn tail ends the walk. The handle is
    positioned at the payload start; consumers may read a prefix (the
    walk reseeks to the record end regardless). The framing scanner
    behind :func:`last_journal_tick` (full CRC-checked parsing lives in
    TickJournal._recover)."""
    for seg in _list_segments(path):
        try:
            with open(seg, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                off = 0
                while off + _HEADER.size <= size:
                    head = f.read(_HEADER.size)
                    if len(head) < _HEADER.size:
                        break
                    magic, typ, ln = _HEADER.unpack(head)
                    end = off + _HEADER.size + ln + _CRC.size
                    if magic != _MAGIC or typ not in _TYPES \
                            or ln > _MAX_PAYLOAD or end > size:
                        break
                    yield typ, ln, f
                    f.seek(end)
                    off = end
        except OSError:
            break


def last_journal_tick(path: str | Path) -> int:
    """Highest tick index visible in a journal dir (TICK or FRAME
    records; header walk, CRCs skipped, torn tail ends the scan) — a
    kill drill's progress probe. Unlike a record count this is
    monotonic across segment rotation AND checkpoint compaction; -1
    for an empty/missing journal."""
    last = -1
    for typ, ln, f in _walk_headers(Path(path)):
        if typ in (_TICK, _FRAME) and ln >= 8:
            (tick,) = struct.unpack("<q", f.read(8))
            last = max(last, int(tick))
    return last


class TickJournal:
    """Append-only per-tick WAL with torn-write-tolerant recovery.

    Construction performs recovery: existing segments are scanned in
    order, the torn/corrupt tail (if any) is truncated back to the last
    valid record, and the surviving tick rows land in
    ``self.recovered_ticks`` (list of ``(tick, ts, values)``) for the
    loop to replay. Appends then continue the same log — global tick
    indices are monotonic across process restarts.
    """

    def __init__(self, path: str | Path, *, segment_bytes: int = 4 << 20,
                 fsync: str = "os", fsync_every: int = 64,
                 max_segments: int = 256):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {FSYNC_POLICIES}; got {fsync!r} "
                "(parse_fsync handles the operator string forms)")
        if fsync == "every-n" and fsync_every < 1:
            raise ValueError(
                f"fsync_every must be >= 1 with every-n; got {fsync_every}")
        if segment_bytes < 1024:
            raise ValueError(
                f"segment_bytes must be >= 1024; got {segment_bytes}")
        if max_segments < 2:
            raise ValueError(f"max_segments must be >= 2; got {max_segments}")
        self.path = Path(path).absolute()
        self.path.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.max_segments = int(max_segments)
        self.fsync = fsync
        self.fsync_every = int(fsync_every)
        #: recovered state (filled by the scan below)
        self.recovered_ticks: list[tuple[int, int, np.ndarray]] = []
        self.cursors: list[tuple[int, int]] = []
        self.truncations = 0  # torn/corrupt tails truncated
        self.truncated_bytes = 0
        self.dropped_segments = 0  # segments after a mid-log corruption
        self.duplicate_ticks_skipped = 0
        # append accounting
        self.appended_ticks = 0
        self.appended_cursors = 0
        self.appended_bytes = 0
        self.fsyncs = 0
        self.rotations = 0
        self.evicted_segments = 0  # max_segments bound fired (data loss)
        self._ticks_since_fsync = 0
        self._fh = None
        self._seg_size = 0
        self._seg_seq = 0
        #: per-segment max record tick, for compact() (name -> tick)
        self._seg_max_tick: dict[str, int] = {}
        obs = get_registry()
        self._obs_appends = obs.counter(
            "rtap_obs_journal_appends_total",
            "journal records appended (tick rows + alert cursors)")
        self._obs_bytes = obs.counter(
            "rtap_obs_journal_bytes_total",
            "bytes appended to the tick journal")
        self._obs_fsyncs = obs.counter(
            "rtap_obs_journal_fsyncs_total",
            "explicit fsyncs issued by the journal's durability policy")
        self._obs_rotations = obs.counter(
            "rtap_obs_journal_segments_rotated_total",
            "journal segment rotations (segment_bytes reached)")
        self._obs_truncated = obs.counter(
            "rtap_obs_journal_truncations_total",
            "torn/corrupt journal tails truncated back to the last valid "
            "record during recovery (never a refusal to start)")
        self._obs_compacted = obs.counter(
            "rtap_obs_journal_compacted_segments_total",
            "journal segments dropped by checkpoint-driven compaction")
        self._obs_segments = obs.gauge(
            "rtap_obs_journal_segments", "journal segments currently on disk")
        self._obs_append_seconds = obs.histogram(
            "rtap_obs_journal_append_seconds",
            "wall seconds per journal tick append (format + write + flush "
            "+ policy fsync)")
        self._recover()
        self.recovered_count = len(self.recovered_ticks)
        self.next_tick = (self.recovered_ticks[-1][0] + 1
                          if self.recovered_ticks else 0)
        self._obs_segments.set(len(_list_segments(self.path)))

    def release_recovered(self) -> None:
        """Drop the materialized recovery rows once the caller has
        replayed them — a large replay window (up to max_segments *
        segment_bytes of decoded arrays) must not stay resident for the
        rest of the process. Counts survive in stats()."""
        self.recovered_ticks = []
        self.cursors = []

    # ---- recovery ----------------------------------------------------
    def _recover(self) -> None:
        segs = _list_segments(self.path)
        corrupt = False
        last_tick = -1
        for seg in segs:
            seq = int(seg.name[4:-4])
            self._seg_seq = max(self._seg_seq, seq)
            if corrupt:
                # everything after the first corruption is dropped: the
                # replayable log must be a contiguous prefix of ticks
                try:
                    size = seg.stat().st_size
                    seg.unlink()
                except OSError:
                    size = 0
                self.dropped_segments += 1
                self.truncated_bytes += size
                continue
            try:
                data = seg.read_bytes()
            except OSError:
                corrupt = True
                self.truncations += 1
                self._obs_truncated.inc()
                continue
            off = 0
            seg_max = -1
            while off + _HEADER.size + _CRC.size <= len(data):
                magic, typ, ln = _HEADER.unpack_from(data, off)
                end = off + _HEADER.size + ln + _CRC.size
                if magic != _MAGIC or typ not in _TYPES \
                        or ln > _MAX_PAYLOAD or end > len(data):
                    break
                payload = data[off + _HEADER.size:end - _CRC.size]
                (crc,) = _CRC.unpack_from(data, end - _CRC.size)
                if crc != zlib.crc32(data[off + 2:off + _HEADER.size]
                                     + payload):
                    break
                rec = self._parse(typ, payload)
                if rec is None:
                    break
                if typ in (_TICK, _FRAME):
                    if rec[0] <= last_tick:
                        # out-of-order / repeated index: keep the FIRST
                        # copy (appends never reuse an index — the
                        # loop's journal_base is floored at next_tick —
                        # so a duplicate only arises from hand-edited or
                        # stitched journals; first-wins keeps the scan
                        # deterministic)
                        self.duplicate_ticks_skipped += 1
                    else:
                        self.recovered_ticks.append(rec)
                        last_tick = rec[0]
                    seg_max = max(seg_max, rec[0])
                else:
                    self.cursors.append(rec)
                    seg_max = max(seg_max, rec[0])
                off = end
            if off < len(data):
                # torn or corrupt tail: truncate back to the last valid
                # record; if this is NOT the last segment, later segments
                # are dropped above (corrupt stays set)
                try:
                    with open(seg, "r+b") as f:
                        f.truncate(off)
                except OSError:
                    pass
                self.truncations += 1
                self.truncated_bytes += len(data) - off
                self._obs_truncated.inc()
                corrupt = True
            if seg_max >= 0:
                self._seg_max_tick[seg.name] = seg_max

    @staticmethod
    def _parse(typ: int, payload: bytes):
        try:
            if typ == _CURSOR:
                tick, offset = _CURSOR_PAYLOAD.unpack(payload)
                return int(tick), int(offset)
            if typ == _FRAME:
                tick, ts, width = _FRAME_HEAD.unpack_from(payload, 0)
                if width < 0:
                    return None
                return int(tick), int(ts), JournaledFrames(
                    int(width), payload[_FRAME_HEAD.size:])
            tick, ts, ndim = _TICK_HEAD.unpack_from(payload, 0)
            off = _TICK_HEAD.size
            shape = []
            for _ in range(ndim):
                (d,) = _DIM.unpack_from(payload, off)
                off += _DIM.size
                shape.append(int(d))
            n = int(np.prod(shape)) if shape else 1
            raw = payload[off:off + 4 * n]
            if len(raw) != 4 * n or any(d < 0 for d in shape):
                return None
            values = np.frombuffer(raw, np.float32).reshape(shape).copy()
            return int(tick), int(ts), values
        except (struct.error, ValueError):
            return None

    # ---- append ------------------------------------------------------
    def _open_segment(self) -> None:
        if self._fh is not None:
            return
        segs = _list_segments(self.path)
        if segs and segs[-1].stat().st_size < self.segment_bytes:
            seg = segs[-1]
        else:
            self._seg_seq += 1
            seg = self.path / _seg_name(self._seg_seq)
        self._fh = open(seg, "ab")
        self._seg_name = seg.name
        self._seg_size = seg.stat().st_size

    def _rotate(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._seg_seq += 1
        seg = self.path / _seg_name(self._seg_seq)
        self._fh = open(seg, "ab")
        self._seg_name = seg.name
        self._seg_size = 0
        self.rotations += 1
        self._obs_rotations.inc()
        segs = _list_segments(self.path)
        while len(segs) > self.max_segments:
            # hard bound: oldest segment evicted (counted — this is data
            # loss past the bound; size max_segments so checkpoints
            # compact long before it fires)
            victim = segs.pop(0)
            try:
                victim.unlink()
            except OSError:
                break
            self._seg_max_tick.pop(victim.name, None)
            self.evicted_segments += 1
        self._obs_segments.set(len(segs))

    def _append(self, typ: int, payload: bytes, tick: int) -> None:
        self._open_segment()
        if self._seg_size and self._seg_size + len(payload) + 16 \
                > self.segment_bytes:
            self._rotate()
        head = _HEADER.pack(_MAGIC, typ, len(payload))
        rec = head + payload + _CRC.pack(zlib.crc32(head[2:] + payload))
        self._fh.write(rec)
        # flush to the kernel unconditionally: a SIGKILL after this point
        # loses nothing (fsync below is for power loss, per policy)
        self._fh.flush()
        self._seg_size += len(rec)
        self._seg_max_tick[self._seg_name] = max(
            self._seg_max_tick.get(self._seg_name, -1), tick)
        self.appended_bytes += len(rec)
        self._obs_appends.inc()
        self._obs_bytes.inc(len(rec))

    def _append_tick_record(self, typ: int, tick: int, payload: bytes,
                            t0: float) -> None:
        """Shared tail of every tick-carrying append: write, advance the
        tick cursor, run the fsync policy, observe the cost — TICK and
        FRAME records never diverge in durability. ``t0`` is taken before
        the caller builds its payload, so the append histogram covers
        format + write + flush + policy fsync."""
        self._append(typ, payload, int(tick))
        self.appended_ticks += 1
        self.next_tick = max(self.next_tick, int(tick) + 1)
        if self.fsync == "every-tick":
            self._fsync()
        elif self.fsync == "every-n":
            self._ticks_since_fsync += 1
            if self._ticks_since_fsync >= self.fsync_every:
                self._fsync()
        self._obs_append_seconds.observe(time.perf_counter() - t0)

    def append_tick(self, tick: int, ts: int, values: np.ndarray) -> None:
        """Append one ingested tick row (the write-ahead record): global
        tick index, source timestamp, and the raw value vector in
        dispatch/routing order."""
        t0 = time.perf_counter()
        values = np.ascontiguousarray(values, np.float32)
        payload = (_TICK_HEAD.pack(int(tick), int(ts), values.ndim)
                   + b"".join(_DIM.pack(d) for d in values.shape)
                   + values.tobytes())
        self._append_tick_record(_TICK, tick, payload, t0)

    def append_tick_frames(self, tick: int, ts: int, width: int, frames) -> None:
        """Append one ingested tick as its RAW binary ingest frames: the
        wire bytes land verbatim (no full-width re-encode), plus the
        dispatch width replay validates against. An empty frame list is a
        legal all-NaN tick (no data arrived)."""
        t0 = time.perf_counter()
        payload = _FRAME_HEAD.pack(int(tick), int(ts), int(width)) + b"".join(frames)
        self._append_tick_record(_FRAME, tick, payload, t0)

    def append_cursor(self, tick: int, alerts_offset: int) -> None:
        """Append an alert-delivery cursor: alerts through global `tick`
        have been handed to the sink, whose byte offset is
        `alerts_offset` (diagnostic trail; see module docstring)."""
        self._append(_CURSOR,
                     _CURSOR_PAYLOAD.pack(int(tick), int(alerts_offset)),
                     int(tick))
        self.appended_cursors += 1

    def _fsync(self) -> None:
        try:
            os.fsync(self._fh.fileno())
        except OSError:
            return
        self.fsyncs += 1
        self._ticks_since_fsync = 0
        self._obs_fsyncs.inc()

    # ---- maintenance -------------------------------------------------
    def compact(self, upto_tick: int) -> int:
        """Drop whole segments whose records all predate `upto_tick`
        (the newest checkpoint's tick cursor): those ticks can never be
        replayed again. Returns segments dropped."""
        dropped = 0
        for seg in _list_segments(self.path):
            if seg.name == getattr(self, "_seg_name", None) \
                    and self._fh is not None:
                continue  # never unlink the open segment
            if self._seg_max_tick.get(seg.name, upto_tick) >= upto_tick:
                continue
            try:
                seg.unlink()
            except OSError:
                continue
            self._seg_max_tick.pop(seg.name, None)
            dropped += 1
        if dropped:
            self._obs_compacted.inc(dropped)
            self._obs_segments.set(len(_list_segments(self.path)))
        return dropped

    def wipe(self) -> None:
        """Drop every segment and all recovered state: the journal starts
        over at tick 0 (a run that must not replay an older timeline)."""
        self.close()
        for seg in _list_segments(self.path):
            try:
                seg.unlink()
            except OSError:
                pass
        self.recovered_ticks = []
        self.cursors = []
        self.recovered_count = 0
        self.next_tick = 0
        self._seg_max_tick.clear()
        self._seg_size = 0
        self._obs_segments.set(0)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                if self.fsync != "os":
                    os.fsync(self._fh.fileno())
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def stats(self) -> dict:
        return {
            "recovered_ticks": self.recovered_count,
            "next_tick": self.next_tick,
            "truncations": self.truncations,
            "truncated_bytes": self.truncated_bytes,
            "dropped_segments": self.dropped_segments,
            "duplicate_ticks_skipped": self.duplicate_ticks_skipped,
            "appended_ticks": self.appended_ticks,
            "appended_cursors": self.appended_cursors,
            "appended_bytes": self.appended_bytes,
            "fsyncs": self.fsyncs,
            "rotations": self.rotations,
            "evicted_segments": self.evicted_segments,
            "fsync_policy": self.fsync if self.fsync != "every-n"
            else f"every-{self.fsync_every}",
            "segments": len(_list_segments(self.path)),
        }
