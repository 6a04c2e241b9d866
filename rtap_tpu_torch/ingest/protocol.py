"""The ``RB1`` binary batch frame: format, slot-code packing, frame walker.

The port's copy of the JAX package's ``ingest/protocol.py``: the same bytes
on the wire, so a producer of either package feeds a listener of the other.
Per-record JSON costs the host a Python object per record. This
protocol moves the per-record cost to the producer: a frame carries a
whole batch of packed 10-byte rows that the consumer decodes with ONE
``np.frombuffer`` call and scatters with ONE fancy-index assignment;
nothing on the hot path touches a Python object per record.

Frame layout (little-endian throughout; docs/INGEST.md is the operator
reference)::

    offset size  field
    0      3     magic      b"RB1"
    3      1     version    PROTOCOL_VERSION (1)
    4      1     kind       1=DATA  2=NAMES  3=MAP
    5      1     tenant_len bytes of tenant id following the header
    6      2     epoch      map epoch the frame's slot codes came from
                            (0 = epoch-unaware producer, always admitted)
    8      4     count      DATA: row count; NAMES/MAP: payload bytes
    12     8     base_ts    unix seconds rows are relative to (DATA)
    20     T     tenant     tenant_len bytes, UTF-8
    20+T   P     payload    DATA: count * 10 bytes of packed rows
                            NAMES: newline-joined UTF-8 stream ids
                            MAP:   JSON {"__epoch__": N, stream_id: code}
    20+T+P 4     crc32      zlib.crc32 over bytes [3, 20+T+P)

The map EPOCH closes the stale-code wormhole: slot codes are positional,
so a slot released and re-claimed by a NEW stream reuses the old code —
a producer still sending with a cached map would silently feed the new
stream's model (the string-id JSONL path cannot mis-deliver this way).
Every MAP hello carries the current epoch; producers stamp it into their
DATA frames; the consumer drops whole frames whose nonzero epoch
disagrees with the current map (counted,
``rtap_obs_ingest_stale_epoch_total``) — a stale producer goes loudly
deaf instead of silently corrupting a stranger's model.

A DATA row is ``slot_code u32 | value f32 | ts_delta u16`` (10 bytes,
packed). ``row ts = base_ts + ts_delta`` — a frame spans at most ~18 h
of timestamps, far beyond any backfill horizon. The slot code packs the
registry's (shard, group, slot) address (:func:`encode_slot`):
8 shard bits | 12 group bits | 12 slot bits.

Versioning rules (docs/INGEST.md): the FRAMING fields — magic, version,
kind, tenant_len, count, base_ts positions and the trailing crc32 — are
frozen for the life of the ``RB1`` magic, so any parser can delimit and
CRC-check a frame whose version or kind it does not understand; such
frames are skipped whole and counted (``version_skew``), never treated
as garbage. Layout-incompatible changes must bump the magic (``RB2``).

The frame walker (stream -> validated frames) has a native C fast path
(rtap_tpu_torch/native/frame_walker.c, same build/fallback discipline as
the JSONL parser) and a pure-Python fallback with identical semantics —
torn tails wait for more bytes, bad magic resyncs to the next magic
(counted as garbage bytes), CRC mismatches skip the frame.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

PROTOCOL_VERSION = 1
MAGIC = b"RB1"

KIND_DATA = 1
KIND_NAMES = 2
KIND_MAP = 3
_KINDS = (KIND_DATA, KIND_NAMES, KIND_MAP)

HEADER = struct.Struct("<3sBBBHIq")  # magic, version, kind, tenant_len,
# epoch, count, base_ts
CRC = struct.Struct("<I")
ROW_DTYPE = np.dtype(
    [("slot", "<u4"), ("value", "<f4"), ("dt", "<u2")])  # 10 B packed
ROW_SIZE = ROW_DTYPE.itemsize
assert ROW_SIZE == 10

#: framing sanity bounds — a flipped count byte must not make the walker
#: wait forever for (or allocate) gigabytes
MAX_DATA_ROWS = 1 << 22       # 4M rows = 40 MiB payload
MAX_BLOB_BYTES = 16 << 20     # NAMES/MAP payloads

# ---- (shard, group, slot) slot-code packing --------------------------
# 8 | 12 | 12: up to 256 shards, 4096 groups, 4096 slots/group
SHARD_BITS = 8
GROUP_BITS = 12
SLOT_BITS = 12
MAX_SHARDS = 1 << SHARD_BITS
MAX_GROUPS = 1 << GROUP_BITS
MAX_SLOTS = 1 << SLOT_BITS


def encode_slot(shard: int, group: int, slot: int) -> int:
    """Pack a registry (shard, group, slot) address into the wire u32."""
    if not (0 <= shard < MAX_SHARDS and 0 <= group < MAX_GROUPS
            and 0 <= slot < MAX_SLOTS):
        raise ValueError(
            f"slot address out of range: shard={shard} (<{MAX_SHARDS}), "
            f"group={group} (<{MAX_GROUPS}), slot={slot} (<{MAX_SLOTS})")
    return (shard << (GROUP_BITS + SLOT_BITS)) | (group << SLOT_BITS) | slot


def decode_slot(code):
    """Unpack wire code(s) -> (shard, group, slot); vectorized over
    ndarray inputs (the zero-per-record decode path)."""
    code = np.asarray(code, np.uint32)
    slot = code & (MAX_SLOTS - 1)
    group = (code >> SLOT_BITS) & (MAX_GROUPS - 1)
    shard = code >> (GROUP_BITS + SLOT_BITS)
    return shard, group, slot


# ---- frame construction (producer side) ------------------------------


def pack_rows(codes, values, deltas=0) -> bytes:
    """Vectorized row packing: aligned u32/f32/u16 arrays -> payload
    bytes. ``deltas`` broadcasts (0 = every row at base_ts)."""
    codes = np.asarray(codes, np.uint32)
    rows = np.empty(codes.shape[0], ROW_DTYPE)
    rows["slot"] = codes
    rows["value"] = np.asarray(values, np.float32)
    rows["dt"] = np.asarray(deltas, np.uint16)
    return rows.tobytes()


def build_frame(kind: int, payload: bytes, base_ts: int = 0,
                tenant: str = "", count: int | None = None,
                epoch: int = 0) -> bytes:
    """Assemble one wire frame. For DATA, ``payload`` is packed rows and
    ``count`` defaults to ``len(payload) // ROW_SIZE``; for NAMES/MAP the
    count IS the payload byte length. ``epoch`` is the map epoch the
    slot codes came from (0 = epoch-unaware, always admitted)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown frame kind {kind}")
    if not (0 <= epoch <= 0xFFFF):
        raise ValueError(f"epoch must fit u16; got {epoch}")
    tb = tenant.encode("utf-8")
    if len(tb) > 255:
        raise ValueError(f"tenant id exceeds 255 UTF-8 bytes: {tenant!r}")
    if kind == KIND_DATA:
        if len(payload) % ROW_SIZE:
            raise ValueError(
                f"DATA payload not a whole number of {ROW_SIZE}-byte rows")
        n = len(payload) // ROW_SIZE if count is None else count
        if n * ROW_SIZE != len(payload):
            raise ValueError("count does not match payload length")
        if n > MAX_DATA_ROWS:
            raise ValueError(f"frame exceeds MAX_DATA_ROWS ({MAX_DATA_ROWS})")
    else:
        n = len(payload)
        if n > MAX_BLOB_BYTES:
            raise ValueError(f"blob exceeds MAX_BLOB_BYTES ({MAX_BLOB_BYTES})")
    head = HEADER.pack(MAGIC, PROTOCOL_VERSION, kind, len(tb), epoch, n,
                       int(base_ts))
    body = head + tb + payload
    return body + CRC.pack(zlib.crc32(body[3:]))


def data_frame(codes, values, base_ts: int, deltas=0,
               tenant: str = "", epoch: int = 0) -> bytes:
    """One-call DATA frame from aligned arrays (the emitter hot path)."""
    return build_frame(KIND_DATA, pack_rows(codes, values, deltas),
                       base_ts=base_ts, tenant=tenant, epoch=epoch)


# ---- frame walker (consumer side) ------------------------------------


@dataclass
class Frame:
    """One validated frame. ``raw`` is the ONE copy made per frame (the
    walker's internal buffer is consumed after the scan); ``payload``
    is a zero-copy view into it. ``raw`` is what the write-ahead
    journal appends verbatim."""

    kind: int
    tenant: str
    count: int
    base_ts: int
    raw: bytes
    _poff: int
    epoch: int = 0

    @property
    def payload(self) -> memoryview:
        plen = self.count * ROW_SIZE if self.kind == KIND_DATA \
            else self.count
        return memoryview(self.raw)[self._poff:self._poff + plen]

    def rows(self) -> np.ndarray:
        """DATA payload as a structured [count] array (one frombuffer,
        zero per-record work)."""
        return np.frombuffer(self.payload, ROW_DTYPE, count=self.count)


def _frame_len(kind: int, tenant_len: int, count: int) -> int:
    payload = count * ROW_SIZE if kind == KIND_DATA else count
    return HEADER.size + tenant_len + payload + CRC.size


def scan_frames_py(buf) -> tuple[list[tuple], int, dict]:
    """Pure-Python walker: scan ``buf`` for complete frames.

    Returns ``(metas, consumed, stats)`` where each meta is
    ``(kind, version, epoch, tenant_off, tenant_len, count, base_ts,
    payload_off)``, ``consumed`` is how many leading bytes are fully
    scanned (valid frames, skipped frames, and garbage — never a
    trailing partial frame), and ``stats`` counts
    ``{garbage_bytes, bad_crc, version_skew}``. Semantics are pinned
    against the native walker by tests/test_torch_ingest_protocol.py.
    """
    # ONE copy up front: .find() for resync must not re-copy the tail
    # per step (garbage-dense input would go quadratic in the fallback)
    data = buf if isinstance(buf, bytes) else bytes(buf)
    n = len(data)
    metas: list[tuple] = []
    off = 0
    stats = {"garbage_bytes": 0, "bad_crc": 0, "version_skew": 0}

    def _resync(pos: int) -> int:
        """Skip to the next possible magic at/after pos+1 (counted)."""
        nxt = data.find(MAGIC, pos + 1)
        skip_to = nxt if nxt != -1 else max(pos + 1, n - (len(MAGIC) - 1))
        stats["garbage_bytes"] += skip_to - pos
        return skip_to

    while off + HEADER.size <= n:
        magic, version, kind, tlen, epoch, count, base_ts = \
            HEADER.unpack_from(data, off)
        sane = (magic == MAGIC
                and (count <= MAX_DATA_ROWS if kind == KIND_DATA
                     else count <= MAX_BLOB_BYTES))
        if not sane:
            off = _resync(off)
            continue
        end = off + _frame_len(kind, tlen, count)
        if end > n:
            break  # torn tail: wait for more bytes
        (crc,) = CRC.unpack_from(data, end - CRC.size)
        if crc != zlib.crc32(data[off + 3:end - CRC.size]):
            stats["bad_crc"] += 1
            off = _resync(off)
            continue
        if version != PROTOCOL_VERSION or kind not in _KINDS:
            # framing fields are frozen across versions: skip the whole
            # frame, counted — forward compatibility, not corruption
            stats["version_skew"] += 1
            off = end
            continue
        metas.append((kind, version, epoch, off + HEADER.size, tlen, count,
                      base_ts, off + HEADER.size + tlen))
        off = end
    return metas, off, stats


def _native_scan():
    """The C walker's scan callable, or None (no toolchain — callers
    fall back to :func:`scan_frames_py`). The library is built here, so a
    host without a compiler falls back at construction rather than on the
    first feed (the JAX package imports the callable without building it)."""
    try:
        from rtap_tpu_torch.native import frame_walker_scan, load_frame_walker

        load_frame_walker()
        return frame_walker_scan
    except Exception:
        return None


class FrameWalker:
    """Incremental stream -> frames: feed() recv chunks, get validated
    :class:`Frame` objects out. Owns one connection's remainder buffer
    (bounded — an unterminated garbage stream is dropped and counted,
    never an unbounded buffer).

    ``native=None`` auto-detects the C scanner (missing toolchain falls
    back to Python); ``True`` requires it; ``False`` forces Python.
    """

    #: remainder bound: the largest legal frame plus slack; beyond it
    #: the buffer cannot possibly complete into a valid frame we accept
    MAX_BUFFER = HEADER.size + 255 + MAX_DATA_ROWS * ROW_SIZE + CRC.size

    def __init__(self, native: bool | None = None):
        self._buf = bytearray()
        self.frames = 0
        self.garbage_bytes = 0
        self.bad_crc = 0
        self.version_skew = 0
        self._scan = None
        if native is not False:
            self._scan = _native_scan()
            if native and self._scan is None:
                raise RuntimeError("native frame walker unavailable")

    @property
    def native_active(self) -> bool:
        return self._scan is not None

    def feed(self, data: bytes) -> list[Frame]:
        # fast path: no remainder pending -> scan the recv chunk in
        # place (zero copy); only the torn tail is carried over
        if self._buf:
            self._buf += data
            view = memoryview(self._buf)
            buffered = True
        else:
            view = memoryview(data)
            buffered = False
        if self._scan is not None:
            metas, consumed, stats = self._scan(view)
        else:
            metas, consumed, stats = scan_frames_py(view)
        out = []
        for kind, _ver, epoch, toff, tlen, count, base_ts, poff in metas:
            plen = count * ROW_SIZE if kind == KIND_DATA else count
            start = toff - HEADER.size
            if tlen:
                try:
                    tenant = bytes(view[toff:toff + tlen]).decode("utf-8")
                except UnicodeDecodeError:
                    tenant = ""  # tenant is accounting, not routing
            else:
                tenant = ""
            out.append(Frame(kind, tenant, count, base_ts,
                             bytes(view[start:poff + plen + CRC.size]),
                             poff - start, epoch))
        self.frames += len(out)
        self.garbage_bytes += stats["garbage_bytes"]
        self.bad_crc += stats["bad_crc"]
        self.version_skew += stats["version_skew"]
        if buffered:
            del view
            del self._buf[:consumed]
        elif consumed < len(data):
            self._buf += view[consumed:]
        if len(self._buf) > self.MAX_BUFFER:
            # cannot complete into an acceptable frame: drop + resync
            self.garbage_bytes += len(self._buf)
            self._buf.clear()
        return out
