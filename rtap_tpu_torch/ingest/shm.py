"""Shared-memory frame ring: the co-located exporter transport.

An exporter on the SAME host should not pay the socket stack to hand
frames to serve. The ring is a single-producer single-consumer byte
queue in POSIX shared memory carrying the exact same ``RB1`` frames as
the socket path (protocol.py) — the consumer drains it straight into
the same frame walker, so every validation/admission rule is shared.

Layout (little-endian, 64-byte header)::

    0   8   magic    b"RBSHRING"
    8   8   capacity data-region bytes
    16  8   head     producer write cursor (monotonic byte count)
    24  8   tail     consumer read cursor (monotonic byte count)
    32  32  reserved
    64  ..  data     ring bytes (frames wrap byte-wise)

``head``/``tail`` are monotonic u64s; ``head - tail`` is the unread
byte count. The producer refuses (returns False) when a frame does not
fit — drop-newest at the transport, counted by the producer; the
consumer's admission control owns the drop-oldest policy above this.

Memory-ordering contract: cursor updates are 8-byte aligned stores
issued AFTER the data bytes, which is safe cross-process on
total-store-order hosts (x86/x86-64 — every deployment target today).
On weakly-ordered architectures (ARM64) a consumer could observe a
cursor before the bytes it covers; the CRC framing DETECTS that (the
walker counts the torn read as garbage/bad-CRC, never accepts it) but
the affected frame is lost — co-located exporters on such hosts should
use the socket transport until a fenced ring lands (docs/INGEST.md).
One producer and one consumer per ring; multi-producer setups run one
ring per producer.
"""

from __future__ import annotations

import struct
from multiprocessing import shared_memory

_MAGIC = b"RBSHRING"
_HDR = 64
_U64 = struct.Struct("<Q")


class ShmRing:
    """Create or attach one frame ring. The creator owns unlink()."""

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self._shm = shm
        self._owner = owner
        buf = shm.buf
        if bytes(buf[:8]) != _MAGIC:
            raise ValueError(
                f"shm segment {shm.name!r} is not an RB ring (bad magic)")
        (self.capacity,) = _U64.unpack_from(buf, 8)
        if _HDR + self.capacity > len(buf):
            raise ValueError(f"shm segment {shm.name!r} truncated")
        self.pushed = 0
        self.push_rejected = 0  # frames that did not fit (producer side)

    # ---- lifecycle ---------------------------------------------------
    @classmethod
    def create(cls, name: str, capacity: int = 8 << 20) -> "ShmRing":
        if capacity < 4096:
            raise ValueError(f"ring capacity must be >= 4096; got {capacity}")
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=_HDR + capacity)
        shm.buf[:_HDR] = bytes(_HDR)
        shm.buf[:8] = _MAGIC
        _U64.pack_into(shm.buf, 8, capacity)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=name)
        # CPython < 3.13 registers EVERY SharedMemory with the process's
        # resource_tracker, owner or not — an attaching exporter exiting
        # would unlink the ring out from under serve (and every future
        # attacher). Only the creator may own the name's lifetime.
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # the tracker API
            # moved (3.13+ track=False) or absent; unregister is a
            # CPython-version workaround, never load-bearing
            pass
        return cls(shm, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        try:
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except (OSError, FileNotFoundError):
            pass  # teardown of an already-vanished ring (peer unlinked)

    # ---- cursors -----------------------------------------------------
    def _head(self) -> int:
        return _U64.unpack_from(self._shm.buf, 16)[0]

    def _tail(self) -> int:
        return _U64.unpack_from(self._shm.buf, 24)[0]

    @property
    def unread_bytes(self) -> int:
        return self._head() - self._tail()

    # ---- producer ----------------------------------------------------
    def push(self, frame: bytes) -> bool:
        """Append one frame's bytes; False (counted) when it does not
        fit — the producer decides whether to retry next tick."""
        n = len(frame)
        head, tail = self._head(), self._tail()
        if n > self.capacity - (head - tail):
            self.push_rejected += 1
            return False
        pos = head % self.capacity
        first = min(n, self.capacity - pos)
        buf = self._shm.buf
        buf[_HDR + pos:_HDR + pos + first] = frame[:first]
        if first < n:
            buf[_HDR:_HDR + n - first] = frame[first:]
        # cursor store strictly after the data: the consumer never
        # observes a head covering bytes it cannot read
        _U64.pack_into(buf, 16, head + n)
        self.pushed += 1
        return True

    # ---- consumer ----------------------------------------------------
    def drain(self, max_bytes: int = 1 << 22) -> bytes:
        """Pop up to max_bytes of unread ring bytes (possibly mid-frame;
        the frame walker owns reassembly)."""
        head, tail = self._head(), self._tail()
        n = min(head - tail, max_bytes)
        if n <= 0:
            return b""
        pos = tail % self.capacity
        first = min(n, self.capacity - pos)
        buf = self._shm.buf
        out = bytes(buf[_HDR + pos:_HDR + pos + first])
        if first < n:
            out += bytes(buf[_HDR:_HDR + n - first])
        _U64.pack_into(buf, 24, tail + n)
        return out
