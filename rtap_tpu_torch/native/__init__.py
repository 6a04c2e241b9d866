"""Native host parsers (C, loaded with ctypes): the JSONL metrics parser of
the TCP push listener (``jsonl_parser.c``) and the RB1 binary-ingest frame
walker (``frame_walker.c``).

The port's copy of the JAX package's ``native/`` loader, over the port's own
copies of the two C sources. Each library is compiled on first use with the
system ``cc`` (``ops/_build.build_host_c``: ``-O2 -shared -fPIC -std=c99``)
into ``rtap_tpu_torch/_build/``, named by a hash of its source, through a
temp file and an atomic rename, so concurrent processes may race the build.
These are host code, not device kernels: callers treat an ImportError or
OSError from the loaders as "native path unavailable" and fall back to pure
Python, as the JAX package does; the service runs (slower) on a host
without a toolchain.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "jsonl_parser.c"
_FW_SRC = _DIR / "frame_walker.c"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fw_lib: ctypes.CDLL | None = None


def _build(src: Path) -> str:
    from rtap_tpu_torch.ops._build import build_host_c

    return str(build_host_c(src))


def load() -> ctypes.CDLL:
    """The parser library, compiling it first if missing or stale.
    Raises on any failure (no toolchain, compile error) — callers fall
    back to the pure-Python parser."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build(_SRC))
        lib.rtap_parser_new.restype = ctypes.c_void_p
        lib.rtap_parser_new.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.rtap_parser_clone.restype = ctypes.c_void_p
        lib.rtap_parser_clone.argtypes = [ctypes.c_void_p]
        lib.rtap_parser_free_clone.restype = None
        lib.rtap_parser_free_clone.argtypes = [ctypes.c_void_p]
        lib.rtap_parser_free_owner.restype = None
        lib.rtap_parser_free_owner.argtypes = [ctypes.c_void_p]
        f64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.rtap_parser_set_table.restype = ctypes.c_int
        lib.rtap_parser_set_table.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32]
        lib.rtap_parser_feed.restype = ctypes.c_int
        lib.rtap_parser_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, f32p, f64p, f64p,
            u8p, f64p, ctypes.c_long]
        lib.rtap_parser_flush.restype = None
        lib.rtap_parser_flush.argtypes = [
            ctypes.c_void_p, f32p, f64p, f64p, u8p, f64p, ctypes.c_long]
        _lib = lib
        return _lib


class NativeJsonlState:
    """Listener-wide native parse state: the id hash table plus the shared
    output buffers the C code writes into.

    ``latest`` is the caller's float32 [G] array — feed() updates it in
    place (the caller must never reallocate it). ``counters`` is
    [parsed, parse_errors, unknown_ids]; ``ts_buf[0]`` is the running ts
    maximum. One :class:`ConnParser` per connection carries that
    connection's partial-line remainder; the caller serializes feed()
    calls across connections with its own lock.
    """

    #: unknown-name capture buffer ("id\\n" entries; full = drop, Python
    #: dedups and the id re-surfaces next tick)
    UNKNOWN_BUF_BYTES = 1 << 16

    def __init__(self, stream_ids: list[str], latest: np.ndarray,
                 track_unknown: bool = False):
        if latest.dtype != np.float32 or not latest.flags.c_contiguous:
            raise ValueError("latest must be a C-contiguous float32 array")
        self._lib = load()
        ids = [sid.encode() for sid in stream_ids]
        blob = b"".join(ids)
        lens = (ctypes.c_int32 * len(ids))(*[len(b) for b in ids])
        self._owner = self._lib.rtap_parser_new(blob, lens, len(ids))
        if not self._owner:
            raise MemoryError("rtap_parser_new failed")
        self.latest = latest
        self.ts_buf = np.zeros(1, np.int64)
        self.counters = np.zeros(3, np.int64)
        self.unk_buf = np.zeros(self.UNKNOWN_BUF_BYTES, np.uint8)
        # cap 0 disables capture in C (no memcpy on the hot locked path
        # when nothing will ever drain the buffer)
        self.unk_cap = self.UNKNOWN_BUF_BYTES if track_unknown else 0
        self.unk_cur = np.zeros(1, np.int64)

    def new_conn(self) -> "ConnParser":
        return ConnParser(self)

    def set_table(self, stream_ids: list[str], latest: np.ndarray) -> None:
        """Swap the id table + output array (registry membership changed).
        The caller must hold the listener lock that serializes feed() —
        every per-connection parser observes the new table on its next
        line via the shared indirection; partial-line state survives."""
        if latest.dtype != np.float32 or not latest.flags.c_contiguous:
            raise ValueError("latest must be a C-contiguous float32 array")
        ids = [sid.encode() for sid in stream_ids]
        blob = b"".join(ids)
        lens = (ctypes.c_int32 * len(ids))(*[len(b) for b in ids])
        if self._lib.rtap_parser_set_table(self._owner, blob, lens, len(ids)):
            raise MemoryError("rtap_parser_set_table failed")
        self.latest = latest

    def drain_unknown_names(self) -> list[str]:
        """Pop captured unknown-id names (caller holds the listener lock).

        Strict UTF-8: invalid-byte ids are dropped — a name that cannot
        round-trip to its wire bytes would register a permanently
        valueless model (the C side already skips escaped ids for the
        same must-match-json.loads reason)."""
        n = int(self.unk_cur[0])
        if n == 0:
            return []
        raw = bytes(self.unk_buf[:n])
        self.unk_cur[0] = 0
        out = []
        for s in raw.split(b"\n"):
            if not s:
                continue
            try:
                out.append(s.decode("utf-8"))
            except UnicodeDecodeError:
                pass
        return out

    def __del__(self):
        owner = getattr(self, "_owner", None)
        if owner:
            self._lib.rtap_parser_free_owner(owner)
            self._owner = None


class ConnParser:
    """Per-connection parser (owns the partial-line remainder)."""

    def __init__(self, state: NativeJsonlState):
        self._state = state
        self._h = state._lib.rtap_parser_clone(state._owner)
        if not self._h:
            raise MemoryError("rtap_parser_clone failed")

    def feed(self, data: bytes) -> None:
        st = self._state
        st._lib.rtap_parser_feed(self._h, data, len(data),
                                 st.latest, st.ts_buf, st.counters,
                                 st.unk_buf, st.unk_cur, st.unk_cap)

    def flush(self) -> None:
        st = self._state
        st._lib.rtap_parser_flush(self._h, st.latest, st.ts_buf, st.counters,
                                  st.unk_buf, st.unk_cur, st.unk_cap)

    def close(self) -> None:
        if self._h:
            self._state._lib.rtap_parser_free_clone(self._h)
            self._h = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------
# RB1 frame walker (frame_walker.c) — the binary-ingest scan fast path
# ---------------------------------------------------------------------

#: frames per C scan call; the wrapper loops, so this only bounds the
#: meta array allocation, not throughput
_FW_CAP = 4096


def load_frame_walker() -> ctypes.CDLL:
    """The frame-walker library, compiling it first if missing or
    stale. Raises on any failure — callers fall back to the pure-Python
    walker (rtap_tpu_torch/ingest/protocol.py)."""
    global _fw_lib
    with _lock:
        if _fw_lib is not None:
            return _fw_lib
        lib = ctypes.CDLL(_build(_FW_SRC))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.rtap_fw_scan.restype = ctypes.c_longlong
        lib.rtap_fw_scan.argtypes = [
            u8p, ctypes.c_longlong, i64p, ctypes.c_longlong, i64p]
        _fw_lib = lib
        return _fw_lib


_fw_tls = threading.local()  # reused per-thread scan buffers (the scan
# runs per recv chunk on the ingest hot path; a fresh 224 KiB meta
# allocation per chunk was measurable)


def frame_walker_scan(buf) -> tuple[list[tuple], int, dict]:
    """Native twin of protocol.scan_frames_py: scan ``buf`` (bytes-like)
    for complete RB1 frames -> (metas, consumed, stats), zero-copy over
    the caller's buffer. Loops the C scanner past its per-call frame
    cap so semantics match the uncapped Python walker exactly
    (parity-pinned)."""
    lib = load_frame_walker()
    out = getattr(_fw_tls, "out", None)
    if out is None:
        out = _fw_tls.out = np.empty(_FW_CAP * 8, np.int64)
        _fw_tls.stats = np.empty(4, np.int64)
    raw_stats = _fw_tls.stats
    data = np.frombuffer(buf, np.uint8)
    metas: list[tuple] = []
    stats = {"garbage_bytes": 0, "bad_crc": 0, "version_skew": 0}
    base = 0
    while True:
        raw_stats[:3] = 0
        n = int(lib.rtap_fw_scan(data[base:], len(data) - base, out,
                                 _FW_CAP, raw_stats))
        for i in range(n):
            kind, ver, epoch, toff, tlen, count, base_ts, poff = \
                out[i * 8:i * 8 + 8]
            metas.append((int(kind), int(ver), int(epoch), base + int(toff),
                          int(tlen), int(count), int(base_ts),
                          base + int(poff)))
        stats["garbage_bytes"] += int(raw_stats[0])
        stats["bad_crc"] += int(raw_stats[1])
        stats["version_skew"] += int(raw_stats[2])
        base += int(raw_stats[3])
        if n < _FW_CAP:
            return metas, base, stats
