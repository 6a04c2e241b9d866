"""Producer-side binary ingest helpers — ``send_jsonl``'s wire-speed twin.

:func:`send_binary` keeps send_jsonl's exact calling convention (records
as ``{"id", "value", "ts"}`` dicts, returns the delivered count, bounded
retry) so the soak feeders and tests can switch transports with a flag;
:class:`BinaryFeedConnection` is the persistent-connection form the
paced live_soak feeder uses (connect once, push one vectorized frame
per tick — no per-record Python on the producer either).

Both learn the id -> slot-code map from the listener itself: a
:class:`~rtap_tpu_torch.ingest.server.BinaryBatchSource` greets every
connection with a MAP frame, and an empty MAP frame re-requests it
(after serve --auto-register claims announced NAMES).
"""

from __future__ import annotations

import json
import socket

import numpy as np

from rtap_tpu_torch.ingest.protocol import (
    KIND_MAP,
    KIND_NAMES,
    FrameWalker,
    build_frame,
    data_frame,
)

#: rows per DATA frame — bounds what one mid-stream connection drop can
#: leave in doubt, like send_jsonl's _SEND_BATCH
_SEND_BATCH = 4096


class BinaryFeedConnection:
    """One persistent producer connection: MAP handshake, vectorized
    DATA frames, NAMES announcements, MAP refresh."""

    def __init__(self, address, timeout_s: float = 5.0, tenant: str = ""):
        self.tenant = tenant
        self._sock = socket.create_connection(address, timeout=timeout_s)
        self._walker = FrameWalker(native=False)  # map frames are rare
        self.code_of: dict[str, int] = {}
        self.epoch = 0  # the map's epoch; stamped into every DATA frame
        # so the listener can refuse frames built from a stale map
        self.leader_hint: str | None = None  # "host:port" of the NEW
        # leader, when the listener we are talking to lost a failover
        # (the __leader__ MAP field); send_binary follows it
        self._read_map()

    def _adopt_map(self, fr) -> None:
        blob = json.loads(bytes(fr.payload))
        self.epoch = int(blob.pop("__epoch__", 0))
        hint = blob.pop("__leader__", None)
        if hint:
            self.leader_hint = str(hint)
        self.code_of = {k: int(v) for k, v in blob.items()}

    def _read_map(self) -> None:
        # the constructor's timeout governs every wait on this socket —
        # map reads must not shorten a caller's stall tolerance
        while True:
            data = self._sock.recv(1 << 16)
            if not data:
                raise ConnectionError("listener closed before MAP frame")
            # adopt EVERY map of the chunk, in order: a push sent right
            # after the hello may share its recv, and returning at the first
            # map would drop it (the JAX producer does; the port ends on
            # the newest)
            adopted = False
            for fr in self._walker.feed(data):
                if fr.kind == KIND_MAP and fr.count:
                    self._adopt_map(fr)
                    adopted = True
            if adopted:
                return

    def refresh_map(self) -> None:
        """Re-request the map (e.g. after NAMES announcements were
        claimed by serve --auto-register)."""
        self._sock.sendall(build_frame(KIND_MAP, b""))
        self._read_map()

    def poll_map(self) -> bool:
        """Drain any MAP frames the listener PUSHED (it pushes on every
        membership change, so epochs propagate without a request) ->
        True if the map changed. Non-blocking; call before each send so
        a fleet-wide epoch bump elsewhere never leaves this producer
        stamping a stale epoch."""
        changed = False
        prev_timeout = self._sock.gettimeout()
        self._sock.setblocking(False)
        try:
            while True:
                try:
                    data = self._sock.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    break
                if not data:
                    raise ConnectionError("listener closed")
                for fr in self._walker.feed(data):
                    if fr.kind == KIND_MAP and fr.count:
                        self._adopt_map(fr)
                        changed = True
        finally:
            self._sock.settimeout(prev_timeout)
        return changed

    def send_names(self, ids) -> None:
        """Announce unknown stream ids (the auto-register protocol)."""
        blob = "\n".join(ids).encode("utf-8")
        self._sock.sendall(build_frame(KIND_NAMES, blob, tenant=self.tenant))

    def send_rows(self, ids, values, ts: int, deltas=0) -> int:
        """Push one frame of aligned (ids, values) at base timestamp
        ``ts``; unknown ids are skipped (returned count = rows sent)."""
        codes = np.array([self.code_of.get(s, -1) for s in ids], np.int64)
        known = codes >= 0
        n = int(known.sum())
        if n:
            self._sock.sendall(data_frame(
                codes[known].astype(np.uint32),
                np.asarray(values, np.float32)[known], ts,
                deltas=np.broadcast_to(
                    np.asarray(deltas, np.uint16), codes.shape)[known],
                tenant=self.tenant, epoch=self.epoch))
        return n

    def send_frame(self, frame: bytes) -> None:
        self._sock.sendall(frame)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "BinaryFeedConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _split_by_ts_span(batch) -> list[tuple[list, int]]:
    """Cut a record batch into (sub-batch, base_ts) runs whose
    timestamps fit the u16 row delta — a backfill batch spanning more
    than ~18 h must be delivered with exact timestamps across several
    frames, never clamped hours wrong. Order is preserved (latest-wins
    routing depends on it). Records without a ts adopt the running
    sub-batch's base (one ts-less record must not drag a batch's base
    to 0 and wreck every real timestamp)."""
    out: list[tuple[list, int]] = []
    cur: list = []
    lo = hi = None
    for r in batch:
        ts = int(r["ts"]) if "ts" in r else None
        if ts is None:
            cur.append(r)
            continue
        nlo = ts if lo is None else min(lo, ts)
        nhi = ts if hi is None else max(hi, ts)
        if nhi - nlo > 65535 and cur:
            out.append((cur, lo if lo is not None else 0))
            cur, lo, hi = [], ts, ts
        else:
            lo, hi = nlo, nhi
        cur.append(r)
    if cur:
        out.append((cur, lo if lo is not None else 0))
    return out


def send_binary(address, records, retry=None, tenant: str = "") -> int:
    """send_jsonl's binary twin: push ``{"id", "value", "ts"}`` records
    to a BinaryBatchSource listener -> count handed to the kernel.

    Ids absent from the listener's map are announced in a NAMES frame
    (claim candidates under --auto-register) and do NOT count as
    delivered — the caller retries them next call, by which time the
    fresh connection's MAP reflects any claims. Connection failures get
    bounded exponential backoff like send_jsonl; delivery is
    at-least-once across retries (harmless against latest-wins rows).
    """
    from rtap_tpu_torch.resilience.policies import Retry

    if retry is None:
        retry = Retry(attempts=4, base_delay_s=0.05, max_delay_s=0.5,
                      op="send_binary")
    delivered = 0
    sent_names = False
    next_batch = 0
    redirected = False
    batches = [records[i:i + _SEND_BATCH]
               for i in range(0, len(records), _SEND_BATCH)]
    attempt = 0
    while attempt < retry.attempts:
        try:
            with BinaryFeedConnection(address, tenant=tenant) as conn:
                if conn.leader_hint and not redirected:
                    # the listener lost a failover and named its
                    # successor: re-point ONCE — the hinted
                    # leader's own map is authoritative from here on.
                    # A successful control exchange, NOT a failure: it
                    # must not burn a retry attempt (a hint on the last
                    # attempt still gets its shot at the new leader)
                    host, _sep, port = conn.leader_hint.rpartition(":")
                    if host and port.isdigit():
                        address = (host, int(port))
                        redirected = True
                        continue
                if not sent_names:
                    unknown = sorted({str(r["id"]) for r in records
                                      if r["id"] not in conn.code_of})
                    if unknown:
                        conn.send_names(unknown)
                        sent_names = True
                while next_batch < len(batches):
                    batch = batches[next_batch]
                    sent = 0
                    for sub, ts0 in _split_by_ts_span(batch):
                        sent += conn.send_rows(
                            [r["id"] for r in sub],
                            [r["value"] for r in sub], ts0,
                            deltas=[int(r.get("ts", ts0)) - ts0
                                    for r in sub])
                    # counted only once the WHOLE batch went out: a
                    # drop mid-batch resends it whole (at-least-once,
                    # harmless vs latest-wins) without double-counting
                    delivered += sent
                    next_batch += 1
            return delivered
        except OSError:
            attempt += 1
            if attempt >= retry.attempts:
                return delivered
            retry.backoff(attempt)
    return delivered
