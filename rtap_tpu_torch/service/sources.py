"""Live metric sources for the serve loop.

The port's copy of the JAX package's ``service/sources.py`` JSONL sources.
Each source is a callable matching ``live_loop``'s contract —
``source(tick) -> (values [N] f32, ts unix-sec)`` — with one value per
registered stream id per tick and NaN for streams that sent nothing.

- :class:`HttpPollSource` — pull: polls one endpoint returning JSON
  ``{"ts": <unix>, "metrics": {"<stream_id>": <value>, ...}}``.
- :class:`TcpJsonlSource` — push: a background listener accepts JSONL
  records ``{"id": ..., "value": ..., "ts": ...}`` from any number of
  producers; each tick drains the latest value per stream.

Records are parsed on the listener's connection threads, which touch numpy
buffers only (every torch call stays on the loop's thread): by the native C
parser (``rtap_tpu_torch/native/jsonl_parser.c``, one locked C call per
recv chunk) when ``cc`` builds it, else in Python; ``native_active`` says
which. The binary batch source is ``rtap_tpu_torch.ingest.BinaryBatchSource``.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
import urllib.request

import numpy as np

from rtap_tpu_torch.obs import get_registry
from rtap_tpu_torch.resilience.policies import CircuitBreaker, Retry

__all__ = ["HttpPollSource", "TcpJsonlSource", "send_jsonl"]


class HttpPollSource:
    """Poll an HTTP metrics endpoint once per tick.

    Ids absent from a poll (or a failed poll) yield NaN for that tick: a
    live service keeps scoring the healthy streams when one exporter times
    out. Failed polls get bounded in-tick retry (`retry`, transport errors
    only) and a circuit breaker (`breaker`): after `fail_threshold`
    consecutive failures the endpoint is skipped outright (NaN tick, no
    network wait) until the cooldown passes. Short-circuited polls count in
    `polls_short_circuited`, not in `poll_failures`.

    `track_unknown=True` (serve --auto-register over HTTP): numeric metric
    keys that are not registered ids are remembered (bounded) as discovery
    candidates for :meth:`drain_unknown`.
    """

    #: same bound as TcpJsonlSource.MAX_UNKNOWN_TRACKED
    MAX_UNKNOWN_TRACKED = 4096

    def __init__(self, url: str, stream_ids: list[str], timeout_s: float = 0.5,
                 track_unknown: bool = False, retry=None, breaker=None):
        self.url = url
        self.stream_ids = list(stream_ids)
        self._known = set(self.stream_ids)
        self.timeout_s = timeout_s
        self.poll_failures = 0
        self.polls_short_circuited = 0
        # transport blips only, well under a 1 s cadence budget; a malformed
        # payload is the exporter's steady state, not retried
        self._retry = retry if retry is not None else Retry(
            attempts=2, base_delay_s=0.05, max_delay_s=0.25, op="http_poll")
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            fail_threshold=5, cooldown_s=30.0, name="http_poll")
        self._track_unknown = bool(track_unknown)
        self._unknown_seen: set[str] = set()
        self._obs_poll_failures = get_registry().counter(
            "rtap_obs_source_poll_failures_total",
            "HTTP metric polls that failed or timed out (whole-vector NaN "
            "ticks)")

    def _fetch(self) -> dict:
        with urllib.request.urlopen(self.url, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def __call__(self, tick: int) -> tuple[np.ndarray, int]:
        values = np.full(len(self.stream_ids), np.nan, np.float32)
        ts = int(time.time())
        if not self._breaker.allow():
            self.polls_short_circuited += 1
            return values, ts
        try:
            payload = self._retry.call(self._fetch, retry_on=(OSError,))
            metrics = payload.get("metrics", {})
            ts = int(payload.get("ts", ts))
            for i, sid in enumerate(self.stream_ids):
                v = metrics.get(sid)
                if v is None:
                    continue
                try:
                    values[i] = np.float32(v)
                except (TypeError, ValueError):
                    # one unconvertible metric is THAT stream's missing
                    # sample, not a poll failure
                    pass
            if self._track_unknown and isinstance(metrics, dict):
                for key, v in metrics.items():
                    if not isinstance(key, str) or key in self._known:
                        continue
                    # a candidate must carry a usable numeric value
                    try:
                        float(v)
                    except (TypeError, ValueError):
                        continue
                    if len(self._unknown_seen) < self.MAX_UNKNOWN_TRACKED:
                        self._unknown_seen.add(key)
            self._breaker.record_success()
        except Exception:
            # any failed poll is a whole-vector missing sample, counted
            self.poll_failures += 1
            self._obs_poll_failures.inc()
            self._breaker.record_failure()
        return values, ts

    def drain_unknown(self) -> list[str]:
        """Pop unregistered metric keys seen since the last drain (sorted:
        a deterministic registration order)."""
        seen = sorted(self._unknown_seen)
        self._unknown_seen.clear()
        return seen

    def set_ids(self, stream_ids: list[str]) -> None:
        """Adopt the registry's (possibly grown/shrunk) dispatch order."""
        self.stream_ids = list(stream_ids)
        self._known = set(self.stream_ids)


class TcpJsonlSource:
    """Push transport: listens on a TCP port for newline-delimited JSON
    records and keeps the latest value per stream; each tick snapshots and
    drains them.

    Start/stop with a context manager (or .start()/.close()). Record parse
    errors are counted, never raised (a malformed producer must not kill
    the scoring loop). ``native=None`` uses the C parser when it builds and
    Python otherwise; ``True`` requires it; ``False`` forces Python. Both
    paths count in the same order: an unknown id is checked before the
    value converts, the value is written before the ts converts, and a
    record counts as parsed only once both converted.
    """

    #: bound on remembered unknown-id names (track_unknown mode)
    MAX_UNKNOWN_TRACKED = 4096

    def __init__(self, stream_ids: list[str], host: str = "127.0.0.1", port: int = 0,
                 native: bool | None = None, track_unknown: bool = False):
        self.stream_ids = list(stream_ids)
        self._index = {sid: i for i, sid in enumerate(self.stream_ids)}
        self._latest = np.full(len(self.stream_ids), np.nan, np.float32)
        self._latest_ts = 0
        self._lock = threading.Lock()
        self._py_parse_errors = 0
        self._py_unknown_ids = 0
        self._py_records = 0
        self._track_unknown = bool(track_unknown)
        self._unknown_seen: set[str] = set()
        obs = get_registry()
        self._obs_synced = {"pe": 0, "uk": 0, "rec": 0}
        self._obs_parse_errors = obs.counter(
            "rtap_obs_ingest_parse_errors_total",
            "malformed JSONL records dropped by the TCP listener")
        self._obs_unknown_ids = obs.counter(
            "rtap_obs_ingest_unknown_ids_total",
            "records for unregistered stream ids (claim candidates under "
            "--auto-register, otherwise dropped)")
        self._obs_records = obs.counter(
            "rtap_obs_ingest_records_total",
            "successfully parsed ingest records (JSONL records and "
            "binary batch rows, both parser backends)")
        # the native parse state: one locked C call per recv chunk instead
        # of json.loads + dict lookup + lock per record
        self._nstate = None
        if native is not False:
            try:
                from rtap_tpu_torch.native import NativeJsonlState

                self._nstate = NativeJsonlState(self.stream_ids, self._latest,
                                                track_unknown=self._track_unknown)
            except Exception:
                if native:
                    raise
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                if outer._nstate is not None:
                    conn = outer._nstate.new_conn()
                    try:
                        while True:
                            data = self.connection.recv(65536)
                            if not data:
                                break
                            with outer._lock:
                                conn.feed(data)
                        with outer._lock:
                            conn.flush()  # unterminated final line, like rfile
                    finally:
                        conn.close()
                    return
                for line in self.rfile:
                    try:
                        rec = json.loads(line)
                        sid = rec["id"]
                        # index resolved under the SAME lock as the write:
                        # set_ids swaps (_index, _latest) together
                        with outer._lock:
                            i = outer._index.get(sid)
                            if i is None:
                                outer._py_unknown_ids += 1
                                if outer._track_unknown and isinstance(sid, str) and \
                                        len(outer._unknown_seen) < outer.MAX_UNKNOWN_TRACKED:
                                    outer._unknown_seen.add(sid)
                                continue
                            outer._latest[i] = np.float32(rec["value"])
                            outer._latest_ts = max(outer._latest_ts, int(rec.get("ts", 0)))
                            # counted after the ts converted: a bad ts keeps
                            # the value but is a parse error (the C order)
                            outer._py_records += 1
                    except Exception:
                        # any malformed record is counted and dropped
                        with outer._lock:
                            outer._py_parse_errors += 1

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address  # (host, bound port)
        # a 0.05 s accept poll: close() returns within it (the default
        # 0.5 s held every serve's exit that long)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        name="rtap-sources-accept", daemon=True)

    def start(self) -> "TcpJsonlSource":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "TcpJsonlSource":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def parse_errors(self) -> int:
        n = int(self._nstate.counters[1]) if self._nstate is not None else 0
        return self._py_parse_errors + n

    @property
    def unknown_ids(self) -> int:
        n = int(self._nstate.counters[2]) if self._nstate is not None else 0
        return self._py_unknown_ids + n

    @property
    def records_parsed(self) -> int:
        """Successful records on both parser backends."""
        n = int(self._nstate.counters[0]) if self._nstate is not None else 0
        return self._py_records + n

    @property
    def native_active(self) -> bool:
        return self._nstate is not None

    def drain_unknown(self) -> list[str]:
        """Pop the unknown-id names seen since the last drain (sorted).
        Empty unless track_unknown."""
        if not self._track_unknown:
            return []
        with self._lock:
            if self._nstate is not None:
                for sid in self._nstate.drain_unknown_names():
                    if len(self._unknown_seen) < self.MAX_UNKNOWN_TRACKED:
                        self._unknown_seen.add(sid)
            seen = sorted(self._unknown_seen)
            self._unknown_seen.clear()
        return seen

    def set_ids(self, stream_ids: list[str]) -> None:
        """Replace the accepted id set (registry membership changed).
        Latest values carry over by id; new ids start at NaN; the snapshot
        order is the caller's (the registry's dispatch order). The native
        table swaps under the lock that serializes feed(), so a connection's
        partial line survives and its next line sees the new table."""
        with self._lock:
            latest = np.full(len(stream_ids), np.nan, np.float32)
            for j, sid in enumerate(stream_ids):
                i = self._index.get(sid)
                if i is not None:
                    latest[j] = self._latest[i]
            if self._nstate is not None:
                self._nstate.set_table(stream_ids, latest)
            self.stream_ids = list(stream_ids)
            self._index = {sid: i for i, sid in enumerate(self.stream_ids)}
            self._latest = latest

    def __call__(self, tick: int) -> tuple[np.ndarray, int]:
        """Snapshot AND DRAIN: values reset to NaN after each tick, so a
        producer that stops pushing yields missing samples rather than its
        stale last value being re-scored forever."""
        with self._lock:
            values = self._latest.copy()
            self._latest[:] = np.nan
            if self._nstate is not None:
                self._latest_ts = max(self._latest_ts, int(self._nstate.ts_buf[0]))
            ts = self._latest_ts or int(time.time())
        # once-per-tick delta sync of THIS instance's tallies into the
        # process-global counters (two sources over a process lifetime sum);
        # each tally is read once, as the handler threads keep bumping it
        for key, counter, n in (("pe", self._obs_parse_errors, self.parse_errors),
                                ("uk", self._obs_unknown_ids, self.unknown_ids),
                                ("rec", self._obs_records, self.records_parsed)):
            counter.inc(max(0, n - self._obs_synced[key]))
            self._obs_synced[key] = n
        return values, ts


#: records per sendall — bounds what one mid-stream connection drop can
#: leave in doubt (the failing batch is retried; earlier batches are known
#: delivered)
_SEND_BATCH = 512


def send_jsonl(address: tuple[str, int], records: list[dict], retry=None) -> int:
    """Producer-side helper: push records to a :class:`TcpJsonlSource`
    listener -> the count handed to the kernel. The connection is retried
    with bounded exponential backoff (`retry`; default 4 attempts); the
    batch in flight when a connection dropped is resent whole
    (at-least-once, harmless against latest-value-per-stream)."""
    if retry is None:
        retry = Retry(attempts=4, base_delay_s=0.05, max_delay_s=0.5, op="send_jsonl")
    payloads = ["".join(json.dumps(r) + "\n" for r in records[i:i + _SEND_BATCH]).encode()
                for i in range(0, len(records), _SEND_BATCH)]
    sizes = [min(_SEND_BATCH, len(records) - i) for i in range(0, len(records), _SEND_BATCH)]
    delivered = 0
    next_batch = 0
    for attempt in range(1, retry.attempts + 1):
        try:
            with socket.create_connection(address, timeout=2.0) as s:
                while next_batch < len(payloads):
                    s.sendall(payloads[next_batch])
                    delivered += sizes[next_batch]
                    next_batch += 1
            return delivered
        except OSError:
            if attempt == retry.attempts:
                return delivered
            retry.backoff(attempt)
    return delivered
