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

Records are parsed in Python on the listener's connection threads, which
touch numpy buffers only (every torch call stays on the loop's thread).
The JAX package's native C parser and its binary batch ingest are not
ported: ``native_active`` is always False.
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
    the scoring loop).
    """

    #: bound on remembered unknown-id names (track_unknown mode)
    MAX_UNKNOWN_TRACKED = 4096
    #: the JSONL records are parsed in Python; the native C parser is not ported
    native_active = False

    def __init__(self, stream_ids: list[str], host: str = "127.0.0.1", port: int = 0,
                 track_unknown: bool = False):
        self.stream_ids = list(stream_ids)
        self._index = {sid: i for i, sid in enumerate(self.stream_ids)}
        self._latest = np.full(len(self.stream_ids), np.nan, np.float32)
        self._latest_ts = 0
        self._lock = threading.Lock()
        self.parse_errors = 0
        self.unknown_ids = 0
        self.records_parsed = 0
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
            "successfully parsed ingest records")
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    try:
                        rec = json.loads(line)
                        sid = rec["id"]
                        # index resolved under the SAME lock as the write:
                        # set_ids swaps (_index, _latest) together. The
                        # unknown check precedes value conversion, and the
                        # value write precedes the ts conversion (a bad ts
                        # counts a parse error but keeps the value), as in
                        # the JAX package.
                        with outer._lock:
                            i = outer._index.get(sid)
                            if i is None:
                                outer.unknown_ids += 1
                                if outer._track_unknown and isinstance(sid, str) and \
                                        len(outer._unknown_seen) < outer.MAX_UNKNOWN_TRACKED:
                                    outer._unknown_seen.add(sid)
                                continue
                            outer._latest[i] = np.float32(rec["value"])
                            outer._latest_ts = max(outer._latest_ts, int(rec.get("ts", 0)))
                            outer.records_parsed += 1
                    except Exception:
                        # any malformed record is counted and dropped
                        with outer._lock:
                            outer.parse_errors += 1

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address  # (host, bound port)
        self._thread = threading.Thread(target=self._server.serve_forever,
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

    def drain_unknown(self) -> list[str]:
        """Pop the unknown-id names seen since the last drain (sorted).
        Empty unless track_unknown."""
        if not self._track_unknown:
            return []
        with self._lock:
            seen = sorted(self._unknown_seen)
            self._unknown_seen.clear()
        return seen

    def set_ids(self, stream_ids: list[str]) -> None:
        """Replace the accepted id set (registry membership changed).
        Latest values carry over by id; new ids start at NaN; the snapshot
        order is the caller's (the registry's dispatch order)."""
        with self._lock:
            latest = np.full(len(stream_ids), np.nan, np.float32)
            for j, sid in enumerate(stream_ids):
                i = self._index.get(sid)
                if i is not None:
                    latest[j] = self._latest[i]
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
            ts = self._latest_ts or int(time.time())
            tallies = {"pe": self.parse_errors, "uk": self.unknown_ids,
                       "rec": self.records_parsed}
        # once-per-tick delta sync of THIS instance's tallies into the
        # process-global counters (two sources over a process lifetime sum)
        for key, counter in (("pe", self._obs_parse_errors),
                             ("uk", self._obs_unknown_ids),
                             ("rec", self._obs_records)):
            counter.inc(max(0, tallies[key] - self._obs_synced[key]))
            self._obs_synced[key] = tallies[key]
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
