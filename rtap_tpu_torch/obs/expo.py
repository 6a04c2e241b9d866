"""Telemetry exposition: Prometheus v0 text + JSONL snapshots + HTTP server.

The port's copy of the JAX package's ``obs/expo.py`` (the same text
format byte for byte, the same routes, the fleet aggregator's ``/fleet/*``
ones included). Two consumption shapes, one registry (obs/metrics.py):

- **Pull**: :class:`ExpositionServer` serves ``GET /metrics`` (Prometheus
  text format 0.0.4) and ``GET /snapshot`` (one JSON object) from a
  background thread on a localhost TCP port — the same ephemeral-port,
  ``.address``, context-manager style as the serve path's TcpJsonlSource.
- **File**: :func:`write_snapshot` appends one JSON line per call — the
  no-network surface (a session runner points children at a per-step
  snapshot path via ``RTAP_OBS_SNAPSHOT`` and reads the last line back
  instead of scraping stdout).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from rtap_tpu_torch.obs.metrics import TelemetryRegistry, get_registry

__all__ = [
    "ExpositionServer",
    "default_snapshot_path",
    "read_last_snapshot",
    "render_prometheus",
    "summarize_snapshot",
    "write_snapshot",
]

#: children inherit this from a session runner: the
#: default file the final snapshot lands in when no explicit path is given
SNAPSHOT_ENV = "RTAP_OBS_SNAPSHOT"


def default_snapshot_path() -> str | None:
    return os.environ.get(SNAPSHOT_ENV) or None


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as integers."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labelstr(labels: dict[str, str], extra: tuple[str, str] | None = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\""))
        for k, v in items
    )
    return "{%s}" % body


def render_prometheus(registry: TelemetryRegistry | None = None) -> str:
    """The registry as Prometheus text exposition format 0.0.4.

    Counters/gauges are one sample per (name, labels); histograms expand to
    the standard cumulative ``_bucket{le=...}`` series plus ``_sum`` and
    ``_count``. Families (shared name, distinct labels) share one
    HELP/TYPE header.
    """
    registry = registry or get_registry()
    lines: list[str] = []
    seen_header: set[str] = set()
    for inst in registry.collect():
        if inst.name not in seen_header:
            seen_header.add(inst.name)
            help_text = registry.help_for(inst.name)
            if help_text:
                lines.append("# HELP %s %s" % (
                    inst.name,
                    help_text.replace("\\", r"\\").replace("\n", r"\n")))
            lines.append("# TYPE %s %s" % (inst.name, inst.kind))
        if inst.kind == "histogram":
            merged = inst._merged()
            cum = 0
            for edge, c in zip(inst.edges, merged.counts):
                cum += int(c)
                lines.append("%s_bucket%s %s" % (
                    inst.name, _labelstr(inst.labels, ("le", _fmt(edge))),
                    cum))
            total = cum + int(merged.counts[-1])
            lines.append("%s_bucket%s %s" % (
                inst.name, _labelstr(inst.labels, ("le", "+Inf")), total))
            lines.append("%s_sum%s %s" % (
                inst.name, _labelstr(inst.labels), _fmt(merged.sum)))
            lines.append("%s_count%s %s" % (
                inst.name, _labelstr(inst.labels), total))
        else:
            lines.append("%s%s %s" % (
                inst.name, _labelstr(inst.labels), _fmt(inst.value)))
    return "\n".join(lines) + "\n"


def write_snapshot(path: str | None = None,
                   registry: TelemetryRegistry | None = None) -> dict | None:
    """Append one JSON snapshot line to `path` (default: $RTAP_OBS_SNAPSHOT;
    no-op returning None when neither is set). Returns the snapshot dict.

    The append is tmp-file + atomic rename (read the existing bytes,
    write them plus the new line to a temp sibling, ``os.replace``):
    a scraper or soak harness polling the file mid-write can never read
    a torn half-line — the same discipline as postmortem bundles and
    the correlator sidecar. Snapshot files are one line per serve exit
    (plus per-step session lines), so the copy is a few KB, not a log.
    """
    path = path or default_snapshot_path()
    if not path:
        return None
    snap = (registry or get_registry()).snapshot()
    line = (json.dumps(snap) + "\n").encode()
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # an flock sidecar serializes concurrent writers (two serve
    # processes sharing an ambient $RTAP_OBS_SNAPSHOT — e.g. an HA
    # pair on one host — must not read-modify-replace over each other
    # and silently drop an exit line the old O_APPEND write kept)
    import fcntl

    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            with open(path, "rb") as f:
                prior = f.read()
            if prior and not prior.endswith(b"\n"):
                prior += b"\n"  # heal a torn pre-atomic writer's tail
        except FileNotFoundError:
            prior = b""
        except OSError:
            # the file EXISTS but won't read (transient EIO/EACCES):
            # fall back to a plain append — a possibly-torn extra line
            # beats replacing the accumulated history with nothing
            with open(path, "ab") as f:
                f.write(line)
            return snap
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(prior + line)
        os.replace(tmp, path)
    return snap


def read_last_snapshot(path: str) -> dict | None:
    """Last parseable snapshot line of a JSONL snapshot file (None when the
    file is missing/empty — callers treat absence as 'step emitted none')."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        line = line.strip()
        if not line:
            continue
        try:
            snap = json.loads(line)
        except ValueError:
            continue
        if isinstance(snap, dict) and "metrics" in snap:
            return snap
    return None


def summarize_snapshot(snap: dict) -> dict:
    """Flatten a snapshot into a compact {metric_key: scalar-ish} dict for
    artifacts and one-line verdicts: counters/gauges -> value; histograms ->
    {count, sum, mean, max}. Label sets fold into the key as k=v pairs."""
    out: dict = {}
    for m in snap.get("metrics", []):
        key = m["name"]
        labels = m.get("labels") or {}
        if labels:
            key += "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
        v = m["value"]
        if isinstance(v, dict):  # histogram
            count = int(v.get("count", 0))
            s = float(v.get("sum", 0.0))
            h = {"count": count, "sum": round(s, 6)}
            if count:
                h["mean"] = round(s / count, 6)
                if "max" in v:
                    h["max"] = round(float(v["max"]), 6)
            out[key] = h
        else:
            out[key] = v
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "rtap-obs/0"

    def do_GET(self):  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        if path in ("/metrics", "/"):
            body = render_prometheus(self.server.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/snapshot":
            body = (json.dumps(self.server.registry.snapshot()) + "\n").encode()
            ctype = "application/json"
        elif path == "/trace":
            # the span recorder's timeline as Chrome trace-event JSON
            # (save the body and open it in ui.perfetto.dev). ?last=N
            # windows to the last N ticks (default 120).
            tr = getattr(self.server, "trace", None)
            if tr is None:
                self.send_error(404, "tracing not enabled (serve --trace-out"
                                     " / --postmortem-dir)")
                return
            try:
                from urllib.parse import parse_qs

                last = int(parse_qs(query).get("last", ["120"])[0])
            except (ValueError, IndexError):
                self.send_error(400, "bad ?last= value")
                return
            body = (json.dumps(tr.chrome_trace(last_ticks=last))
                    + "\n").encode()
            ctype = "application/json"
        elif path == "/health":
            # fleet rollup + per-group model-health scorecards:
            # occupancy, sparsity, hit rate, score quantiles, drift
            # verdict — the HealthTracker's point-in-time snapshot (the
            # loop thread folds concurrently; diagnostic read, not a
            # consistent cut — same contract as /trace)
            ht = getattr(self.server, "health", None)
            if ht is None:
                self.send_error(404, "health reducers not enabled "
                                     "(serve --health)")
                return
            body = (json.dumps(ht.snapshot()) + "\n").encode()
            ctype = "application/json"
        elif path == "/predict":
            # per-stream divergence trajectories, alarmed streams, and
            # open predicted-blast windows (rtap_tpu_torch/predict/):
            # the PredictTracker's point-in-time snapshot — diagnostic
            # read, same contract as /health
            pt = getattr(self.server, "predict", None)
            if pt is None:
                self.send_error(404, "predictive horizon not enabled "
                                     "(serve --predict)")
                return
            body = (json.dumps(pt.snapshot()) + "\n").encode()
            ctype = "application/json"
        elif path == "/incidents":
            # cluster-level incident records + open correlation windows
            # (rtap_tpu_torch/correlate/): the correlator's point-in-
            # time snapshot — same diagnostic-read contract as /health
            co = getattr(self.server, "correlator", None)
            if co is None:
                self.send_error(404, "incident correlation not enabled "
                                     "(serve --topology)")
                return
            body = (json.dumps(co.snapshot()) + "\n").encode()
            ctype = "application/json"
        elif path == "/latency":
            # detection-latency stage waterfalls + windowed quantile
            # sketches (obs/latency.py): the tracker's point-
            # in-time snapshot — diagnostic read, same contract as
            # /health (the loop thread folds concurrently)
            lt = getattr(self.server, "latency", None)
            if lt is None:
                self.send_error(404, "latency tracking not enabled "
                                     "(serve --latency)")
                return
            body = (json.dumps(lt.snapshot()) + "\n").encode()
            ctype = "application/json"
        elif path == "/slo":
            # declared SLOs, live burn rates, and the current verdict
            # (obs/slo.py; docs/SLO.md is the runbook)
            sl = getattr(self.server, "slo", None)
            if sl is None:
                self.send_error(404, "no SLOs declared (serve --slo "
                                     "NAME=TARGET@pQ)")
                return
            body = (json.dumps(sl.snapshot()) + "\n").encode()
            ctype = "application/json"
        elif path == "/healthz":
            # liveness for external supervision probes (k8s-style):
            # 200 with {"ok": true} while the loop ticked within
            # stale_after_s; 503 before the first tick and once the
            # last-tick age exceeds it (docs/TELEMETRY.md contract).
            # Reads registry gauges only — never perturbs state.
            import time as _time

            vals = {}
            for inst in self.server.registry.collect():
                if inst.kind == "gauge" and inst.name in (
                        "rtap_obs_last_tick_unixtime",
                        "rtap_obs_run_epoch",
                        "rtap_obs_degradation_level"):
                    vals[inst.name] = inst.value
            stale_after = float(getattr(
                self.server, "healthz_stale_after_s", 30.0))
            last = vals.get("rtap_obs_last_tick_unixtime")
            age = (_time.time() - last) if last else None
            ok = age is not None and age <= stale_after
            body = (json.dumps({
                "ok": ok,
                "run_epoch": int(vals.get("rtap_obs_run_epoch", 0)),
                "last_tick_age_s": round(age, 3)
                if age is not None else None,
                "degradation_level": int(vals.get(
                    "rtap_obs_degradation_level", 0)),
                "stale_after_s": stale_after,
            }) + "\n").encode()
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        elif path.startswith("/fleet/"):
            # the fleet aggregator's merged views (fleet/): counters summed
            # across members, gauges labeled per member, quantiles from
            # MERGED sketches, one fleet SLO verdict, the member roster and
            # the incident rollup — point-in-time reads, as /health
            ag = getattr(self.server, "fleet", None)
            if ag is None:
                self.send_error(404, "fleet aggregation not enabled "
                                     "(serve --fleet-listen PORT)")
                return
            route = {
                "/fleet/metrics": ag.fleet_metrics,
                "/fleet/health": ag.fleet_health,
                "/fleet/latency": ag.fleet_latency,
                "/fleet/slo": ag.fleet_slo,
                "/fleet/incidents": ag.fleet_incidents,
                "/fleet/members": ag.members_view,
                "/fleet/events": ag.events_view,
                "/fleet/snapshot": ag.snapshot,
            }.get(path)
            if route is None:
                self.send_error(404)
                return
            body = (json.dumps(route()) + "\n").encode()
            ctype = "application/json"
        elif path == "/postmortem":
            # on-demand flight-recorder dump; returns the bundle path (or
            # null when throttled). GET because it is an operator poke on
            # a localhost-only diagnostic server, not a REST resource.
            fl = getattr(self.server, "flight", None)
            if fl is None:
                self.send_error(404, "flight recorder not enabled "
                                     "(serve --postmortem-dir)")
                return
            body = (json.dumps({"bundle": fl.dump("on_demand")})
                    + "\n").encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes must not spam the serve stderr
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class ExpositionServer:
    """Localhost telemetry endpoint on a background daemon thread.

    ``port=0`` binds ephemeral (the serve/TCP path's orphan-proof style);
    the bound address is ``.address``. Start/stop via context manager or
    ``start()``/``close()``. Scrape ``/metrics`` for Prometheus text,
    ``/snapshot`` for the JSON snapshot; with a ``trace`` recorder
    attached, ``/trace?last=N`` serves the Perfetto-loadable timeline,
    with a ``flight`` recorder, ``/postmortem`` dumps a bundle on
    demand, with a ``correlator`` (rtap_tpu_torch/correlate/), ``/incidents``
    serves recent cluster-level incidents + open correlation windows,
    and with a ``health`` tracker (obs/health.py),
    ``/health`` serves the fleet rollup + per-group model scorecards
    (rings/scorecards are written lock-free by the loop, so a
    concurrent read is point-in-time diagnostic data, not a consistent
    snapshot). With a ``latency`` tracker (obs/latency.py),
    ``/latency`` serves the stage waterfalls + windowed quantiles, and
    with an ``slo`` tracker (obs/slo.py), ``/slo`` serves the declared
    SLOs' live burn rates and verdict, and with a ``predict`` tracker
    (rtap_tpu_torch/predict/), ``/predict`` serves the divergence
    trajectories, alarmed streams, and open predicted-blast windows.
    With a ``fleet`` aggregator (fleet/), the ``/fleet/*`` routes serve the
    merged cross-process views — metrics, health, latency, slo, incidents,
    members, events, snapshot.
    ``/healthz`` is always routed:
    a liveness probe returning 200 while the loop ticked within
    ``healthz_stale_after_s`` seconds, 503 otherwise
    (docs/TELEMETRY.md documents the contract).
    """

    def __init__(self, registry: TelemetryRegistry | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 trace=None, flight=None, health=None, correlator=None,
                 latency=None, slo=None, predict=None, fleet=None,
                 healthz_stale_after_s: float = 30.0):
        self.registry = registry or get_registry()
        self._server = _Server((host, port), _Handler)
        self._server.registry = self.registry
        self._server.trace = trace
        self._server.flight = flight
        self._server.health = health
        self._server.correlator = correlator
        self._server.latency = latency
        self._server.slo = slo
        self._server.predict = predict
        self._server.fleet = fleet
        self._server.healthz_stale_after_s = float(healthz_stale_after_s)
        self.address = self._server.server_address  # (host, bound port)
        # a 0.05 s poll: close() returns within it, not the default 0.5 s
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            name="rtap-obs-http", daemon=True)

    def start(self) -> "ExpositionServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # shutdown() returns once serve_forever exits, so the join is
        # immediate — but without it the thread object outlives close()
        # and the conftest leak fixture (rightly) calls that a leak
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "ExpositionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
