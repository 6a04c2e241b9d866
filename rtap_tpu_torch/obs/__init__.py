"""rtap_tpu_torch.obs — the serve stack's telemetry, the port of the JAX
package's ``obs``: one process-wide :class:`TelemetryRegistry` of counters,
gauges and fixed-bucket histograms (obs/metrics.py); Prometheus text, JSONL
snapshots and the localhost HTTP routes (obs/expo.py); the tick watchdog
(obs/watchdog.py); the per-tick span recorder with Chrome trace export
(obs/trace.py); the black-box flight recorder and its postmortem bundles
(obs/flight.py); detection-latency sketches and stage waterfalls
(obs/latency.py) with burn-rate SLOs (obs/slo.py); the model-health
tracker, the run epoch and the build-info gauge (obs/health.py); and the
cost gate of all of them (obs/selfbench.py)."""

from rtap_tpu_torch.obs.expo import (
    ExpositionServer,
    default_snapshot_path,
    read_last_snapshot,
    render_prometheus,
    summarize_snapshot,
    write_snapshot,
)
from rtap_tpu_torch.obs.flight import FlightRecorder, validate_bundle
from rtap_tpu_torch.obs.health import HealthTracker, bump_run_epoch, set_build_info
from rtap_tpu_torch.obs.latency import LatencyTracker, QuantileSketch
from rtap_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    TelemetryRegistry,
    get_registry,
    log_buckets,
)
from rtap_tpu_torch.obs.slo import SloSpec, SloTracker, parse_slo
from rtap_tpu_torch.obs.trace import TraceRecorder
from rtap_tpu_torch.obs.watchdog import TickWatchdog

__all__ = [
    "Counter",
    "ExpositionServer",
    "FlightRecorder",
    "Gauge",
    "HealthTracker",
    "Histogram",
    "LatencyTracker",
    "QuantileSketch",
    "SloSpec",
    "SloTracker",
    "TelemetryRegistry",
    "TickWatchdog",
    "TraceRecorder",
    "bump_run_epoch",
    "default_snapshot_path",
    "get_registry",
    "log_buckets",
    "parse_slo",
    "read_last_snapshot",
    "render_prometheus",
    "set_build_info",
    "summarize_snapshot",
    "validate_bundle",
    "write_snapshot",
]
