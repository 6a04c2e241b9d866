"""rtap_tpu_torch.obs — the serve stack's telemetry: one process-wide
:class:`TelemetryRegistry` of counters, gauges and fixed-bucket histograms
(obs/metrics.py), the tick watchdog (obs/watchdog.py) and the model-health
tracker with the run epoch (obs/health.py, imported from there). The JAX
package's exposition, tracing, flight-recorder, latency and SLO modules are
not ported yet."""

from rtap_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    TelemetryRegistry,
    get_registry,
    log_buckets,
)
from rtap_tpu_torch.obs.watchdog import TickWatchdog

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "TelemetryRegistry",
    "TickWatchdog",
    "get_registry",
    "log_buckets",
]
