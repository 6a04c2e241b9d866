"""Obs self-benchmark: what does instrumentation cost the tick loop?

The port's copy of the JAX package's ``obs/selfbench.py``. The acceptance
bar for the telemetry seam is registry overhead <= 1% of the tick budget.
A serve tick at the flagship shape emits a few dozen instrument operations
(6 phase-histogram observes, a tick-latency observe, 2-4 counter incs, a
gauge set, plus per-group alert accounting), so the budget math is
``ops_per_tick * ns_per_op`` vs ``cadence_s``. This module measures
ns_per_op on the running host; every measure is host work only (no
device), and ``tests/test_torch_obs_serve.py`` and ``chip_smoke.py``
phase 20 hold each of :data:`GATE_MEASURES` to the 1% bar. The fleet
publisher's measure waits for the fleet plane (ROADMAP M5).
"""

from __future__ import annotations

import time

from rtap_tpu_torch.obs.metrics import TelemetryRegistry

__all__ = ["measure", "measure_trace", "measure_journal", "measure_health",
           "measure_correlate", "measure_latency", "measure_predict",
           "GATE_MEASURES", "GATE_BUDGET_FRAC",
           "OPS_PER_TICK", "TRACE_SPANS_PER_TICK",
           "HEALTH_FOLDS_PER_TICK", "CORRELATE_ALERTS_PER_TICK",
           "LATENCY_OBSERVES_PER_TICK", "PREDICT_FOLDS_PER_TICK"]

#: instrument operations a serve tick costs at the production shape (six
#: phase observes + tick latency observe + ticks/scored/alert counters +
#: streams gauge + watchdog deadline check), rounded up for headroom
OPS_PER_TICK = 32

#: span-ring appends a serve tick costs at the production multi-group
#: shape: the tick span + six phase spans + one dispatch and one collect
#: child span per group at 16 groups (7 + 2*16 = 39), rounded up
TRACE_SPANS_PER_TICK = 40

#: HealthTracker.fold calls a serve tick costs at the production
#: multi-group shape: one per collected chunk per group, 16 groups
HEALTH_FOLDS_PER_TICK = 16

#: alert folds a correlating serve tick is budgeted for: an
#: ACTIVE incident across a whole 16-node blast radius at 2 metrics per
#: node pages ~32 streams at once; healthy ticks fold zero, so this is
#: the storm-ceiling shape, not the steady state
CORRELATE_ALERTS_PER_TICK = 32

#: per-alert detect observations a latency-tracking tick is budgeted
#: for: the same 32-stream alert-storm ceiling as the
#: correlator, on top of the per-tick record_tick + SLO evaluation
LATENCY_OBSERVES_PER_TICK = 32

#: PredictTracker.fold calls a serve tick costs at the production
#: multi-group shape: one per collected chunk per group, 16
#: groups — the same shape as the health folds they ride beside
PREDICT_FOLDS_PER_TICK = 16

def _time_op(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def measure(n: int = 50_000, cadence_s: float = 1.0) -> dict:
    """Per-operation cost of the three write paths on a private registry,
    plus the projected per-tick overhead fraction at `cadence_s`."""
    reg = TelemetryRegistry()
    c = reg.counter("selfbench_counter_total")
    g = reg.gauge("selfbench_gauge")
    h = reg.histogram("selfbench_seconds")
    # warm the per-thread cells/shards out of the measurement (first op per
    # thread allocates; steady state is what the tick loop pays)
    c.inc(); g.set(1.0); h.observe(0.01)

    counter_s = _time_op(lambda: c.inc(), n)
    gauge_s = _time_op(lambda: g.set(2.5), n)
    hist_s = _time_op(lambda: h.observe(0.0123), n)
    worst = max(counter_s, gauge_s, hist_s)
    per_tick_s = OPS_PER_TICK * worst
    return {
        "counter_ns": round(counter_s * 1e9, 1),
        "gauge_ns": round(gauge_s * 1e9, 1),
        "histogram_observe_ns": round(hist_s * 1e9, 1),
        "ops_per_tick": OPS_PER_TICK,
        "per_tick_overhead_us": round(per_tick_s * 1e6, 2),
        "per_tick_overhead_frac": per_tick_s / cadence_s,
        "cadence_s": cadence_s,
    }


def measure_trace(n: int = 50_000, cadence_s: float = 1.0,
                  n_groups: int = 16) -> dict:
    """Trace-ring + flight-recorder hot-path cost, same protocol as
    :func:`measure`: per-op nanoseconds on a private recorder, projected
    to a tick at the production multi-group shape (tracing + flight
    recording together stay <= 1% of the tick budget).

    A tick costs ``TRACE_SPANS_PER_TICK`` span appends plus ONE flight
    ``record_tick`` (instants ride event paths — rare by construction,
    measured anyway for the record)."""
    from rtap_tpu_torch.obs.flight import FlightRecorder
    from rtap_tpu_torch.obs.metrics import TelemetryRegistry
    from rtap_tpu_torch.obs.trace import TraceRecorder

    tr = TraceRecorder(capacity=4096)
    t0 = time.perf_counter()
    # warm the shard + name intern out of the measurement (first-op cost)
    tr.add_span("dispatch", 0, t0, 0.001, group=3)
    tr.add_instant("missed_tick", 0, {"elapsed_s": 1.2})
    span_s = _time_op(lambda: tr.add_span("dispatch", 1, t0, 0.001, group=3),
                      n)
    n_inst = max(1, n // 10)
    inst_s = _time_op(
        lambda: tr.add_instant("missed_tick", 1, {"elapsed_s": 1.2}), n_inst)

    fl = FlightRecorder(trace=tr, n_ticks=256,
                        registry=TelemetryRegistry())
    phases = {p: 0.001 for p in ("source", "membership", "dispatch",
                                 "collect", "emit", "checkpoint")}
    scored = [n_groups] * n_groups
    tick = [0]

    def _rt():
        tick[0] += 1
        fl.record_tick(tick[0], 0.01, phases, scored, False)

    _rt()  # size the rings out of the measurement
    rt_s = _time_op(_rt, max(1, n // 5))

    per_tick_s = TRACE_SPANS_PER_TICK * span_s + rt_s
    return {
        "trace_span_ns": round(span_s * 1e9, 1),
        "trace_instant_ns": round(inst_s * 1e9, 1),
        "flight_record_tick_ns": round(rt_s * 1e9, 1),
        "spans_per_tick": TRACE_SPANS_PER_TICK,
        "n_groups": n_groups,
        "per_tick_overhead_us": round(per_tick_s * 1e6, 2),
        "per_tick_overhead_frac": per_tick_s / cadence_s,
        "cadence_s": cadence_s,
    }


def measure_health(n: int = 2000, cadence_s: float = 1.0,
                   n_groups: int = HEALTH_FOLDS_PER_TICK) -> dict:
    """Model-health host-path cost, same protocol as :func:`measure`:
    per-fold nanoseconds of ``HealthTracker.fold`` on a private tracker
    fed realistic per-tick leaves, projected to a tick at the
    production multi-group shape (one fold per group per tick at 16
    groups). The DEVICE-side reducer cost is a property of the step
    (``python -m rtap_tpu_torch.profile_tick --health`` times it on the
    card); the host fold is what the loop thread pays every tick, gated
    <= 1% of the tick budget alongside the metric/trace/journal bars."""
    import numpy as np

    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.obs.health import HealthTracker
    from rtap_tpu_torch.obs.metrics import TelemetryRegistry
    from rtap_tpu_torch.ops.health import HEALTH_KEYS, OCC_BINS, PERM_BINS, SCORE_BINS

    ht = HealthTracker(cluster_preset(), registry=TelemetryRegistry())
    rng = np.random.default_rng(0)
    leaves = {
        "occ_hist": rng.integers(0, 64, (1, OCC_BINS), dtype=np.int32),
        "seg_occ_frac": np.float32([0.4]),
        "syn_frac": np.float32([0.3]),
        "perm_hist": rng.random((1, PERM_BINS), np.float32),
        "perm_conn_frac": np.float32([0.5]),
        "act_col_frac": np.float32([0.02]),
        "pred_cell_frac": np.float32([0.01]),
        "hit_num": np.float32([900.0]),
        "hit_den": np.float32([1024.0]),
        "score_hist": rng.integers(0, 64, (1, SCORE_BINS), dtype=np.int32),
        "scored": np.int32([1024]),
    }
    gi = [0]

    def _fold():
        gi[0] = (gi[0] + 1) % n_groups
        ht.fold(gi[0], leaves, tick=gi[0])

    _fold()  # warm the group slot + instrument shards out of the timing
    fold_s = _time_op(_fold, n)
    snap_s = _time_op(ht.snapshot, max(1, n // 20))
    # one fold per group per tick: the projection must follow the shape
    # actually measured, not the 16-group default
    per_tick_s = n_groups * fold_s
    return {
        "health_fold_us": round(fold_s * 1e6, 2),
        "health_snapshot_us": round(snap_s * 1e6, 2),
        "folds_per_tick": n_groups,
        "n_groups": n_groups,
        # bytes per (group, tick) health leaf, from the schema
        "leaf_bytes_per_group_tick": 4 * (OCC_BINS + PERM_BINS + SCORE_BINS
                                          + len(HEALTH_KEYS) - 3),
        "per_tick_overhead_us": round(per_tick_s * 1e6, 2),
        "per_tick_overhead_frac": per_tick_s / cadence_s,
        "cadence_s": cadence_s,
    }


def measure_journal(n: int = 2000, cadence_s: float = 1.0,
                    n_streams: int = 1024) -> dict:
    """Write-ahead-journal hot-path cost, same protocol as
    :func:`measure`: a serve tick pays ONE tick-row append (format +
    write + flush-to-kernel, fsync policy ``os`` — the default) plus one
    alert-cursor append per emitted chunk, measured on a private journal
    in a temp dir at the production per-group row width: journaling
    stays <= 1% of the tick budget.
    """
    import shutil
    import tempfile

    import numpy as np

    from rtap_tpu_torch.resilience.journal import TickJournal

    d = tempfile.mkdtemp(prefix="rtap_selfbench_journal_")
    try:
        j = TickJournal(d, fsync="os")
        row = np.full(n_streams, 31.5, np.float32)
        # warm the segment handle + first-write path out of the timing
        j.append_tick(0, 1_700_000_000, row)
        j.append_cursor(0, 0)
        i = [0]

        def _tick():
            i[0] += 1
            j.append_tick(i[0], 1_700_000_000 + i[0], row)

        tick_s = _time_op(_tick, n)
        cursor_s = _time_op(lambda: j.append_cursor(i[0], 123456), n)
        rotations = j.rotations
        j.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    per_tick_s = tick_s + cursor_s
    return {
        "journal_tick_append_us": round(tick_s * 1e6, 2),
        "journal_cursor_append_us": round(cursor_s * 1e6, 2),
        "n_streams": n_streams,
        "row_bytes": int(row.nbytes),
        "segment_rotations": rotations,
        "fsync": "os",
        "per_tick_overhead_us": round(per_tick_s * 1e6, 2),
        "per_tick_overhead_frac": per_tick_s / cadence_s,
        "cadence_s": cadence_s,
    }


def measure_correlate(n: int = 20_000, cadence_s: float = 1.0,
                      n_alerts: int = CORRELATE_ALERTS_PER_TICK,
                      n_clusters: int = 8) -> dict:
    """Incident-correlator hot-path cost, same protocol as
    :func:`measure`: per-op nanoseconds of ``observe_alert`` (the fold)
    and ``on_tick`` (the window-close scan) on a private correlator with
    ``n_clusters`` clusters kept PERMANENTLY open — the storm ceiling,
    where every tick both folds a full blast-radius worth of alerts and
    scans every open window. A healthy tick pays one near-empty
    ``on_tick`` only; this projects the worst case, gated <= 1% of the
    tick budget alongside the metric/trace/journal/health bars."""
    from rtap_tpu_torch.correlate import IncidentCorrelator, TopologyMap

    co = IncidentCorrelator(
        TopologyMap.infer(), window_s=3600, min_streams=3,
        sink=lambda _rec: None, registry=TelemetryRegistry())
    streams = [f"svc{c:02d}-{i:02d}.cpu"
               for c in range(n_clusters) for i in range(4)]
    i = [0]

    def _fold():
        i[0] += 1
        co.observe_alert(f"a{i[0]}", streams[i[0] % len(streams)],
                         1_700_000_000, top_fields=None)

    _fold()  # open the windows / warm instrument shards out of the timing
    fold_s = _time_op(_fold, n)
    # the scan walks n_clusters open windows and closes none (window_s
    # holds them open) — the recurring per-tick cost, not the rare close
    tick_s = _time_op(lambda: co.on_tick(1_700_000_000), n)
    per_tick_s = n_alerts * fold_s + tick_s
    return {
        "correlate_fold_us": round(fold_s * 1e6, 2),
        "correlate_on_tick_us": round(tick_s * 1e6, 2),
        "alerts_per_tick": n_alerts,
        "open_clusters": n_clusters,
        "per_tick_overhead_us": round(per_tick_s * 1e6, 2),
        "per_tick_overhead_frac": per_tick_s / cadence_s,
        "cadence_s": cadence_s,
    }


def measure_latency(n: int = 20_000, cadence_s: float = 1.0,
                    n_alerts: int = LATENCY_OBSERVES_PER_TICK) -> dict:
    """Detection-latency instrumentation cost, same protocol
    as :func:`measure`: per-op nanoseconds of the quantile-sketch
    observe (the per-alert detect path) and the full per-tick fold
    (``LatencyTracker.record_tick`` + ``SloTracker.on_tick`` with two
    declared SLOs — the stage sketches, the waterfall build, the lag
    probes, and the burn-rate evaluation), projected to a tick at the
    alert-storm ceiling. Registered in :data:`GATE_MEASURES`, so it is
    gated <= 1% of the tick budget alongside every other obs
    instrument."""
    import numpy as np

    from rtap_tpu_torch.obs.latency import LatencyTracker
    from rtap_tpu_torch.obs.slo import SloTracker, parse_slo

    reg = TelemetryRegistry()
    tracker = LatencyTracker(window_ticks=120, cadence_s=cadence_s,
                             registry=reg)
    slo = SloTracker([parse_slo("detect=2s@p99"),
                      parse_slo("tick=1s@p99")],
                     cadence_s=cadence_s, registry=reg,
                     quantile_source=tracker.quantile)
    tracker.slo = slo
    tracker.lag_providers["repl_ack_ticks"] = lambda _t, _ts: 3.0
    lags = np.full(1, 0.123)
    phases = {p: 0.001 for p in ("source", "membership", "dispatch",
                                 "collect", "emit", "checkpoint")}
    tick = [0]

    def _rt():
        tick[0] += 1
        tracker.record_tick(tick[0], 1_700_000_000 + tick[0], phases,
                            0.01, poll_wall=1_700_000_000.5 + tick[0])
        slo.on_tick(tick[0])

    # warm the sketch shards / instrument cells out of the measurement
    tracker.observe_detect(lags)
    _rt()
    observe_s = _time_op(lambda: tracker.observe_detect(lags), n)
    rt_s = _time_op(_rt, max(1, n // 10))
    per_tick_s = n_alerts * observe_s + rt_s
    return {
        "latency_observe_ns": round(observe_s * 1e9, 1),
        "latency_record_tick_us": round(rt_s * 1e6, 2),
        "alerts_per_tick": n_alerts,
        "per_tick_overhead_us": round(per_tick_s * 1e6, 2),
        "per_tick_overhead_frac": per_tick_s / cadence_s,
        "cadence_s": cadence_s,
    }


def measure_predict(n: int = 2000, cadence_s: float = 1.0,
                    n_groups: int = PREDICT_FOLDS_PER_TICK,
                    n_streams: int = 1024) -> dict:
    """Predictive-horizon host-path cost, same protocol as
    :func:`measure`: per-fold nanoseconds of ``PredictTracker.fold`` on
    a private tracker fed realistic per-(group, tick) leaves at the
    production group width, projected to a tick at the multi-group
    shape (one fold per group per tick at 16 groups, beside the health
    folds). The DEVICE-side reducer cost is a property of the step
    (``python -m rtap_tpu_torch.profile_tick --predict 8`` times it on
    the card); the host fold is what the loop thread pays, gated <= 1%
    of the tick budget alongside every other obs instrument."""
    import numpy as np

    from rtap_tpu_torch.predict import PredictTracker

    pt = PredictTracker(horizon=8, registry=TelemetryRegistry(),
                        threshold=0.35, min_ticks=12)
    rng = np.random.default_rng(0)
    miss = rng.random(n_streams).astype(np.float32) * 0.3
    leaves = {
        "overlap": (1.0 - miss)[None, :],
        "miss_ewma": miss[None, :],
        "pred_col_frac": np.full((1, n_streams), 0.04, np.float32),
        "scored": np.ones((1, n_streams), bool),
    }
    ids = [f"node{i:05d}.cpu" for i in range(n_streams)]
    gi = [0]

    def _fold():
        gi[0] = (gi[0] + 1) % n_groups
        pt.fold(gi[0], leaves, tick=gi[0], ids=ids)

    _fold()  # warm the group slot + instrument shards out of the timing
    fold_s = _time_op(_fold, n)
    snap_s = _time_op(pt.snapshot, max(1, n // 20))
    per_tick_s = n_groups * fold_s
    return {
        "predict_fold_us": round(fold_s * 1e6, 2),
        "predict_snapshot_us": round(snap_s * 1e6, 2),
        "folds_per_tick": n_groups,
        "n_groups": n_groups,
        "n_streams": n_streams,
        # three f32 vectors and one bool mask per stream
        "leaf_bytes_per_group_tick": n_streams * (3 * 4 + 1),
        "per_tick_overhead_us": round(per_tick_s * 1e6, 2),
        "per_tick_overhead_frac": per_tick_s / cadence_s,
        "cadence_s": cadence_s,
    }


#: THE obs-bench gate registry: every self-benchmarked instrument
#: surface, each gated <= ``GATE_BUDGET_FRAC`` of the tick budget by the
#: overhead tests and chip_smoke.py phase 20. Adding an instrument =
#: adding a row here — a new surface cannot ship ungated.
GATE_MEASURES: tuple = (
    ("obs_overhead", measure),
    ("obs_trace_overhead", measure_trace),
    ("obs_journal_overhead", measure_journal),
    ("obs_health_overhead", measure_health),
    ("obs_correlate_overhead", measure_correlate),
    ("obs_latency_overhead", measure_latency),
    ("obs_predict_overhead", measure_predict),
)

#: the shared acceptance bar: each surface's projected per-tick cost
#: must stay under this fraction of the cadence budget
GATE_BUDGET_FRAC = 0.01
