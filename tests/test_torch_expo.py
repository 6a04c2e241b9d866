"""PyTorch port vs the JAX package: telemetry exposition (obs/expo.py) and
the build-info gauge.

* ``render_prometheus`` is byte-equal to the JAX package's for registries
  filled the same way (the JAX golden, and a registry of every kind with
  labels, escapes and histograms); ``summarize_snapshot``,
  ``write_snapshot`` / ``read_last_snapshot`` agree.
* ``config_digest`` / ``set_build_info`` give the JAX package's hash and
  labels for the same config.
* ``ExpositionServer`` answers every route: /metrics, /snapshot, /healthz
  (503 before the first tick, 200 after), /trace?last=N, /latency, /slo,
  /health, /predict, /incidents, /postmortem, 404 for trackers not armed,
  400 for a bad ?last=; ``close()`` joins its thread.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from rtap_tpu.config import cluster_preset as j_cluster
from rtap_tpu.obs import expo as jexpo
from rtap_tpu.obs.health import config_digest as j_digest
from rtap_tpu.obs.health import set_build_info as j_build_info
from rtap_tpu.obs.metrics import TelemetryRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.obs import expo
from rtap_tpu_torch.obs.health import config_digest, set_build_info
from rtap_tpu_torch.obs.metrics import TelemetryRegistry


def _golden(reg):
    reg.counter("g_ticks_total", "ticks completed").inc(7)
    reg.gauge("g_streams", "live streams").set(3)
    h = reg.histogram("g_phase_seconds", "per-phase seconds", buckets=(0.1, 1.0), phase="emit")
    for v in (0.05, 0.05, 2.0):
        h.observe(v)


def _every_kind(reg):
    reg.counter("rtap_obs_x_total", 'help with "quotes" and \\ slash\nnewline',
                event="a").inc(2)
    reg.counter("rtap_obs_x_total", event='b"q').inc(5.5)
    reg.gauge("rtap_obs_level", "a gauge").set(-1.25)
    reg.gauge("rtap_obs_big").set(1e16)
    h = reg.histogram("rtap_obs_phase_seconds", "phases", phase="dispatch")
    for v in (0.0005, 0.003, 0.2, 2.0, 50.0):
        h.observe(v)
    reg.histogram("rtap_obs_phase_seconds", phase="collect").observe(0.01)
    reg.counter("rtap_obs_zero_total", "never moved")


@pytest.mark.parametrize("fill", [_golden, _every_kind])
def test_render_prometheus_byte_equal(fill):
    j, t = JReg(), TelemetryRegistry()
    fill(j)
    fill(t)
    text = expo.render_prometheus(t)
    assert text == jexpo.render_prometheus(j)
    strip = lambda s: {k: v for k, v in s.items() if k != "ts"}  # noqa: E731
    assert strip(t.snapshot()) == strip(j.snapshot())
    assert expo.summarize_snapshot(t.snapshot()) == jexpo.summarize_snapshot(j.snapshot())
    if fill is _golden:
        assert text == (
            '# HELP g_phase_seconds per-phase seconds\n'
            '# TYPE g_phase_seconds histogram\n'
            'g_phase_seconds_bucket{phase="emit",le="0.1"} 2\n'
            'g_phase_seconds_bucket{phase="emit",le="1"} 2\n'
            'g_phase_seconds_bucket{phase="emit",le="+Inf"} 3\n'
            'g_phase_seconds_sum{phase="emit"} 2.1\n'
            'g_phase_seconds_count{phase="emit"} 3\n'
            '# HELP g_streams live streams\n'
            '# TYPE g_streams gauge\n'
            'g_streams 3\n'
            '# HELP g_ticks_total ticks completed\n'
            '# TYPE g_ticks_total counter\n'
            'g_ticks_total 7\n')


def test_snapshot_files_round_trip_across_packages(tmp_path, monkeypatch):
    t = TelemetryRegistry()
    _every_kind(t)
    path = str(tmp_path / "snap.jsonl")
    expo.write_snapshot(path, registry=t)
    j = JReg()
    _golden(j)
    jexpo.write_snapshot(path, registry=j)
    # the last line is the JAX package's; both readers see it
    assert expo.read_last_snapshot(path) == jexpo.read_last_snapshot(path)
    assert len(open(path).read().splitlines()) == 2
    assert expo.read_last_snapshot(str(tmp_path / "missing")) is None
    monkeypatch.delenv(expo.SNAPSHOT_ENV, raising=False)
    assert expo.write_snapshot(None, registry=t) is None
    monkeypatch.setenv(expo.SNAPSHOT_ENV, path)
    assert expo.write_snapshot(registry=t) is not None
    assert len(open(path).read().splitlines()) == 3


def test_build_info_matches_jax():
    jcfg = j_cluster()
    tcfg = ModelConfig.from_dict(jcfg.to_dict())
    assert config_digest(tcfg) == j_digest(jcfg)
    t, j = TelemetryRegistry(), JReg()
    assert set_build_info(role="leader", shard=0, run_epoch=3, config=tcfg, registry=t) == \
        j_build_info(role="leader", shard=0, run_epoch=3, config=jcfg, registry=j)
    assert expo.render_prometheus(t) == jexpo.render_prometheus(j)


def _get(addr, path):
    try:
        with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Snap:
    def __init__(self, name):
        self.name = name

    def snapshot(self):
        return {"tracker": self.name}


def test_routes_answer(tmp_path):
    from rtap_tpu_torch.obs import FlightRecorder, LatencyTracker, SloTracker, TraceRecorder
    from rtap_tpu_torch.obs import parse_slo

    reg = TelemetryRegistry()
    tr = TraceRecorder(capacity=64)
    for k in range(10):
        tr.add_span("tick", k, time.perf_counter(), 0.001)
    lat = LatencyTracker(registry=reg)
    slo = SloTracker([parse_slo("tick=1s@p99")], registry=reg, quantile_source=lat.quantile)
    fl = FlightRecorder(trace=tr, n_ticks=8, out_dir=str(tmp_path), registry=reg)
    fl.record_tick(0, 0.01, {"source": 0.001}, [1], False)
    srv = expo.ExpositionServer(registry=reg, trace=tr, flight=fl, health=_Snap("health"),
                                correlator=_Snap("incidents"), latency=lat, slo=slo,
                                predict=_Snap("predict"), healthz_stale_after_s=5.0).start()
    try:
        addr = srv.address
        code, body = _get(addr, "/healthz")
        assert code == 503 and json.loads(body)["ok"] is False  # no tick yet
        reg.gauge("rtap_obs_last_tick_unixtime").set(time.time())
        code, body = _get(addr, "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        code, body = _get(addr, "/metrics")
        assert code == 200 and "rtap_obs_last_tick_unixtime" in body
        assert _get(addr, "/snapshot")[0] == 200
        code, body = _get(addr, "/trace?last=3")
        ticks = {e["args"]["tick"] for e in json.loads(body)["traceEvents"] if e.get("ph") == "X"}
        assert code == 200 and ticks == {7, 8, 9}
        assert _get(addr, "/trace?last=x")[0] == 400
        for route, name in (("/health", "health"), ("/predict", "predict"),
                            ("/incidents", "incidents")):
            code, body = _get(addr, route)
            assert code == 200 and json.loads(body) == {"tracker": name}
        assert json.loads(_get(addr, "/latency")[1])["window_ticks"] == 120
        assert json.loads(_get(addr, "/slo")[1])["slos"][0]["slo"] == "tick=1s@p99"
        code, body = _get(addr, "/postmortem")
        assert code == 200 and json.loads(body)["bundle"]
        assert _get(addr, "/nope")[0] == 404
        assert _get(addr, "/fleet/metrics")[0] == 404  # the fleet plane is not ported
    finally:
        srv.close()
    assert not any(t.name == "rtap-obs-http" for t in threading.enumerate())
    bare = expo.ExpositionServer(registry=TelemetryRegistry()).start()
    try:
        for route in ("/trace", "/health", "/predict", "/incidents", "/latency", "/slo",
                      "/postmortem"):
            assert _get(bare.address, route)[0] == 404, route
    finally:
        bare.close()
