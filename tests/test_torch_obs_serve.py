"""PyTorch port vs the JAX package: the observability flags on the serve
loop and the serve CLI.

* latency + SLO + trace + flight + attribution on vs off: model state bit
  for bit, alert lines byte for byte once ``top_fields`` is removed; the
  armed port and the armed JAX loop write byte-equal alert lines,
  ``top_fields`` included, and the same SLO verdict counts;
* a chaos quarantine auto-dumps a valid bundle whose trace has the phase
  spans, per-group spans and the quarantine instant, and ``/trace``
  serves the same timeline live;
* a seeded SLO burn emits one slo_burn line and a bundle with the
  waterfall;
* every obs cost gate (``obs/selfbench.GATE_MEASURES``) at most 1% of the
  1 s tick budget;
* the serve CLI: every ported flag is accepted, the usage errors are the
  JAX package's, and ``serve`` with every obs flag over TCP answers its
  routes mid-run and writes its trace, bundles and snapshot.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.obs import LatencyTracker as JLat
from rtap_tpu.obs import SloTracker as JSlo
from rtap_tpu.obs import TelemetryRegistry as JReg
from rtap_tpu.obs import parse_slo as j_parse_slo
from rtap_tpu.service.attribution import AlertAttributor as JAttr
from rtap_tpu.service.loop import live_loop as j_live_loop
from rtap_tpu.service.registry import StreamGroupRegistry as JGroups
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.obs import (
    ExpositionServer,
    FlightRecorder,
    LatencyTracker,
    SloTracker,
    TelemetryRegistry,
    TraceRecorder,
    parse_slo,
    validate_bundle,
)
from rtap_tpu_torch.obs.selfbench import GATE_BUDGET_FRAC, GATE_MEASURES
from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, Fault
from rtap_tpu_torch.service.attribution import AlertAttributor
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = j_scaled(32)
JCFG = dataclasses.replace(JCFG, likelihood=dataclasses.replace(
    JCFG.likelihood, learning_period=4, estimation_samples=2))
CFG = ModelConfig.from_dict(JCFG.to_dict())
N_STREAMS = 6
GROUP_SIZE = 3
N_TICKS = 10


def _registry(pkg="torch"):
    if pkg == "jax":
        reg = JGroups(JCFG, group_size=GROUP_SIZE, backend="tpu", threshold=0.0, debounce=1)
    else:
        reg = StreamGroupRegistry(CFG, group_size=GROUP_SIZE, device="cpu", threshold=0.0,
                                  debounce=1)
    for i in range(N_STREAMS):
        reg.add_stream(f"s{i}")
    reg.finalize()
    return reg


def _feed(k):
    rng = np.random.Generator(np.random.Philox(key=(73, k)))
    v = (30 + 5 * rng.random(N_STREAMS)).astype(np.float32)
    v[k % N_STREAMS] += 40.0
    return v, 1_700_000_000 + k


def _split(path):
    alerts, events = [], []
    for ln in open(path).read().splitlines():
        (events if ln.startswith('{"event"') else alerts).append(ln)
    return alerts, events


def _armed(pkg, tmp_path):
    """Every observability hook of `pkg`, armed."""
    if pkg == "jax":
        from rtap_tpu.obs import FlightRecorder as JFlight
        from rtap_tpu.obs import TraceRecorder as JTrace

        reg = JReg()
        lat = JLat(window_ticks=4, registry=reg)
        slo = JSlo([j_parse_slo("tick=30s@p99")], fast_window=3, slow_window=6,
                   registry=reg, quantile_source=lat.quantile)
        tr = JTrace(capacity=4096)
        fl = JFlight(trace=tr, n_ticks=32, out_dir=str(tmp_path / "pm-jax"), registry=reg)
        return dict(latency=lat, slo=slo, trace=tr, flight=fl, attributor=JAttr(JCFG))
    reg = TelemetryRegistry()
    lat = LatencyTracker(window_ticks=4, registry=reg)
    slo = SloTracker([parse_slo("tick=30s@p99")], fast_window=3, slow_window=6, registry=reg,
                     quantile_source=lat.quantile)
    tr = TraceRecorder(capacity=4096)
    fl = FlightRecorder(trace=tr, n_ticks=32, out_dir=str(tmp_path / "pm"), registry=reg)
    return dict(latency=lat, slo=slo, trace=tr, flight=fl, attributor=AlertAttributor(CFG))


@pytest.mark.parametrize("micro_chunk", [1, 2])
def test_obs_on_vs_off_state_and_alerts_exact_and_jax_equal(tmp_path, micro_chunk):
    runs = {}
    for name in ("off", "on", "jax-on"):
        pkg = "jax" if name == "jax-on" else "torch"
        reg = _registry(pkg)
        hooks = _armed(pkg, tmp_path) if name != "off" else {}
        run = j_live_loop if pkg == "jax" else live_loop
        path = tmp_path / f"{name}.jsonl"
        stats = run(_feed, reg, n_ticks=N_TICKS, cadence_s=0.0, alert_path=str(path),
                    micro_chunk=micro_chunk, **hooks)
        runs[name] = (stats, reg, *_split(path))
    (s_off, r_off, a_off, _), (s_on, r_on, a_on, _) = runs["off"], runs["on"]
    for g_off, g_on in zip(r_off.groups, r_on.groups):
        a, b = state_to_numpy(g_off.state), state_to_numpy(g_on.state)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
    assert len(a_on) == N_STREAMS * N_TICKS and any('"top_fields"' in ln for ln in a_on)
    stripped = [json.dumps({k: v for k, v in json.loads(ln).items() if k != "top_fields"})
                for ln in a_on]
    assert stripped == a_off
    # the armed port writes the armed JAX package's lines, top_fields included
    assert a_on == runs["jax-on"][2]
    s_jax = runs["jax-on"][0]
    assert s_on["latency"]["ticks"] == s_jax["latency"]["ticks"] == N_TICKS
    assert s_on["latency"]["detect"]["count"] == s_jax["latency"]["detect"]["count"] \
        == N_TICKS * N_STREAMS
    assert s_on["slo"]["met"] is True and s_on["slo"]["slos"][0]["samples"] == N_TICKS
    assert "latency" not in s_off and "slo" not in s_off
    assert s_on["postmortem"]["ticks_recorded"] == N_TICKS


def _spans(events):
    return [e for e in events if e.get("ph") == "X"]


def _check_timeline(events, q_tick):
    spans = _spans(events)
    assert {"tick", "source", "dispatch", "collect", "emit"} <= {e["name"] for e in spans}
    assert all(isinstance(e["args"]["tick"], int) for e in spans)
    for gi in (0,):
        child = [e for e in spans if e["args"].get("group") == gi and e["name"] == "dispatch"]
        assert child and all(e["tid"] == gi + 1 for e in child)
    q = [e for e in events if e.get("ph") == "i" and e["name"] == "group_quarantined"]
    assert len(q) == 1 and q[0]["args"]["tick"] == q_tick and q[0]["args"]["group"] == 1


def test_chaos_quarantine_autodumps_valid_bundle_and_trace_route(tmp_path):
    trace = TraceRecorder(capacity=16384)
    flight = FlightRecorder(trace=trace, n_ticks=64, out_dir=str(tmp_path / "pm"),
                            miss_burst=N_TICKS + 1, info={"test": "postmortem_serve"})
    stats = live_loop(_feed, _registry(), n_ticks=N_TICKS, cadence_s=0.0,
                      alert_path=str(tmp_path / "alerts.jsonl"),
                      chaos=ChaosEngine(ChaosSpec(faults=[
                          Fault(kind="dispatch_exception", tick=5, group=1)])),
                      trace=trace, flight=flight)
    assert stats["quarantine_log"][0]["tick"] == 5 and stats["postmortem"]["bundles"] == 1
    bundle = stats["postmortem"]["bundle_paths"][0]
    v = validate_bundle(bundle)
    assert v["ok"] and v["reason"] == "group_quarantined" and v["tick"] == 5
    _check_timeline(json.load(open(os.path.join(bundle, "trace.json")))["traceEvents"], 5)
    with ExpositionServer(trace=trace, flight=flight) as srv:
        host, port = srv.address
        live = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/trace?last={N_TICKS}", timeout=10).read())
        _check_timeline(live["traceEvents"], 5)
        small = json.loads(urllib.request.urlopen(f"http://{host}:{port}/trace?last=1",
                                                  timeout=10).read())
        assert {e["args"]["tick"] for e in _spans(small["traceEvents"])} == {N_TICKS - 1}


def test_seeded_burn_emits_one_event_and_a_bundle_with_the_waterfall(tmp_path):
    reg = TelemetryRegistry()
    lat = LatencyTracker(window_ticks=4, registry=reg)
    slo = SloTracker([parse_slo("tick=1ms@p99")], fast_window=3, slow_window=6, registry=reg,
                     quantile_source=lat.quantile)
    os.makedirs(tmp_path / "pm")
    flight = FlightRecorder(n_ticks=32, out_dir=str(tmp_path / "pm"), registry=reg)
    stats = live_loop(_feed, _registry(), n_ticks=N_TICKS, cadence_s=0.005,
                      alert_path=str(tmp_path / "alerts.jsonl"), flight=flight, latency=lat,
                      slo=slo)
    assert stats["slo"]["met"] is False
    _, events = _split(tmp_path / "alerts.jsonl")
    assert [json.loads(e)["stage"] for e in events
            if json.loads(e)["event"] == "slo_burn"] == ["tick"]
    bundles = [p for p in flight.bundles if "slo_burn" in p]
    assert len(bundles) == 1 and validate_bundle(bundles[0])["ok"]
    summary = json.load(open(os.path.join(bundles[0], "summary.json")))
    assert summary["latency"]["waterfall"] is not None


@pytest.mark.parametrize("name", [n for n, _ in GATE_MEASURES])
def test_obs_cost_gate_within_one_percent_of_the_tick_budget(name):
    fn = dict(GATE_MEASURES)[name]
    res = fn(n=2000) if name not in ("obs_overhead", "obs_trace_overhead") else fn(n=20_000)
    assert res["per_tick_overhead_frac"] <= GATE_BUDGET_FRAC, res


PORTED = {
    "--chaos-spec": "SPEC", "--degrade": None, "--degrade-after": "3",
    "--degrade-recover-after": "15", "--quarantine-restore-after": "4",
    "--supervise": None, "--supervise-restarts": "2", "--supervise-backoff": "0.1",
    "--latency": None, "--latency-window": "60", "--slo": "tick=1s@p99",
    "--slo-fast-window": "30", "--slo-slow-window": "300", "--trace-out": "t.json",
    "--trace-ring": "1024", "--postmortem-dir": "pm", "--flight-ticks": "64",
    "--obs-port": "0", "--obs-snapshot": "s.jsonl", "--alert-attribution": None,
}


@pytest.mark.parametrize("flag", list(PORTED))
def test_ported_serve_flag_is_accepted(flag):
    from rtap_tpu_torch.__main__ import (
        _refused_serve_flag,
        _resilience_obs_usage_error,
        build_parser,
    )

    extra = [flag] if PORTED[flag] is None else [flag, PORTED[flag]]
    # the flags a ported flag needs beside it
    need = {"--latency-window": ["--latency"], "--slo": ["--latency"],
            "--slo-fast-window": ["--latency", "--slo", "x=1s@p99"],
            "--slo-slow-window": ["--latency", "--slo", "x=1s@p99"],
            "--quarantine-restore-after": ["--checkpoint-dir", "ck"],
            "--supervise": ["--checkpoint-dir", "ck"]}.get(flag, [])
    args = build_parser().parse_args(["serve", "--streams", "a", *need, *extra])
    assert _refused_serve_flag(args) is None
    assert _resilience_obs_usage_error(args) is None


USAGE = {
    "slo-without-latency": (["--slo", "detect=2s@p99"], "add --latency"),
    "latency-window-without-latency": (["--latency-window", "64"], "add --latency"),
    "slo-window-without-slo": (["--slo-fast-window", "30"], "add --slo"),
    "latency-window-0": (["--latency", "--latency-window", "0"], "--latency-window"),
    "bad-slo-unit": (["--latency", "--slo", "detect=2m@p99"], "bad --slo"),
    "bad-slo-stage": (["--latency", "--slo", "foo=2s@p99"], "bad --slo"),
    "bad-slo-quantile": (["--latency", "--slo", "detect=2s@p100"], "bad --slo"),
    "inverted-windows": (["--latency", "--slo", "detect=2s@p99", "--slo-fast-window", "100",
                          "--slo-slow-window", "10"], "--slo-*-window"),
    "restore-without-checkpoints": (["--quarantine-restore-after", "3"], "--checkpoint-dir"),
    "supervise-without-checkpoints": (["--supervise"], "--checkpoint-dir"),
    "bad-chaos-spec": (["--chaos-spec", "/nonexistent/spec.json"], "bad --chaos-spec"),
    "bad-degrade": (["--degrade", "--degrade-after", "11"], "bad --degrade parameters"),
    "trace-ring-0": (["--trace-ring", "0"], "--trace-ring"),
}


@pytest.mark.parametrize("case", list(USAGE))
def test_usage_errors_exit_2(capsys, case):
    from rtap_tpu_torch.__main__ import main

    argv, needle = USAGE[case]
    assert main(["serve", "--streams", "a", "--device", "cpu", *argv]) == 2
    assert needle in capsys.readouterr().err


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_serve_cli_with_every_obs_flag_answers_its_routes(tmp_path):
    w = str(tmp_path)
    cmd = [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams", "a,b,c,d",
           "--group-size", "2", "--device", "cpu", "--columns", "32", "--ticks", "40",
           "--cadence", "0.1", "--port", "0", "--alerts", f"{w}/alerts.jsonl",
           "--latency", "--slo", "tick=5s@p99", "--trace-out", f"{w}/trace.json",
           "--postmortem-dir", f"{w}/pm", "--flight-ticks", "64", "--obs-port", "0",
           "--alert-attribution", "--obs-snapshot", f"{w}/snap.jsonl", "--health",
           "--predict", "--topology", "infer"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    port, lines = None, []
    try:
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "obs telemetry on http://" in line:
                port = int(line.rsplit(":", 1)[1].split("/")[0])
        assert port, "".join(lines)
        time.sleep(1.0)
        codes = {r: _get(port, r) for r in ("/metrics", "/healthz", "/latency", "/health",
                                             "/predict", "/incidents", "/trace?last=5")}
        out, err = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    for route, (code, body) in codes.items():
        assert code == 200, (route, body)
    assert "# TYPE rtap_obs_ticks_total counter" in codes["/metrics"][1]
    assert "rtap_obs_build_info{" in codes["/metrics"][1]
    assert json.loads(codes["/healthz"][1])["ok"] is True
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["ticks"] == 40 and stats["slo"]["met"] is True
    trace = json.load(open(f"{w}/trace.json"))
    ticks = {e["args"]["tick"] for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "tick"}
    assert ticks == set(range(40))
    for b in stats["postmortem"]["bundle_paths"]:
        assert validate_bundle(b)["ok"]
    snap = json.loads(open(f"{w}/snap.jsonl").read().splitlines()[-1])
    assert any(m["name"] == "rtap_obs_ticks_total" for m in snap["metrics"])
