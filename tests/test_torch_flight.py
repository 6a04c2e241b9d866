"""PyTorch port vs the JAX package: the flight recorder (obs/flight.py).

The same ticks, events and dumps through both recorders give the same ring
memory, the same summary (wall-clock fields aside), the same throttling
verdicts and bundle names, and each package's ``validate_bundle`` accepts
the other's bundles with the same verdict; garbage is rejected alike.
"""

import json
import os
import time

import pytest

from rtap_tpu.obs.flight import FlightRecorder as JFlight
from rtap_tpu.obs.flight import validate_bundle as j_validate
from rtap_tpu.obs.metrics import TelemetryRegistry as JReg
from rtap_tpu.obs.trace import TraceRecorder as JTrace
from rtap_tpu_torch.obs.flight import FlightRecorder, validate_bundle
from rtap_tpu_torch.obs.metrics import TelemetryRegistry
from rtap_tpu_torch.obs.trace import TraceRecorder

PHASES = ("source", "membership", "dispatch", "collect", "emit", "checkpoint")
PKGS = {"jax": (JFlight, JTrace, JReg), "torch": (FlightRecorder, TraceRecorder,
                                                  TelemetryRegistry)}
WALL = ("created_unix", "registry")


def _recorder(pkg, out_dir, **kw):
    flight, trace, reg = PKGS[pkg]
    tr = trace(capacity=256)
    fl = flight(trace=tr, out_dir=out_dir, registry=reg(), info={"command": "test"}, **kw)
    fl._run_tag = "run"  # time + pid in production
    return fl, tr


def _drive(fl, tr, n=40, missed_every=0):
    t0 = time.perf_counter()
    paths = []
    for k in range(n):
        tr.add_span("tick", k, t0 + k * 0.01, 0.009)
        missed = bool(missed_every) and k % missed_every in (1, 2, 3)
        fl.record_tick(k, 0.009 + k * 1e-4, {p: 0.001 * (i + 1) for i, p in enumerate(PHASES)},
                       [4, 4 + k % 2, 2], missed)
        if k % 9 == 4:
            tr.add_instant("group_quarantined", k, {"group": 1})
            fl.record_event({"event": "group_quarantined", "tick": k, "group": 1,
                             "blob": "y" * 50})
            fl.request_dump("group_quarantined", k)
        paths += fl.flush_pending()
    paths.append(fl.dump("on_demand", n - 1))
    paths.append(fl.dump("unhandled_exception", n - 1))
    return paths


def _summary(path):
    s = json.load(open(os.path.join(path, "summary.json")))
    return {k: v for k, v in s.items() if k not in WALL}


CASES = {"default": {}, "throttled": dict(n_ticks=8, min_dump_gap_ticks=10, max_bundles=2,
                                          miss_burst=2, n_events=5, max_event_bytes=64)}


@pytest.mark.parametrize("case", list(CASES))
def test_same_ticks_same_bundles_and_summaries(tmp_path, case):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        fl, tr = _recorder(pkg, str(d), **CASES[case])
        paths = _drive(fl, tr, missed_every=5)
        out[pkg] = (fl, paths)
    (jf, jp), (tf, tp) = out["jax"], out["torch"]
    assert [p and os.path.basename(p) for p in tp] == [p and os.path.basename(p) for p in jp]
    assert tf.nbytes() == jf.nbytes()
    assert tf.stats()["dumps_skipped"] == jf.stats()["dumps_skipped"]
    assert {k: v for k, v in tf.summary("x", 3).items() if k not in WALL} == \
        {k: v for k, v in jf.summary("x", 3).items() if k not in WALL}
    stubbed = 0
    for a, b in zip(tp, jp):
        if a is None:
            continue
        assert _summary(a) == _summary(b)
        # each package's validator judges the other's bundle alike
        assert validate_bundle(b) == j_validate(b) and validate_bundle(a) == j_validate(a)
        assert validate_bundle(a)["ok"]
        ta = open(os.path.join(a, "events.jsonl")).read()
        tb = open(os.path.join(b, "events.jsonl")).read()
        if case == "default":
            assert ta == tb and validate_bundle(b)["ok"]
        else:
            # an event longer than max_event_bytes: the JAX recorder cuts it
            # mid-JSON and its bundle fails validation; the port keeps a
            # valid stub (ROADMAP.md section C)
            stubs = [json.loads(ln) for ln in ta.splitlines()]
            assert all(len(ln) <= 64 for ln in ta.splitlines())
            cut = any("truncated_bytes" in e for e in stubs)
            assert j_validate(b)["ok"] is not cut
            stubbed += cut
    assert stubbed or case == "default"


def test_ring_bound_throttle_and_crash_exemption(tmp_path):
    fl, tr = _recorder("torch", str(tmp_path), n_ticks=16, max_bundles=1,
                       min_dump_gap_ticks=100)
    for k in range(100):
        fl.record_tick(k, 0.01, {p: 0.001 for p in PHASES}, [2, 2, 2], False)
    per_record = 8 + 8 + 1 + len(PHASES) * 8 + 3 * 8
    assert fl.nbytes() == 16 * per_record
    tr.add_span("tick", 99, time.perf_counter(), 0.01)
    assert fl.dump("group_quarantined", 99) is not None
    assert fl.dump("group_quarantined", 99) is None  # the cap
    p = fl.dump("unhandled_exception", 99)  # exempt from cap and gap
    assert p is not None and validate_bundle(p)["ok"]
    assert FlightRecorder(n_ticks=4, registry=TelemetryRegistry()).dump("x") is None
    with pytest.raises(ValueError):
        FlightRecorder(n_ticks=0)


def test_validators_reject_garbage_alike(tmp_path):
    assert validate_bundle(str(tmp_path / "missing")) == j_validate(str(tmp_path / "missing"))
    bad = tmp_path / "bundle"
    bad.mkdir()
    (bad / "summary.json").write_text("{not json")
    (bad / "events.jsonl").write_text('{"event": "x"}\n')
    (bad / "trace.json").write_text('{"traceEvents": []}')
    v = validate_bundle(str(bad))
    assert not v["ok"] and v == j_validate(str(bad))
    assert any("no spans" in p for p in v["problems"])
