"""PyTorch port vs the JAX package: the span recorder (obs/trace.py).

The same appends through both recorders give the same retained records and
the same Chrome trace JSON (wall-clock offsets and the process id aside):
the bounded ring with overwrite-oldest, instant truncation, bounded name
interning, group tracks, the tick window; per-thread shards; the port's
``replay_streams(trace=)`` records the chunk spans the JAX one does; the
trace + flight cost stays within 1% of the tick budget.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from rtap_tpu.obs.trace import REC_DTYPE as J_REC
from rtap_tpu.obs.trace import TraceRecorder as JTrace
from rtap_tpu_torch.obs.trace import REC_DTYPE, TraceRecorder

torch.set_num_threads(1)


def _script(tr, t0):
    for i in range(20):
        tr.add_span("tick", i, t0 + i * 1e-3, 1e-4)
        tr.add_span("dispatch", i, t0 + i * 1e-3, 2e-5, group=i % 3)
        if i % 7 == 3:
            tr.add_instant("group_quarantined", i, {"phase": "dispatch", "blob": "x" * 600},
                           group=1)
    for j in range(12):
        tr.add_span(f"name{j}", 20, t0 + 0.05, 1e-6)


def _norm(ct):
    """Chrome trace with the wall-clock and process fields removed."""
    evs = []
    for e in ct["traceEvents"]:
        evs.append({k: v for k, v in e.items() if k not in ("ts", "dur", "pid")})
    other = {k: v for k, v in ct["otherData"].items()
             if k not in ("pid", "process_name", "epoch_unix", "epoch_perf")}
    return evs, other


CASES = {"small-ring": dict(capacity=8), "large-ring": dict(capacity=256),
         "tight-names": dict(capacity=64, max_names=6, max_arg_bytes=40)}


@pytest.mark.parametrize("case", list(CASES))
def test_same_appends_same_records_and_chrome_trace(case):
    kw = CASES[case]
    j, t = JTrace(**kw), TraceRecorder(**kw)
    t0 = time.perf_counter()
    _script(j, t0)
    _script(t, t0)
    assert REC_DTYPE == J_REC
    assert (t.total, t.dropped, t.nbytes()) == (j.total, j.dropped, j.nbytes())

    def recs(tr, **w):
        return [{k: v for k, v in r.items() if k != "t0"} for r in tr.records(**w)]

    assert recs(t) == recs(j)
    assert recs(t, last_ticks=3) == recs(j, last_ticks=3)
    assert _norm(t.chrome_trace()) == _norm(j.chrome_trace())
    assert _norm(t.chrome_trace(last_ticks=5)) == _norm(j.chrome_trace(last_ticks=5))
    json.loads(json.dumps(t.chrome_trace()))


def test_ring_bound_and_schema():
    tr = TraceRecorder(capacity=8)
    t0 = time.perf_counter()
    for i in range(20):
        tr.add_span("tick", i, t0 + i * 1e-3, 1e-4)
    assert tr.total == 20 and tr.dropped == 12
    assert sorted(r["tick"] for r in tr.records()) == list(range(12, 20))
    assert tr.nbytes() == 8 * REC_DTYPE.itemsize
    tr = TraceRecorder(capacity=64)
    tr.add_span("source", 3, t0, 0.002)
    tr.add_span("dispatch", 3, t0 + 0.002, 0.004, group=1)
    tr.add_instant("group_quarantined", 3, {"phase": "dispatch"}, group=1)
    evs = tr.chrome_trace()["traceEvents"]
    disp = next(e for e in evs if e.get("ph") == "X" and e["name"] == "dispatch")
    assert disp["tid"] == 2 and disp["args"]["group"] == 1
    assert disp["dur"] == pytest.approx(4000, rel=0.01)
    q = next(e for e in evs if e.get("ph") == "i")
    assert q["s"] == "g" and q["args"]["phase"] == "dispatch"
    with pytest.raises(ValueError):
        TraceRecorder(capacity=0)


def test_concurrent_writers_have_private_shards():
    tr = TraceRecorder(capacity=1000)
    t0 = time.perf_counter()
    barrier = threading.Barrier(4)

    def work():
        barrier.wait()
        for i in range(500):
            tr.add_span("collect", i, t0, 1e-6, group=0)
        barrier.wait()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert tr.total == 2000 and tr.dropped == 0 and len(tr._shards) >= 4


def test_replay_streams_records_the_chunk_spans_the_jax_replay_does():
    from rtap_tpu.config import cluster_preset as j_cluster
    from rtap_tpu.data.synthetic import SyntheticStreamConfig, generate_cluster
    from rtap_tpu.service.loop import replay_streams as j_replay
    from rtap_tpu_torch.config import ModelConfig
    from rtap_tpu_torch.data.synthetic import LabeledStream
    from rtap_tpu_torch.service.replay import replay_streams

    streams = generate_cluster(1, cfg=SyntheticStreamConfig(length=16, cadence_s=1.0,
                                                             n_anomalies=0), seed=0)
    tstreams = [LabeledStream(s.stream_id, s.timestamps, s.values)
                for s in streams]
    out = {}
    for name, run, strm, cfg, kw in (
            ("jax", j_replay, streams, j_cluster(), dict(backend="tpu")),
            ("torch", replay_streams, tstreams,
             ModelConfig.from_dict(j_cluster().to_dict()), dict(device="cpu"))):
        tr = (JTrace if name == "jax" else TraceRecorder)(capacity=256)
        res = run(strm, cfg, chunk_ticks=8, trace=tr, **kw)
        out[name] = (res, sorted((r["name"], r["tick"], r["group"]) for r in tr.records()))
    assert out["torch"][1] == out["jax"][1]
    assert [n for n, _, _ in out["torch"][1]].count("replay_dispatch") == 2
    assert np.array_equal(out["torch"][0].raw, out["jax"][0].raw)


def test_trace_and_flight_overhead_within_one_percent_of_tick_budget():
    from rtap_tpu_torch.obs.selfbench import measure_trace

    res = measure_trace(n=5000)
    assert res["per_tick_overhead_frac"] <= 0.01, res
