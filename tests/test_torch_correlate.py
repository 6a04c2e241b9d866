"""PyTorch port vs the JAX package: topology-aware incident correlation.

* TopologyMap: the JAX package's clusters, nodes and services for spec and
  inferred topologies, and its refusals.
* IncidentCorrelator: the JAX correlator's incident events and stats on the
  same alert sequence (window quiescence, the span bound, min_streams), its
  ``.corr`` sidecar floor, and the crash-resume cases of the JAX package's
  unit tests (a pre-crash incident dedupes, an unemitted one re-emits once,
  an open window survives and extends live, a missing file is empty, a
  torn tail is skipped).

Tolerance: exact (the correlator is integer/string logic).
"""

import json

import numpy as np
import pytest

from rtap_tpu.correlate import IncidentCorrelator as JCorrelator
from rtap_tpu.correlate import TopologyMap as JTopo
from rtap_tpu.obs.metrics import TelemetryRegistry as JRegistry
from rtap_tpu_torch.correlate import IncidentCorrelator, TopologyMap, incident_id_of
from rtap_tpu_torch.obs.metrics import TelemetryRegistry
from rtap_tpu_torch.service.shardpath import alert_sidecar_path

SPEC = {"services": {"web": ["web-00", "web-01"], "db": ["db-00"],
                     "batch": ["batch-00", "batch-01"]},
        "links": [["web", "db"]]}
STREAMS = ["web-00.cpu", "web-01.mem", "db-00.cpu", "batch-00.cpu", "batch-01.net",
           "node00003.cpu", "nodot", "x.y.cpu", "svca-01.mem", "12345.cpu"]


def _correlator(**kw):
    kw.setdefault("topology", TopologyMap.from_spec(SPEC))
    kw.setdefault("window_s", 5)
    kw.setdefault("min_streams", 2)
    kw.setdefault("registry", TelemetryRegistry())
    return IncidentCorrelator(**kw)


@pytest.mark.parametrize("topo", ["spec", "infer"])
def test_topology_matches_jax(topo):
    t, j = ((TopologyMap.from_spec(SPEC), JTopo.from_spec(SPEC)) if topo == "spec"
            else (TopologyMap.infer(), JTopo.infer()))
    for s in STREAMS:
        assert t.cluster_of(s) == j.cluster_of(s), s
        assert t.node_of(s) == j.node_of(s), s
    for a in ("web-00", "db-00", "batch-00", "node00003"):
        for b in ("web-01", "db-00", "batch-01"):
            assert t.adjacent(a, b) == j.adjacent(a, b)
    assert t.stats() == j.stats()


@pytest.mark.parametrize("bad", [["web"], {"nodes": {}}, {"services": {"w": ["a"]},
                                                          "links": [["w", "nope"]]}])
def test_topology_refuses_what_jax_refuses(bad):
    with pytest.raises((ValueError, KeyError, TypeError)) as je:
        JTopo.from_spec(bad)
    with pytest.raises((ValueError, KeyError, TypeError)) as te:
        TopologyMap.from_spec(bad)
    assert type(te.value) is type(je.value) and str(te.value) == str(je.value)


def _alert_sequence(seed, n=300):
    """(alert_id, stream, ts) bursts over the spec's clusters, with quiet
    gaps longer than the window, a continuous stretch past the span bound
    and single-stream windows below min_streams."""
    rng = np.random.default_rng(seed)
    out, ts = [], 1_700_000_000
    for i in range(n):
        ts += int(rng.choice([0, 1, 1, 2, 9]))
        sid = STREAMS[int(rng.integers(0, 5))] if i % 40 < 30 else "batch-00.cpu"
        out.append((f"0:{sid}:{i}", sid, ts))
    return out


def test_correlator_matches_jax(tmp_path):
    out = {}
    for pkg, (Corr, Topo, Reg) in {"jax": (JCorrelator, JTopo, JRegistry),
                                   "torch": (IncidentCorrelator, TopologyMap,
                                             TelemetryRegistry)}.items():
        events = []
        side = str(tmp_path / f"{pkg}.corr")
        co = Corr(Topo.from_spec(SPEC), window_s=4, min_streams=3, max_span_s=40,
                  sink=events.append, registry=Reg(), sidecar_path=side)
        floors = []
        for k, (aid, sid, ts) in enumerate(_alert_sequence(5)):
            co.observe_alert(aid, sid, ts, sink_offset=100 * k)
            co.on_tick(ts, tick=k, sink_offset=100 * k + 50)
            floors.append(json.loads(open(side).read())["offset"])
        out[pkg] = (events, co.stats(), co.snapshot(), floors,
                    co.resume_scan_offset(10 ** 9))
    assert out["torch"] == out["jax"]
    events = out["torch"][0]
    assert len(events) >= 3 and out["torch"][1]["windows_expired"] > 0
    assert all(e["incident_id"] == incident_id_of(e["alert_ids"]) for e in events)


def test_sidecar_path_matches_jax():
    from rtap_tpu.service.shardpath import alert_sidecar_path as j_sidecar

    for kind in ("corr", "epoch"):
        assert alert_sidecar_path("/a/alerts.jsonl", kind) == j_sidecar("/a/alerts.jsonl", kind)
    with pytest.raises(ValueError, match="unknown sidecar kind"):
        alert_sidecar_path("a", "lock")


class TestCrashResume:
    def _sink_file(self, tmp_path, lines):
        p = tmp_path / "alerts.jsonl"
        p.write_text("".join(json.dumps(d) + "\n" for d in lines))
        return str(p)

    def _alert(self, aid, stream, ts):
        return {"alert_id": aid, "stream": stream, "ts": ts}

    def test_already_emitted_incident_dedupes(self, tmp_path):
        alerts = [self._alert("a1", "web-00.cpu", 100),
                  self._alert("a2", "web-01.cpu", 101)]
        inc = {"event": "incident", "incident_id": incident_id_of(["a1", "a2"]),
               "alert_ids": ["a1", "a2"]}
        path = self._sink_file(tmp_path, alerts + [inc])
        out = []
        co = _correlator(sink=out.append)
        summary = co.resume_from(path)
        assert summary["alerts_refolded"] == 2
        co.on_tick(200)  # well past the window: the re-folded window closes
        assert not out, "a pre-crash-emitted incident must not re-emit"
        assert co.stats()["resume_deduped"] == 1

    def test_unemitted_closed_incident_re_emits(self, tmp_path):
        alerts = [self._alert("a1", "web-00.cpu", 100),
                  self._alert("a2", "web-01.cpu", 101),
                  self._alert("z9", "batch-00.cpu", 400)]
        path = self._sink_file(tmp_path, alerts)
        out = []
        co = _correlator(sink=out.append)
        summary = co.resume_from(path)
        assert summary["re_emitted"] == 1
        assert len(out) == 1 and out[0]["alert_ids"] == ["a1", "a2"]

    def test_open_window_survives_crash_and_extends_live(self, tmp_path):
        alerts = [self._alert("a1", "web-00.cpu", 100),
                  self._alert("a2", "web-01.cpu", 101)]
        path = self._sink_file(tmp_path, alerts)
        out = []
        co = _correlator(sink=out.append, min_streams=3)
        co.resume_from(path)
        assert not out, "an open window must not close during resume"
        co.observe_alert("a3", "db-00.mem", 103)  # the fault continues
        for t in range(104, 110):
            co.on_tick(t)
        assert len(out) == 1
        assert out[0]["alert_ids"] == ["a1", "a2", "a3"]
        assert out[0]["incident_id"] == incident_id_of(["a1", "a2", "a3"])

    def test_missing_file_is_an_empty_stream(self, tmp_path):
        assert _correlator().resume_from(str(tmp_path / "nope.jsonl"))["scanned"] == 0

    def test_torn_tail_is_skipped(self, tmp_path):
        path = tmp_path / "alerts.jsonl"
        path.write_text(json.dumps(self._alert("a1", "web-00.cpu", 100)) + "\n"
                        + '{"alert_id": "torn-by-kil')
        assert _correlator().resume_from(str(path))["alerts_refolded"] == 1

    def test_resume_scan_starts_at_the_sidecar_floor(self, tmp_path):
        side = str(tmp_path / "a.corr")
        co = _correlator(sidecar_path=side)
        assert co.resume_scan_offset(700) == 700  # no sidecar: the cursor
        co.observe_alert("a1", "web-00.cpu", 100, sink_offset=300)
        assert json.loads(open(side).read()) == {"offset": 300}
        assert _correlator(sidecar_path=side).resume_scan_offset(700) == 300
        assert _correlator(sidecar_path=side).resume_scan_offset(200) == 200
