"""PyTorch port: live sources end to end (mirroring
tests/integration/test_sources.py on the port): a local HTTP exporter and a
TCP producer feeding the port's live_loop at a cadence, HTTP discovery of a
new metric under auto-register, and the ingest counters."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

from rtap_tpu_torch.config import scaled_cluster_preset
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroup, StreamGroupRegistry
from rtap_tpu_torch.service.sources import HttpPollSource, TcpJsonlSource, send_jsonl

torch.set_num_threads(1)

G = 4
IDS = [f"node{i}.cpu" for i in range(G)]
CFG = scaled_cluster_preset(32)


@pytest.fixture(scope="module")
def group():
    return StreamGroup(CFG, IDS, device="cpu")


@pytest.fixture
def http_server():
    servers = []

    def start(handler):
        server = HTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return f"http://127.0.0.1:{server.server_address[1]}/metrics"

    yield start
    for s in servers:
        s.shutdown()
        s.server_close()


class _Exporter(BaseHTTPRequestHandler):
    """Per-node stats endpoint: values wander with each poll; one exporter
    is always missing (the NaN path)."""

    polls = 0

    def do_GET(self):
        _Exporter.polls += 1
        metrics = {sid: 35.0 + 3.0 * np.sin(0.3 * _Exporter.polls + i)
                   for i, sid in enumerate(IDS)}
        del metrics[IDS[-1]]
        body = json.dumps({"ts": int(time.time()), "metrics": metrics}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_http_poll_source_live_loop(group, tmp_path, http_server):
    src = HttpPollSource(http_server(_Exporter), IDS, timeout_s=1.0)
    alert_path = tmp_path / "alerts.jsonl"
    stats = live_loop(src, group, n_ticks=12, cadence_s=0.25, alert_path=str(alert_path))
    assert stats["ticks"] == 12 and stats["scored"] == 12 * G
    assert src.poll_failures == 0
    assert "latency_p50_ms" in stats
    # during the likelihood probation nothing crosses the threshold
    assert stats["alerts"] == 0
    recs = [json.loads(ln) for ln in alert_path.read_text().splitlines() if ln]
    assert [r for r in recs if "event" not in r] == []
    assert _Exporter.polls >= 12


def test_http_poll_source_survives_dead_endpoint():
    src = HttpPollSource("http://127.0.0.1:9/nothing", IDS, timeout_s=0.2)
    values, ts = src(0)
    assert np.isnan(values).all() and src.poll_failures == 1 and ts > 0


@pytest.mark.parametrize("native", [False, None], ids=["python", "default"])
def test_tcp_jsonl_source_live_loop(group, native):
    # native=False forces the Python parser; the default takes the C parser
    # wherever cc builds it (here it does)
    with TcpJsonlSource(IDS, native=native) as src:
        assert src.native_active is (native is None)
        send_jsonl(src.address, [{"id": sid, "value": 30.0 + i, "ts": 1_700_000_000 + i}
                                 for i, sid in enumerate(IDS)])
        send_jsonl(src.address, [{"id": "unknown.metric", "value": 1.0},
                                 {"id": IDS[0]}])  # bad record: no value
        combined = np.full(G, np.nan, np.float32)
        deadline = time.time() + 2.0
        while time.time() < deadline:
            values, ts = src(0)
            combined = np.where(np.isnan(combined), values, combined)
            if not np.isnan(combined).any():
                break
            time.sleep(0.02)
        np.testing.assert_allclose(combined, 30.0 + np.arange(G))
        assert ts == 1_700_000_000 + G - 1
        deadline = time.time() + 2.0
        while time.time() < deadline and src.unknown_ids + src.parse_errors < 2:
            time.sleep(0.02)
        assert src.unknown_ids == 1 and src.parse_errors == 1 and src.records_parsed == G
        values, _ = src(1)  # drained: no new pushes -> missing samples
        assert np.isnan(values).all()
        stats = live_loop(src, group, n_ticks=5, cadence_s=0.1)
        assert stats["ticks"] == 5 and stats["scored"] == 5 * G


class _DiscoveringExporter(BaseHTTPRequestHandler):
    """Starts reporting a NEW metric key mid-run; a version string and a
    null are present every poll and must never register."""

    polls = 0

    def do_GET(self):
        _DiscoveringExporter.polls += 1
        metrics = {"h0.cpu": 35.0, "h0.mem": 52.0, "h0.version": "1.2.3-rc4", "h0.ghost": None}
        if _DiscoveringExporter.polls >= 3:
            metrics["h0.net"] = 12.0
        body = json.dumps({"ts": int(time.time()), "metrics": metrics}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_http_poll_discovers_new_metric(http_server):
    _DiscoveringExporter.polls = 0
    src = HttpPollSource(http_server(_DiscoveringExporter), ["h0.cpu", "h0.mem"],
                         timeout_s=1.0, track_unknown=True)
    reg = StreamGroupRegistry(CFG, group_size=2, device="cpu")
    for sid in ("h0.cpu", "h0.mem"):
        reg.add_stream(sid)
    reg.finalize(reserve=2)
    stats = live_loop(src, reg, n_ticks=8, cadence_s=0.05, auto_register=True)
    assert stats["auto_registered"] == 1
    assert "h0.net" in reg
    assert "h0.version" not in reg and "h0.ghost" not in reg
    assert stats["scored"] > 2 * 8
    assert src.poll_failures == 0


def test_ingest_obs_counters_sum_across_source_instances():
    from rtap_tpu_torch.obs import get_registry

    counter = get_registry().counter("rtap_obs_ingest_parse_errors_total")
    before = counter.value
    for _ in range(2):
        src = TcpJsonlSource(IDS, port=0).start()
        try:
            send_jsonl(src.address, [{"id": IDS[0]}])
            deadline = time.time() + 5.0
            while time.time() < deadline and src.parse_errors < 1:
                time.sleep(0.02)
            assert src.parse_errors == 1
            src(0)  # the per-tick snapshot performs the delta sync
        finally:
            src.close()
    assert counter.value - before == 2
