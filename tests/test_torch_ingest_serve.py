"""PyTorch port vs the JAX package: binary ingest through the serve loop.

* The port's ``live_loop`` over ``BinaryBatchSource`` equals its own run
  over ``TcpJsonlSource`` (alert lines byte for byte, final leaves bit for
  bit), and equals the JAX ``live_loop`` over the JAX binary source, on the
  same row sequence in lockstep.
* A journaled binary run cut after 5 of 8 ticks resumes through its FRAME
  records into the uninterrupted run's alert lines and leaves.
* Auto-register through NAMES frames: claims hand back slot codes that the
  producer's refreshed MAP routes to the claimed model.
* ``python -m rtap_tpu_torch serve --device cpu --ingest-port 0
  --ingest-quota 50`` and ``--ingest-shm`` end to end with the stats
  line's ingest fields; the usage errors with the JAX messages and codes.
"""

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.ingest import BinaryBatchSource as JBinaryBatchSource
from rtap_tpu.ingest import send_binary as j_send_binary
from rtap_tpu.service.loop import live_loop as j_live_loop
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.ingest import BinaryBatchSource, BinaryFeedConnection, ShmRing, send_binary
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.resilience.journal import TickJournal
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry
from rtap_tpu_torch.service.sources import TcpJsonlSource, send_jsonl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = j_scaled(32)
JCFG = dataclasses.replace(JCFG, likelihood=dataclasses.replace(
    JCFG.likelihood, learning_period=3, estimation_samples=2))
CFG = ModelConfig.from_dict(JCFG.to_dict())
G = 6
IDS = [f"n{i // 3}.m{i % 3}" for i in range(G)]
TICKS = 8


def _registry(pkg, reserve=0):
    if pkg == "jax":
        reg = JReg(JCFG, group_size=3, backend="tpu", threshold=-1e9)
    else:
        reg = StreamGroupRegistry(CFG, group_size=3, device="cpu", threshold=-1e9)
    for sid in IDS:
        reg.add_stream(sid)
    reg.finalize(reserve=reserve)
    return reg


def _records(k: int) -> list[dict]:
    rng = np.random.Generator(np.random.Philox(key=(41, k)))
    vals = (30 + 5 * rng.random(G)).astype(np.float32)
    vals[k % G] += 25.0  # one stream spikes each tick
    return [{"id": sid, "value": float(v), "ts": 1_700_000_000 + k}
            for sid, v in zip(IDS, vals)]


def _lockstep(src, send, base=0):
    """Push tick k's records, wait until the listener applied them, then
    poll: two transports see the same row sequence, no cadence races."""
    consumed = [0]

    def source(k: int):
        assert send(src.address, _records(base + k)) == G
        consumed[0] += G
        deadline = time.time() + 20
        while time.time() < deadline and src.records_parsed < consumed[0]:
            time.sleep(0.002)
        assert src.records_parsed == consumed[0]
        return src(k)

    if hasattr(src, "take_tick_frames"):
        source.take_tick_frames = src.take_tick_frames
    return source


def _run(pkg, transport, alert_path, journal=None, n_ticks=TICKS, base=0, reg=None):
    reg = reg if reg is not None else _registry(pkg)
    if transport == "jsonl":
        src, send = TcpJsonlSource(IDS).start(), send_jsonl
    elif pkg == "jax":
        src, send = JBinaryBatchSource(reg.slot_map()).start(), j_send_binary
    else:
        src, send = BinaryBatchSource(reg.slot_map()).start(), send_binary
    loop = j_live_loop if pkg == "jax" else live_loop
    try:
        stats = loop(_lockstep(src, send, base), reg, n_ticks=n_ticks, cadence_s=0.01,
                     alert_path=alert_path, journal=journal)
    finally:
        src.close()
    return reg, stats


def _alert_lines(path):
    with open(path, "rb") as f:
        return [ln for ln in f if not ln.startswith(b'{"event"')]


def _leaves(pkg, reg):
    out = {}
    for gi, grp in enumerate(reg.groups):
        if pkg == "jax":
            import jax

            model = {k: np.asarray(v) for k, v in jax.device_get(grp.state).items()}
        else:
            model = state_to_numpy(grp.state)
        out.update({f"{gi}/model/{k}": v for k, v in model.items()})
        out.update({f"{gi}/likelihood/{k}": np.asarray(v)
                    for k, v in grp.likelihood.state_dict().items()})
        out[f"{gi}/ticks"] = np.asarray(grp.ticks)
    return out


def _assert_leaves_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(
            a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


def test_binary_live_loop_equals_jsonl_and_the_jax_binary_loop(tmp_path):
    runs = {}
    for pkg, transport in (("port", "binary"), ("port", "jsonl"), ("jax", "binary")):
        path = str(tmp_path / f"{pkg}_{transport}.jsonl")
        reg, stats = _run(pkg, transport, path)
        runs[pkg, transport] = (_alert_lines(path), _leaves(pkg, reg), stats)
    lines, leaves, stats = runs["port", "binary"]
    assert stats["scored"] == G * TICKS and len(lines) == G * TICKS
    assert stats["missing_values"] == 0 and stats["learned_group_ticks"] == 2 * TICKS
    for other in (runs["port", "jsonl"], runs["jax", "binary"]):
        assert other[0] == lines
        _assert_leaves_equal(leaves, other[1])


def test_journal_frame_replay_matches_uninterrupted(tmp_path):
    reg_ref, _ = _run("port", "binary", str(tmp_path / "ref.jsonl"))
    jdir = tmp_path / "journal"
    j1 = TickJournal(jdir)
    _, s1 = _run("port", "binary", str(tmp_path / "crash.jsonl"), journal=j1, n_ticks=5)
    j1.close()
    assert s1["journal"]["appended_ticks"] == 5
    j2 = TickJournal(jdir)
    assert j2.recovered_count == 5
    assert all(type(r[2]).__name__ == "JournaledFrames" for r in j2.recovered_ticks)
    reg2, stats = _run("port", "binary", str(tmp_path / "crash.jsonl"), journal=j2,
                       n_ticks=TICKS - 5, base=j2.next_tick)
    j2.close()
    assert stats["journal"]["replayed_ticks"] == 5
    assert stats["journal"]["skipped_rows"] == 0
    assert _alert_lines(tmp_path / "ref.jsonl") == _alert_lines(tmp_path / "crash.jsonl")
    _assert_leaves_equal(_leaves("port", reg_ref), _leaves("port", reg2))


def test_replay_skips_a_frame_row_of_the_wrong_width(tmp_path):
    """A FRAME record journaled at another dispatch width (membership
    changed without a checkpoint boundary) is skipped, counted."""
    from rtap_tpu_torch.ingest.protocol import data_frame

    j = TickJournal(tmp_path / "j")
    j.append_tick_frames(0, 1_700_000_000, G + 1, [data_frame([0], [1.0], 1_700_000_000)])
    j.close()
    j = TickJournal(tmp_path / "j")
    reg = _registry("port")
    stats = live_loop(lambda k: (np.full(G, 30.0, np.float32), 1_700_000_001 + k), reg,
                      n_ticks=1, cadence_s=0.0, journal=j)
    j.close()
    assert stats["journal"]["skipped_rows"] == 1 and stats["journal"]["replayed_ticks"] == 0


def test_auto_register_via_names_frames(tmp_path):
    reg = _registry("port", reserve=3)
    src = BinaryBatchSource(reg.slot_map(), track_unknown=True).start()
    newcomers = ["late.a", "late.b"]
    try:
        def source(k):
            if k == 0:
                with BinaryFeedConnection(src.address) as conn:
                    assert all(s not in conn.code_of for s in newcomers)
                    conn.send_names(newcomers)
                deadline = time.time() + 20
                while time.time() < deadline and src.frames_applied < 1:  # the NAMES
                    time.sleep(0.002)
            elif k == 2:
                # membership changed at tick 1's head: the fresh MAP routes them
                recs = [{"id": s, "value": 42.0, "ts": 1_700_000_100} for s in newcomers]
                assert send_binary(src.address, recs) == 2
                deadline = time.time() + 20
                while time.time() < deadline and src.records_parsed < 2:
                    time.sleep(0.002)
            return src(k)

        source.drain_unknown = src.drain_unknown
        source.set_slot_map = src.set_slot_map
        stats = live_loop(source, reg, n_ticks=4, cadence_s=0.01,
                          alert_path=str(tmp_path / "a.jsonl"), auto_register=True)
    finally:
        src.close()
    assert stats["auto_registered"] == 2 and all(s in reg for s in newcomers)
    assert src.records_parsed == 2 and src.rows_unknown == 0
    assert src._map_epoch == 2 and set(newcomers) <= set(src._table.ids)


def _serve(tmp_path, extra, producer):
    """`python -m rtap_tpu_torch serve` on the CPU with `extra` flags; the
    first stderr line matching `producer[0]` hands its match to
    `producer[1]`, run on a thread until the child exits -> (stats, stderr)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams", ",".join(IDS),
         "--device", "cpu", "--columns", "32", "--ticks", "4", "--cadence", "0.2",
         "--group-size", "3", "--threshold", "-1000000000.0", "--debounce", "1",
         "--alerts", str(tmp_path / "alerts.jsonl"), *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "RTAP_OBS_SNAPSHOT": str(tmp_path / "obs.jsonl")})
    lines, found = [], []

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            m = re.search(producer[0], line)
            if m and not found:
                found.append(m)

    threading.Thread(target=read_stderr, daemon=True).start()
    deadline = time.time() + 120
    while not found and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    assert found, (proc.poll(), "".join(lines)[-2000:])
    stop = threading.Event()
    feeder = threading.Thread(target=producer[1], args=(found[0], stop), daemon=True)
    feeder.start()
    try:
        out, _ = proc.communicate(timeout=180)
    finally:
        stop.set()
        feeder.join(timeout=10)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, "".join(lines)[-2000:]
    return json.loads(out.strip().splitlines()[-1]), "".join(lines)


def test_serve_cli_ingest_port_with_quota(tmp_path):
    def produce(m, stop):
        k = 0
        while not stop.is_set():
            send_binary(("127.0.0.1", int(m.group(1))), _records(k))
            k += 1
            time.sleep(0.05)

    stats, err = _serve(tmp_path, ["--ingest-port", "0", "--ingest-quota", "50"],
                        (r"listening for binary batch frames on \S+?:(\d+)", produce))
    assert stats["ticks"] == 4 and stats["records_parsed"] > 0 and stats["frames_applied"] > 0
    assert stats["native_active"] is True and stats["device"] == "cpu"
    for key in ("parse_errors", "unknown_ids", "garbage_bytes", "rows_quota_dropped",
                "rows_late_dropped", "rows_backfilled", "rows_backpressure_dropped",
                "rows_stale_epoch"):
        assert stats[key] == 0, key
    assert stats["alerts"] > 0 and (tmp_path / "alerts.jsonl").exists()
    tel = {m["name"]: m["value"] for m in stats["telemetry"]["metrics"] if "labels" not in m}
    assert 0 < tel["rtap_obs_ingest_records_total"] <= stats["records_parsed"]
    assert tel["rtap_obs_ingest_frames_total"] > 0


def test_serve_cli_ingest_shm(tmp_path):
    name = f"rtap_tt_serve_{os.getpid()}"

    def produce(m, stop):
        ring = ShmRing.attach(m.group(1))
        codes = {}
        try:
            from rtap_tpu_torch.ingest.protocol import data_frame, encode_slot

            # the registry's slot map: groups of 3 in id order
            codes = np.array([encode_slot(0, i // 3, i % 3) for i in range(G)], np.uint32)
            k = 0
            while not stop.is_set():
                recs = _records(k)
                ring.push(data_frame(codes, [r["value"] for r in recs], recs[0]["ts"]))
                k += 1
                time.sleep(0.05)
        finally:
            ring.close()

    stats, err = _serve(tmp_path, ["--ingest-shm", name],
                        (r"binary ingest shm ring '([^']+)' created", produce))
    assert "listening for binary batch frames" not in err
    assert stats["ticks"] == 4 and stats["records_parsed"] > 0
    assert stats["garbage_bytes"] == 0 and stats["parse_errors"] == 0
    assert stats["unknown_ids"] == 0 and stats["native_active"] is True


USAGE = {
    "http-with-ingest-port": ["--http", "http://127.0.0.1:9/m", "--ingest-port", "0"],
    "http-with-ingest-shm": ["--http", "http://127.0.0.1:9/m", "--ingest-shm", "ring"],
    "port-with-ingest-port": ["--port", "7000", "--ingest-port", "0"],
    "port-with-ingest-shm": ["--port", "7000", "--ingest-shm", "ring"],
    "quota-without-binary": ["--ingest-quota", "5"],
    "backfill-without-binary": ["--ingest-backfill-horizon", "2"],
}


@pytest.mark.parametrize("case", list(USAGE))
def test_ingest_usage_errors_are_the_jax_ones(case):
    from rtap_tpu.__main__ import main as j_main
    from rtap_tpu_torch.__main__ import main

    msgs = []
    for fn, dev in ((main, ["--device", "cpu"]), (j_main, ["--backend", "cpu"])):
        err = io.StringIO()
        with redirect_stderr(err):
            assert fn(["serve", "--streams", "a", *dev, *USAGE[case]]) == 2
        msgs.append(err.getvalue().strip().splitlines()[-1])
    assert msgs[0] == msgs[1] and "ingest" in msgs[0]


@pytest.mark.parametrize("flag,value", [("--ingest-port", "0"), ("--ingest-shm", "r"),
                                        ("--ingest-quota", "5"),
                                        ("--ingest-backfill-horizon", "2")])
def test_ingest_flags_are_ported(flag, value):
    from rtap_tpu_torch.__main__ import (
        UNPORTED_SERVE_FLAGS,
        _ingest_usage_error,
        _refused_serve_flag,
        build_parser,
    )

    assert flag not in UNPORTED_SERVE_FLAGS
    need = [] if flag in ("--ingest-port", "--ingest-shm") else ["--ingest-port", "0"]
    args = build_parser().parse_args(["serve", "--streams", "a", *need, flag, value])
    assert _refused_serve_flag(args) is None and _ingest_usage_error(args) is None
