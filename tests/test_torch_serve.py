"""PyTorch port vs the JAX package: the live serve loop.

* The JAX live_loop and the port's live_loop on the same seeded feed give
  byte-equal alert lines (event lines, which carry wall-clock fields, are
  left out) and bit-equal final state: pipeline depth 1 and 2, micro_chunk
  2, frozen, auto-register with claims mid-run, auto-release.
* A run that checkpoints, crashes and resumes with journal replay matches
  the uninterrupted run, and matches the JAX package doing the same.
* The port's replay crash test (mirroring
  tests/integration/test_crash_resume.py) and a two-kill subprocess drill
  on the port alone: final state bit-equal to the fault-free run, every
  alert id exactly once.
* ``python -m rtap_tpu_torch serve`` over TCP on the CPU (mirroring
  tests/integration/test_cli.py), every unported JAX serve flag refused
  with exit 2, and the refusal without a card.
* The composite and categorical presets: the JAX live_loop and the port's
  on the same feed give byte-equal alert lines and bit-equal state (the
  delta predecessor included); ``serve --preset`` over TCP on the CPU; the
  JAX package's usage error for ``--columns`` with a non-cluster preset.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.resilience.journal import TickJournal as JJournal
from rtap_tpu.service.loop import live_loop as j_live_loop
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.resilience.journal import TickJournal
from rtap_tpu_torch.service.checkpoint import load_group, peek_resume_ticks
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = j_scaled(32)
JCFG = dataclasses.replace(JCFG, likelihood=dataclasses.replace(
    JCFG.likelihood, learning_period=10, estimation_samples=5))
CFG = ModelConfig.from_dict(JCFG.to_dict())
IDS = [f"n{i // 3}.m{i % 3}" for i in range(5)]
# under this feed the log-likelihood sits at 0.03 through the short
# probation, drops to ~0.002 and climbs back past 0.007 by tick ~22: alerts
# flow on some ticks and not others, and claimed slots restart probation
THRESHOLD = 0.007


class Feed:
    """A seeded source keyed by the GLOBAL tick (base + local tick), with
    the id table and discovery hooks of the JSONL sources: `joins` maps a
    global tick to ids that start pushing then, `silent` an id to the
    global tick from which it sends nothing."""

    def __init__(self, ids, base=0, seed=3, joins=None, silent=None, crash_at=None):
        self.ids = list(ids)
        self.base = base
        self.seed = seed
        self.joins = joins or {}
        self.silent = silent or {}
        self.crash_at = crash_at
        self._next = base

    def value(self, sid, g):
        if g >= self.silent.get(sid, 1 << 30):
            return np.nan
        h = zlib.crc32(sid.encode())
        rng = np.random.Generator(np.random.Philox(key=((self.seed << 32) + h, g)))
        v = 30 + 8 * np.sin(g / 3.0 + h % 7) + rng.normal(0, 0.5)
        return v + (40.0 if (g + h) % 11 == 0 else 0.0)

    def __call__(self, k):
        g = self.base + k
        if g == self.crash_at:
            raise Crash(g)
        self._next = g + 1
        return (np.array([self.value(s, g) for s in self.ids], np.float32),
                1_700_000_000 + g)

    def drain_unknown(self):
        return sorted({s for t, new in self.joins.items() if t <= self._next
                       for s in new if s not in self.ids})

    def set_ids(self, ids):
        self.ids = list(ids)


class Crash(BaseException):
    """A process death mid-run, in process: escapes live_loop's source
    error handling like a kill would."""


def _registry(pkg, group_size=3, reserve=0, ids=IDS):
    if pkg == "jax":
        reg = JReg(JCFG, group_size=group_size, backend="tpu", threshold=THRESHOLD, debounce=2)
    else:
        reg = StreamGroupRegistry(CFG, group_size=group_size, device="cpu",
                                  threshold=THRESHOLD, debounce=2)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize(reserve=reserve)
    return reg


def _alert_lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith('{"event"')]


def _state(pkg, grp):
    if pkg == "jax":
        import jax

        model = {k: np.asarray(v) for k, v in jax.device_get(grp.state).items()}
    else:
        model = state_to_numpy(grp.state)
    return {**{f"model/{k}": v for k, v in model.items()},
            **{f"likelihood/{k}": np.asarray(v) for k, v in grp.likelihood.state_dict().items()},
            "alert_run": np.asarray(grp._alert_run), "ticks": np.asarray(grp.ticks),
            "ids": np.asarray(grp.stream_ids)}


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


CASES = {
    "depth1": dict(loop=dict(pipeline_depth=1)),
    "depth2": dict(loop=dict(pipeline_depth=2)),
    "micro2": dict(loop=dict(micro_chunk=2)),
    "frozen": dict(loop=dict(learn=False, pipeline_depth=2)),
    "auto-register": dict(loop=dict(auto_register=True), reserve=2,
                          feed=dict(joins={8: ["late.a"],
                                           15: ["late.b", "late.c", "late.d", "late.e"]})),
    "auto-release": dict(loop=dict(auto_release_after=4, auto_register=True),
                         feed=dict(silent={"n0.m1": 10}, joins={20: ["late.z"]})),
}


@pytest.mark.parametrize("case", list(CASES))
def test_live_loop_matches_jax(tmp_path, case):
    spec = CASES[case]
    out = {}
    for pkg, loop in (("jax", j_live_loop), ("torch", live_loop)):
        reg = _registry(pkg, reserve=spec.get("reserve", 0))
        feed = Feed(reg.dispatch_ids(), **spec.get("feed", {}))
        stats = loop(feed, reg, n_ticks=30, cadence_s=0.0, alert_path=str(tmp_path / pkg),
                     **spec["loop"])
        out[pkg] = (stats, reg, _alert_lines(tmp_path / pkg))
    (js, jreg, jlines), (ts, treg, tlines) = out["jax"], out["torch"]
    assert tlines == jlines
    assert len(tlines) > 0 and ts["alerts"] == js["alerts"] == len(tlines)
    for key in ("ticks", "scored", "scored_by_group", "auto_registered", "auto_rejected",
                "auto_released"):
        assert ts.get(key) == js.get(key), key
    assert [g.stream_ids for g in treg.groups] == [g.stream_ids for g in jreg.groups]
    for jg, tg in zip(jreg.groups, treg.groups):
        _assert_states_equal(_state("jax", jg), _state("torch", tg))
    if case == "auto-register":
        assert ts["auto_registered"] == 4 and ts["auto_rejected"] == 1
    if case == "auto-release":
        assert ts["auto_released"] == 1 and ts["auto_registered"] == 1
    # n0.m1 is silent for the auto_release_after ticks before its release
    assert ts["missing_values"] == (4 if case == "auto-release" else 0)
    assert ts["tm_overflow_total"] == 0 and ts["kernel_launches"] == {"tm_learn": 0}


def _serve_once(pkg, workdir, total, crash_at=None):
    """One serve lifetime over `workdir` (journal + checkpoints + alerts):
    resume, replay, run the rest of the `total` budget; a crash escapes."""
    reg = _registry(pkg)
    jmod, loop = (JJournal, j_live_loop) if pkg == "jax" else (TickJournal, live_loop)
    journal = jmod(os.path.join(workdir, "journal"), segment_bytes=2048)
    ck = os.path.join(workdir, "ck")
    base = max(journal.next_tick, peek_resume_ticks(ck))
    try:
        return loop(Feed(reg.dispatch_ids(), base=base, crash_at=crash_at), reg,
                    n_ticks=total - base, cadence_s=0.0,
                    alert_path=os.path.join(workdir, "alerts.jsonl"), checkpoint_dir=ck,
                    checkpoint_every=8, pipeline_depth=2, journal=journal), reg
    finally:
        journal.close()


def test_crash_resume_with_journal_replay_matches_uninterrupted_and_jax(tmp_path):
    total = 40
    _, ref_reg = _serve_once("torch", str(tmp_path / "ref"), total)
    ref_lines = _alert_lines(tmp_path / "ref" / "alerts.jsonl")
    got = {}
    for pkg in ("jax", "torch"):
        w = str(tmp_path / pkg)
        with pytest.raises(Crash):
            _serve_once(pkg, w, total, crash_at=21)
        stats, reg = _serve_once(pkg, w, total)
        assert stats["resumed_from"] == {"group0": 16, "group1": 16}
        assert stats["journal"]["replayed_ticks"] == 5
        assert stats["journal"]["suppressed_alerts"] > 0
        assert stats["ticks"] == total - 21
        got[pkg] = (_alert_lines(os.path.join(w, "alerts.jsonl")), reg)
    assert got["torch"][0] == ref_lines == got["jax"][0]
    assert len(ref_lines) > 0
    for gi, ref_grp in enumerate(ref_reg.groups):
        want = _state("torch", ref_grp)
        _assert_states_equal(want, _state("torch", got["torch"][1].groups[gi]))
        _assert_states_equal(want, _state("jax", got["jax"][1].groups[gi]))
    # the final checkpoints on disk hold the final state too
    for gi, ref_grp in enumerate(ref_reg.groups):
        back = load_group(tmp_path / "torch" / "ck" / f"group{gi:04d}", device="cpu")
        _assert_states_equal(_state("torch", ref_grp), _state("torch", back))


_REPLAY_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from rtap_tpu_torch.config import scaled_cluster_preset
from rtap_tpu_torch.data.synthetic import cluster_streams
from rtap_tpu_torch.service import registry
from rtap_tpu_torch.service.replay import replay_streams

# die abruptly right after the 6th collected chunk: two chunks past the
# checkpoint_every=4 save, so resume must come from the checkpoint
_collected = [0]
_orig = registry.StreamGroup.collect_chunk
def _dying_collect(self, handle):
    out = _orig(self, handle)
    _collected[0] += 1
    if _collected[0] == 6:
        os._exit(9)
    return out
registry.StreamGroup.collect_chunk = _dying_collect
replay_streams(cluster_streams(6, {length}, 7), scaled_cluster_preset(32), device="cpu",
               chunk_ticks={chunk}, threshold=0.0, alert_path={alerts!r},
               checkpoint_dir={ckdir!r}, checkpoint_every=4)
raise SystemExit("unreachable: the crash hook must fire")
"""


def test_crash_mid_replay_resumes_bit_identically(tmp_path):
    from rtap_tpu_torch.config import scaled_cluster_preset
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.service.replay import replay_streams

    length, chunk = 160, 16
    ckdir, alerts = str(tmp_path / "ck"), str(tmp_path / "alerts.jsonl")
    streams = cluster_streams(6, length, 7)
    cfg = scaled_cluster_preset(32)
    ref = replay_streams(streams, cfg, device="cpu", chunk_ticks=chunk, threshold=0.0,
                         alert_path=str(tmp_path / "ref.jsonl"))
    child = _REPLAY_CHILD.format(repo=REPO, length=length, chunk=chunk, ckdir=ckdir,
                                 alerts=alerts)
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 9, f"rc={proc.returncode}\n{proc.stderr[-2000:]}"
    meta = json.loads(open(os.path.join(ckdir, "group0000", "meta.json")).read())
    assert 0 < meta["ticks"] < length
    res = replay_streams(streams, cfg, device="cpu", chunk_ticks=chunk, threshold=0.0,
                         alert_path=alerts, checkpoint_dir=ckdir, checkpoint_every=4)
    boundary = res.throughput["resumed_from"]["group0"]
    assert boundary == meta["ticks"]
    assert np.isnan(res.raw[:boundary]).all()
    np.testing.assert_array_equal(res.raw[boundary:], ref.raw[boundary:])
    np.testing.assert_array_equal(res.log_likelihood[boundary:], ref.log_likelihood[boundary:])
    np.testing.assert_array_equal(res.alerts[boundary:], ref.alerts[boundary:])
    # every alert exactly once across the crash, byte for byte
    with open(tmp_path / "ref.jsonl") as f:
        want = f.readlines()
    with open(alerts) as f:
        assert f.readlines() == want


# the child imports the port only (no JAX): Feed's source and the test's
# config are handed over as text
_DRILL_CHILD = r"""
import json, os, pathlib, sys, zlib
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.resilience.journal import TickJournal
from rtap_tpu_torch.service.checkpoint import peek_resume_ticks
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry
{feed_src}

work, total, kill_tick, kill_save = {work!r}, {total}, {kill_tick}, {kill_save}
if kill_save:
    # die between the two renames of group 1's swap: its directory is
    # gone, its previous checkpoint sits in .old-*, the new one in .tmp-*
    _rename = pathlib.Path.rename
    def rename(self, target):
        if ".group0001.tmp-" in self.name and json.loads(
                (self / "meta.json").read_text())["ticks"] >= kill_save:
            os._exit(9)
        return _rename(self, target)
    pathlib.Path.rename = rename
journal = TickJournal(os.path.join(work, "journal"), segment_bytes=2048)
ck = os.path.join(work, "ck")
base = max(journal.next_tick, peek_resume_ticks(ck))
reg = StreamGroupRegistry(ModelConfig.from_dict(json.loads({cfg!r})), group_size=3,
                          device="cpu", threshold={threshold!r}, debounce=2)
for sid in {ids!r}:
    reg.add_stream(sid)
reg.finalize()


class Dying(Feed):
    def __call__(self, k):
        if self.base + k == kill_tick:
            os._exit(9)
        return Feed.__call__(self, k)


feed = Dying(reg.dispatch_ids(), base=base)
stats = live_loop(feed, reg, n_ticks=total - base, cadence_s=0.0,
                  alert_path=os.path.join(work, "alerts.jsonl"), checkpoint_dir=ck,
                  checkpoint_every=8, pipeline_depth=2, journal=journal)
journal.close()
print(json.dumps({{"base": base, "ticks": stats["ticks"], "journal": stats["journal"]}}))
"""


def _records(path):
    by_id, dup = {}, []
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        if line.startswith('{"event"'):
            continue
        try:
            aid = json.loads(line).get("alert_id")
        except ValueError:
            continue  # a torn fragment from a kill mid-write
        if aid in by_id:
            dup.append(aid)
        by_id[aid] = line
    return by_id, dup


def test_two_kill_drill_exactly_once_and_bit_identical(tmp_path):
    total = 48
    _, ref_reg = _serve_once("torch", str(tmp_path / "ref"), total)
    want, _ = _records(tmp_path / "ref" / "alerts.jsonl")
    work = str(tmp_path / "crash")
    runs = []
    for kill_tick, kill_save in ((13, 0), (0, 20), (0, 0)):
        child = _DRILL_CHILD.format(
            repo=REPO, feed_src=inspect.getsource(Crash) + inspect.getsource(Feed),
            cfg=json.dumps(CFG.to_dict()), threshold=THRESHOLD, ids=IDS, work=work,
            total=total, kill_tick=kill_tick, kill_save=kill_save)
        proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                              text=True, timeout=600)
        runs.append(proc)
        expect = 9 if (kill_tick or kill_save) else 0
        assert proc.returncode == expect, f"rc={proc.returncode}\n{proc.stderr[-3000:]}"
    last = json.loads(runs[-1].stdout.strip().splitlines()[-1])
    assert last["base"] == 21 and last["ticks"] == total - 21
    got, dup = _records(os.path.join(work, "alerts.jsonl"))
    assert not dup, dup[:5]
    assert got.keys() == want.keys() and len(want) > 0
    assert all(got[k] == want[k] for k in want)
    for gi, ref_grp in enumerate(ref_reg.groups):
        back = load_group(os.path.join(work, "ck", f"group{gi:04d}"), device="cpu")
        _assert_states_equal(_state("torch", ref_grp), _state("torch", back))
    # the residue of the swap killed between its renames is swept
    assert sorted(os.listdir(os.path.join(work, "ck"))) == ["group0000", "group0001"]


def test_serve_cli_tcp_scores_pushed_records(tmp_path):
    from rtap_tpu_torch.service.sources import send_jsonl

    alerts = tmp_path / "alerts.jsonl"
    ids_file = tmp_path / "ids.txt"
    ids_file.write_text("a\n\nb\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams", "@" + str(ids_file),
         "--ticks", "5", "--cadence", "0.2", "--device", "cpu", "--port", "0",
         "--columns", "32", "--no-aot-warmup", "--alerts", str(alerts),
         "--journal-dir", str(tmp_path / "j"), "--checkpoint-dir", str(tmp_path / "ck"),
         "--checkpoint-every", "2", "--pipeline-depth", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = None
    lines = []

    def read_stderr():
        nonlocal port
        for line in proc.stderr:
            lines.append(line)
            if "listening for JSONL records on" in line:
                port = int(line.rsplit(":", 1)[1])

    threading.Thread(target=read_stderr, daemon=True).start()
    deadline = time.time() + 120
    while port is None and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    assert port, (proc.poll(), "".join(lines)[-2000:])
    stop = threading.Event()

    def produce():
        k = 0
        while not stop.is_set():
            send_jsonl(("127.0.0.1", port), [{"id": "a", "value": 40 + k, "ts": 1_700_000_000 + k},
                                             {"id": "b", "value": 60 - k, "ts": 1_700_000_000 + k}])
            k += 1
            time.sleep(0.05)

    threading.Thread(target=produce, daemon=True).start()
    out, _ = proc.communicate(timeout=300)
    stop.set()
    assert proc.returncode == 0, "".join(lines)[-2000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["ticks"] == 5 and stats["scored"] == 10 and "latency_p50_ms" in stats
    assert stats["device"] == "cpu" and stats["records_parsed"] > 0
    assert stats["parse_errors"] == 0 and stats["unknown_ids"] == 0
    assert stats["checkpoints_saved"] >= 2 and stats["journal"]["appended_ticks"] == 5
    assert sorted(os.listdir(tmp_path / "ck")) == ["group0000"]
    assert 0 <= stats["missing_values"] <= stats["scored"]
    # the child's telemetry registry, read at exit, agrees with its stats
    tel = {m["name"]: m["value"] for m in stats["telemetry"]["metrics"] if "labels" not in m}
    assert tel["rtap_obs_ticks_total"] == 5 and tel["rtap_obs_scored_total"] == 10
    # the source syncs its tallies into the registry at each poll; the
    # producer runs on past the last one
    assert 0 < tel["rtap_obs_ingest_records_total"] <= stats["records_parsed"]


def _unported_argv():
    from rtap_tpu_torch.__main__ import UNPORTED_SERVE_FLAGS

    cases = [(flag, [flag, "1"] if takes_value else [flag])
             for flag, (takes_value, _) in UNPORTED_SERVE_FLAGS.items()]
    return cases + [("--shard", ["--shard", "1"]),
                    ("--dispatch-threads", ["--dispatch-threads", "4"])]


@pytest.mark.parametrize("flag,extra", _unported_argv(), ids=lambda v: v if isinstance(v, str) else "")
def test_unported_serve_flag_exits_2_naming_it(capsys, flag, extra):
    from rtap_tpu_torch.__main__ import main

    assert main(["serve", "--streams", "a", "--device", "cpu", *extra]) == 2
    err = capsys.readouterr().err
    assert flag in err and "not ported" in err


def test_serve_refuses_without_cuda(monkeypatch, tmp_path):
    from rtap_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["serve", "--streams", "a,b", "--ticks", "1"],
                 ["serve", "--streams", "a", "--device", "cuda", "--ticks", "1",
                  "--journal-dir", str(tmp_path / "j")]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert not (tmp_path / "j").exists()  # refused before the journal opened


USAGE_CASES = {
    "predict-knob-without-predict": ["--predict-horizon", "4"],
    "predict-threshold-without-predict": ["--predict-threshold", "0.5"],
    "predict-min-ticks-without-predict": ["--predict-min-ticks", "6"],
    "predict-horizon-0": ["--predict", "--predict-horizon", "0"],
    "predict-min-ticks-0": ["--predict", "--predict-min-ticks", "0"],
    "correlate-without-topology": ["--correlate-window", "5"],
    "correlate-min-without-topology": ["--correlate-min-streams", "3"],
    "topology-without-alerts": ["--topology", "infer"],
    "correlate-window-0": ["--topology", "infer", "--alerts", "a.jsonl",
                           "--correlate-window", "0"],
    "correlate-min-streams-1": ["--topology", "infer", "--alerts", "a.jsonl",
                                "--correlate-min-streams", "1"],
}


@pytest.mark.parametrize("case", list(USAGE_CASES))
def test_serve_model_side_usage_error_is_the_jax_message(capsys, case):
    from rtap_tpu.__main__ import main as j_main
    from rtap_tpu_torch.__main__ import main

    argv = ["serve", "--streams", "a", *USAGE_CASES[case]]
    assert j_main(argv) == 2
    want = capsys.readouterr().err
    assert main([*argv, "--device", "cpu"]) == 2
    assert capsys.readouterr().err == want and want.startswith("serve: ")


@pytest.mark.parametrize("argv,needle", [
    (["--predict", "--predict-threshold", "1.5"], "serve: bad --predict parameters: threshold"),
    (["--health", "--health-drift-threshold", "0"], "serve: bad --health parameters: drift"),
    (["--topology", "/nonexistent/topo.json", "--alerts", "a.jsonl"], "serve: bad --topology"),
])
def test_serve_bad_model_side_values_exit_2(capsys, argv, needle):
    from rtap_tpu_torch.__main__ import main

    assert main(["serve", "--streams", "a", "--device", "cpu", *argv]) == 2
    assert capsys.readouterr().err.startswith(needle)


def test_serve_bumps_the_run_epoch_beside_the_alerts(tmp_path, capsys):
    """Every serve start with --alerts bumps <alerts>.epoch, whatever the
    other flags, as the JAX serve does."""
    from rtap_tpu_torch.__main__ import main

    alerts = str(tmp_path / "alerts.jsonl")
    for want in (1, 2):
        assert main(["serve", "--streams", "a", "--device", "cpu", "--columns", "32",
                     "--ticks", "1", "--cadence", "0", "--port", "0",
                     "--alerts", alerts]) == 0
        capsys.readouterr()
        assert json.loads(open(alerts + ".epoch").read())["epoch"] == want


def test_serve_cli_model_side_flags_over_tcp(tmp_path):
    """`serve --health --predict --topology infer` through the operator
    command: armed on stderr, the trackers' blocks in the stats line, the
    correlator's sidecar and the run epoch beside the alerts."""
    from rtap_tpu_torch.service.sources import send_jsonl

    alerts = tmp_path / "alerts.jsonl"
    ids = ["web-00.cpu", "web-01.cpu", "db-00.cpu"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams", ",".join(ids),
         "--ticks", "6", "--cadence", "0.2", "--device", "cpu", "--port", "0",
         "--columns", "32", "--alerts", str(alerts), "--health", "--predict",
         "--predict-horizon", "2", "--topology", "infer", "--correlate-window", "5",
         "--pipeline-depth", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = None
    lines = []

    def read_stderr():
        nonlocal port
        for line in proc.stderr:
            lines.append(line)
            if "listening for JSONL records on" in line:
                port = int(line.rsplit(":", 1)[1])

    threading.Thread(target=read_stderr, daemon=True).start()
    deadline = time.time() + 120
    while port is None and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    assert port, (proc.poll(), "".join(lines)[-2000:])
    stop = threading.Event()

    def produce():
        k = 0
        while not stop.is_set():
            send_jsonl(("127.0.0.1", port), [{"id": s, "value": 40 + k + i,
                                              "ts": int(time.time()) + 60 + k}
                                             for i, s in enumerate(ids)])
            k += 1
            time.sleep(0.05)

    threading.Thread(target=produce, daemon=True).start()
    out, _ = proc.communicate(timeout=300)
    stop.set()
    err = "".join(lines)
    assert proc.returncode == 0, err[-2000:]
    for armed in ("incident correlation armed (inferred; window 5s, min 3 streams)",
                  "model-health reducers armed", "predictive horizon armed (k=2 ticks",
                  "blast fusion on"):
        assert armed in err
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["ticks"] == 6 and stats["scored"] == 18
    assert stats["health"]["groups"] == 1 and stats["health"]["ticks_folded"] == 6
    assert stats["predict"]["horizon_ticks"] == 2 and stats["predict"]["ticks_folded"] == 6
    assert stats["incidents"]["resume"]["scanned"] == 0
    assert json.loads(open(str(alerts) + ".epoch").read())["epoch"] == 1
    tel = {m["name"]: m["value"] for m in stats["telemetry"]["metrics"] if "labels" not in m}
    assert tel["rtap_obs_run_epoch"] == 1 and tel["rtap_obs_health_fold_seconds"]["count"] == 6


def _preset_cfgs(name):
    from rtap_tpu.config import categorical_preset, composite_preset

    jcfg = {"composite": composite_preset, "categorical": categorical_preset}[name]()
    # a short probation, so alerts flow within the run
    jcfg = dataclasses.replace(jcfg, likelihood=dataclasses.replace(
        jcfg.likelihood, learning_period=10, estimation_samples=5))
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


class CategoryFeed(Feed):
    """Feed's values as small category ids (rounded in the encoder), with
    a NaN gap: one wire value per stream, as a serve source delivers."""

    def value(self, sid, g):
        v = super().value(sid, g)
        return np.nan if g % 13 == 7 else np.floor(v / 9.0)


@pytest.mark.parametrize("name", ["composite", "categorical"])
def test_live_loop_preset_matches_jax(tmp_path, name):
    """serve --preset composite|categorical's loop (one wire value per
    stream, read by every field) on both packages: alert lines byte-equal,
    state bit-equal."""
    jcfg, cfg = _preset_cfgs(name)
    feed_cls = CategoryFeed if name == "categorical" else Feed
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            reg = JReg(jcfg, group_size=3, backend="tpu", threshold=THRESHOLD, debounce=2)
            loop = j_live_loop
        else:
            reg = StreamGroupRegistry(cfg, group_size=3, device="cpu", threshold=THRESHOLD,
                                      debounce=2)
            loop = live_loop
        for sid in IDS:
            reg.add_stream(sid)
        reg.finalize()
        stats = loop(feed_cls(reg.dispatch_ids()), reg, n_ticks=30, cadence_s=0.0,
                     alert_path=str(tmp_path / pkg), pipeline_depth=2)
        out[pkg] = (stats, reg, _alert_lines(tmp_path / pkg))
    (js, jreg, jlines), (ts, treg, tlines) = out["jax"], out["torch"]
    assert tlines == jlines and len(tlines) > 0
    assert ts["scored"] == js["scored"] and ts["alerts"] == js["alerts"]
    for jg, tg in zip(jreg.groups, treg.groups):
        a, b = _state("jax", jg), _state("torch", tg)
        _assert_states_equal(a, b)
        assert ("model/enc_prev" in b) == (name == "composite")


@pytest.mark.parametrize("preset", ["composite", "categorical"])
def test_serve_cli_preset_over_tcp(tmp_path, preset):
    from rtap_tpu_torch.service.sources import send_jsonl

    proc = subprocess.Popen(
        [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams", "a,b,c",
         "--preset", preset, "--ticks", "4", "--cadence", "0.2", "--device", "cpu",
         "--port", "0", "--alerts", str(tmp_path / "alerts.jsonl")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port, lines = [], []

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            if "listening for JSONL records on" in line:
                port.append(int(line.rsplit(":", 1)[1]))

    threading.Thread(target=read_stderr, daemon=True).start()
    deadline = time.time() + 120
    while not port and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    assert port, (proc.poll(), "".join(lines)[-2000:])
    stop = threading.Event()

    def produce():
        k = 0
        while not stop.is_set():
            send_jsonl(("127.0.0.1", port[0]), [
                {"id": sid, "value": float((k + i) % 5), "ts": 1_700_000_000 + k}
                for i, sid in enumerate("abc")])
            k += 1
            time.sleep(0.05)

    threading.Thread(target=produce, daemon=True).start()
    out, _ = proc.communicate(timeout=300)
    stop.set()
    assert proc.returncode == 0, "".join(lines)[-2000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["preset"] == preset and stats["device"] == "cpu"
    assert stats["ticks"] == 4 and stats["scored"] == 12 and stats["parse_errors"] == 0
    assert stats["tm_overflow_total"] == 0


@pytest.mark.parametrize("preset", ["nab", "composite", "categorical"])
def test_serve_preset_with_columns_is_the_jax_usage_error(capsys, preset):
    from rtap_tpu.__main__ import main as j_main
    from rtap_tpu_torch.__main__ import main

    argv = ["serve", "--streams", "a", "--preset", preset, "--columns", "32"]
    assert j_main(argv) == 2
    want = capsys.readouterr().err
    assert main([*argv, "--device", "cpu"]) == 2
    assert capsys.readouterr().err == want and "--columns applies to the cluster" in want


def test_live_loop_records_each_missed_ticks_phase_split():
    """At a real cadence every tick past its deadline is reported with its ms
    per phase, so a slow tick says what it waited on (here: the source)."""
    reg = StreamGroupRegistry(CFG, group_size=4, device="cpu")
    for i in range(4):
        reg.add_stream(f"n{i}.cpu")
    reg.finalize()

    def source(k):
        if k == 2:
            time.sleep(0.3)
        return np.full(4, 30.0 + k, np.float32), 1_700_000_000 + k

    stats = live_loop(source, reg, n_ticks=4, cadence_s=0.25)
    assert stats["missed_deadlines"] == len(stats["missed_tick_phase_ms"]) >= 1
    ticks = [t for t, _ in stats["missed_tick_phase_ms"]]
    assert 2 in ticks
    split = dict(stats["missed_tick_phase_ms"])[2]
    assert set(split) == {"source", "membership", "dispatch", "collect", "emit", "checkpoint"}
    assert split["source"] >= 300.0
    assert "missed_tick_phase_ms" not in live_loop(source, reg, n_ticks=1, cadence_s=0.0)
