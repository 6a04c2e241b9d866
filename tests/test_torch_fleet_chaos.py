"""The fleet chaos drill on the CPU, held to the JAX package (the port of
tests/integration/test_fleet_chaos.py::test_fleet_chaos_drill_smoke):

* ``python -m rtap_tpu_torch.fleet_chaos --device cpu`` at the JAX twin's
  config (seed 3, 120 ticks, 4 streams in groups of 2; cadence 0.25 s and a
  1 s lease instead of the twin's 0.1 s, as tests/test_torch_failover.py
  paces its soak, so that the xdist load cannot starve a heartbeat) passes
  every assertion of the twin: 2 leader kills, the standby kill, the
  control plane's outage survived, the fence round's rc 7, the drain's rc 0,
  exactly-once per shard, strictly rising grants, degraded ticks counted;
* each shard's fault-free reference ends on the leaves and alert records of
  the JAX drill's reference child for that shard (``scripts/fleet_chaos.py
  --child --ref``, its device path, JAX on the CPU, run beside the drill),
  exactly, and each spliced shard stream carries exactly those records;
* every JAX flag exists with its default, ``--device`` in place of
  ``--backend``;
* the orchestrator imports no torch.

Every child runs with one intra-op thread and every subprocess carries a
timeout.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from rtap_tpu_torch.chaos_soak import parse_alert_stream
from rtap_tpu_torch.fleet_chaos import build_parser, resolve_defaults
from tests.test_torch_failover import _assert_same_leaves, _env

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS, STREAMS = 120, 4
DRILL = ["--seed", "3", "--ticks", str(TICKS), "--streams", str(STREAMS), "--group-size", "2",
         "--cadence", "0.25", "--lease-timeout", "1.0"]
# every flag of scripts/fleet_chaos.py with its default (lease, outage and
# grace are derived from the cadence when not given)
JAX_FLAGS = {"--seed": 0, "--streams": 6, "--group-size": 3, "--ticks": 160, "--cadence": 0.12,
             "--checkpoint-every": 7, "--threshold": -1e9, "--lease-timeout": None,
             "--takeover-budget": 10, "--outage": None, "--control-grace": None,
             "--spike-every": 13, "--workdir": None, "--out": None}


def _jax_ref(work, shard: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "fleet_chaos.py"), "--child", "--ref",
         "--workdir", str(work), "--shard", str(shard), *DRILL, "--checkpoint-every", "7",
         "--backend", "tpu", "--threshold=-1e9", "--spike-every", "13",
         "--stats-out", str(work / "stats.jsonl")],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def test_fleet_chaos_drill_and_the_jax_references(tmp_path):
    jrefs = [_jax_ref(tmp_path / f"jax-ref{i}", i) for i in range(2)]
    out = tmp_path / "report.json"
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "rtap_tpu_torch.fleet_chaos", *DRILL, "--device", "cpu",
             "--workdir", str(tmp_path / "w"), "--out", str(out)],
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=400)
        jerrs = [p.communicate(timeout=300)[1] for p in jrefs]
    finally:
        for p in jrefs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert proc.returncode == 0, f"fleet chaos rc={proc.returncode}\n{proc.stderr[-4000:]}"
    report = json.loads(out.read_text())
    # the JAX twin's assertions
    assert report["verified"], report["failures"]
    assert len(report["leader_kills"]) == 2
    assert report["standby_kill"] is not None
    assert report["control_outage"]["leaders_survived"]
    assert report["fence_round"]["rc"] == 7
    assert report["drain_round"]["rc"] == 0
    for s in report["shards_verdict"]:
        assert s["duplicated"] == 0 and s["lost"] == 0 and s["extra"] == 0
        assert s["alert_ids"] > 0 and s["state_leaves_compared"] > 0
        assert s["alert_ids"] == STREAMS * TICKS
        assert all(p["detect_ticks"] <= 10 for p in s["promotions"])
    for eps in report["control_journal"]["grants_per_shard"].values():
        assert eps == sorted(set(eps)), eps
    assert report["degraded_ticks_stats"] > 0
    assert not report["unscheduled_fences"]
    # each reference learned every tick of its two groups
    assert [r["learned_group_ticks"] for r in report["reference_lines"]] == [2 * TICKS] * 2
    for i, p in enumerate(jrefs):
        assert p.returncode == 0, jerrs[i][-3000:]
        # the port's fault-free reference is the JAX package's, leaves and records
        jref, tref = tmp_path / f"jax-ref{i}", tmp_path / "w" / f"ref{i}"
        _assert_same_leaves(jref / "ck", tref / "ck")
        want = parse_alert_stream(str(jref / "alerts.jsonl"))["alerts"]
        assert parse_alert_stream(str(tref / "alerts.jsonl"))["alerts"] == want
        assert len(want) == STREAMS * TICKS
        # and the spliced shard stream carries exactly those records
        got = parse_alert_stream(str(tmp_path / "w" / f"shard{i}" / "alerts.jsonl"))
        assert got["alerts"] == want and not got["dup"]


def test_every_jax_flag_with_its_default_and_device_for_backend():
    jhelp = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "fleet_chaos.py"),
                            "--help"], env=_env(), capture_output=True, text=True,
                           timeout=120).stdout
    jflags = set(re.findall(r"^\s+(?:-\w, )?(--[a-z-]+)", jhelp, re.M))
    assert jflags == set(JAX_FLAGS) | {"--backend", "--help"}
    parser = build_parser()
    port = {o for a in parser._actions for o in a.option_strings
            if o.startswith("--") and a.help != argparse.SUPPRESS}
    assert port == set(JAX_FLAGS) | {"--device", "--help"}
    args = parser.parse_args([])
    for flag, want in JAX_FLAGS.items():
        assert getattr(args, flag[2:].replace("-", "_")) == want, flag
    assert args.device == "cuda"  # the card unless the caller asks for the CPU
    got = resolve_defaults(args)
    assert (got.lease_timeout, got.outage, got.control_grace) == \
        pytest.approx((0.48, 2.4, 30.0))
    got = resolve_defaults(parser.parse_args(["--cadence", "1"]))
    assert (got.lease_timeout, got.outage, got.control_grace) == (4.0, 20.0, 200.0)


def test_the_orchestrator_imports_no_torch(tmp_path):
    """Importing the drill, building its parser and running its verdict
    readers (alert streams, checkpoints, the control journal) leave torch
    unloaded: the orchestrator starts in a fraction of a torch import."""
    (tmp_path / "a.jsonl").write_text("")
    (tmp_path / "ck").mkdir()
    code = (
        "import sys\n"
        "import rtap_tpu_torch.fleet_chaos as fc\n"
        "fc.build_parser().parse_args([])\n"
        "from rtap_tpu_torch.chaos_soak import compare_states, parse_alert_stream\n"
        "from rtap_tpu_torch.fleet import FleetAggregator\n"
        "from rtap_tpu_torch.fleet.control import read_control_journal\n"
        f"parse_alert_stream({str(tmp_path / 'a.jsonl')!r})\n"
        f"compare_states({str(tmp_path / 'ck')!r}, {str(tmp_path / 'ck')!r}, [])\n"
        f"read_control_journal({str(tmp_path)!r})\n"
        "print('torch' in sys.modules)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "False"
