"""``python -m rtap_tpu_torch.chaos_soak`` on the CPU, held to the JAX
package's ``scripts/chaos_soak.py`` contract:

* the seeded soak at tests/integration/test_chaos_soak.py's shape (6
  streams in 3 groups, 40 ticks, rate 0.12, full-width cluster preset) is
  "verified" for seeds 1 and 3, its schedule digest the JAX package's, every
  bundle valid, and with ``--inject`` quarantines that restore under the
  twin check;
* ``--supervise --kills 1``: one restart, the budget done, journal
  recovery, every alert id once;
* ``--topology-burst`` at the JAX drill's defaults: exactly one incident
  over the flooded nodes;
* ``--degrade``: the ladder engages and recovers;
* ``--replication`` exits 2 naming the queue item.
"""

import json
import os
import subprocess
import sys

import pytest

from rtap_tpu.resilience import ChaosSpec as JSpec
from rtap_tpu_torch.chaos_soak import main
from rtap_tpu_torch.obs import validate_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--columns", "32"]


def _run(tmp_path, *argv):
    out = tmp_path / "report.json"
    rc = main([*argv, "--workdir", str(tmp_path / "wd"), "--out", str(out)])
    return rc, json.loads(out.read_text())


@pytest.mark.parametrize("seed", [1, 3])
def test_seeded_soak_verified_with_the_jax_digest(tmp_path, seed):
    rc, report = _run(tmp_path, "--seed", str(seed), "--streams", "6", "--group-size", "2",
                      "--ticks", "40", "--cadence", "0.02", "--rate", "0.12",
                      "--device", "cpu")
    assert rc == 0 and report["verified"] and report["failures"] == []
    assert report["stats"]["ticks"] == 40
    assert report["schedule_digest"] == JSpec.generate(seed=seed, n_ticks=40, n_groups=3,
                                                       rate=0.12).digest()
    for inj in report["faults_injected"]:
        assert 0 <= inj["tick"] < 40 and "kind" in inj
    pm = report["postmortem"]
    assert pm["valid"] == len(pm["bundles"]) and pm["trace_records"] > 0
    if report["quarantines"]:
        assert pm["bundles"] and pm["spans"] > 0 and pm["events"] > 0
    for b in pm["bundles"]:
        assert validate_bundle(os.path.join(pm["dir"], b))["ok"]


def test_injected_quarantines_restore_and_untouched_groups_match_the_twin(tmp_path):
    rc, report = _run(tmp_path, "--seed", "1", "--streams", "12", "--group-size", "3",
                      "--ticks", "50", "--cadence", "0.0", "--checkpoint-every", "10",
                      "--inject", "collect_exception@25:1",
                      "--inject", "dispatch_exception@33:2", "--twin", *SMALL)
    assert rc == 0, report["failures"]
    assert report["quarantines"] == report["restores"] == 2 and report["unrestored"] == []
    assert report["run_digest"] != report["schedule_digest"]
    assert report["twin"]["leaves_equal"] and report["twin"]["groups_compared"] == [0, 3]
    assert len(report["stats"]["restore_s"]) == 2


def test_supervised_soak_restarts_and_delivers_once(tmp_path):
    rc, report = _run(tmp_path, "--supervise", "--kills", "1", "--seed", "1",
                      "--streams", "6", "--group-size", "3", "--ticks", "24",
                      "--cadence", "0.02", "--checkpoint-every", "5", *SMALL)
    assert rc == 0, report["failures"]
    assert report["deaths"] == report["restarts"] == 1
    assert report["ticks_completed"] == 24 and report["duplicated"] == 0
    assert report["journal_replay_events"] >= 1
    # threshold floor: every stream alerts every tick; the schedule's sink
    # faults drop some lines, none is delivered twice
    assert 0 < report["alert_ids"] <= 6 * 24


def test_topology_burst_pages_one_incident(tmp_path):
    # tests/integration/test_workloads_serve.py's drill: the defaults, full width
    rc, report = _run(tmp_path, "--topology-burst", "--seed", "1", "--cadence", "0.01",
                      "--device", "cpu")
    assert rc == 0, report["failures"]
    assert report["incidents"] == 1
    assert sorted(report["incident"]["nodes"]) == report["burst_nodes"] == ["n1", "n2"]
    assert len(report["burst_groups"]) >= 2


def test_degrade_drill_engages_and_recovers(tmp_path):
    rc, report = _run(tmp_path, "--degrade", "--seed", "1", "--streams", "6",
                      "--group-size", "3", "--ticks", "110", "--cadence", "0.05", *SMALL)
    assert rc == 0, report["failures"]
    deg = report["degradation"]
    assert deg["max_level"] >= 1 and deg["level"] == 0
    assert report["events"]["degraded"] == report["events"]["recovered"] >= 1
    assert report["learned_group_ticks"] < report["group_ticks"]


def test_replication_waits_for_its_slice(capsys):
    assert main(["--replication"]) == 2
    assert "M5" in capsys.readouterr().err


def test_module_entry_point_runs(tmp_path):
    p = subprocess.run([sys.executable, "-m", "rtap_tpu_torch.chaos_soak", "--seed", "2",
                        "--streams", "3", "--group-size", "3", "--ticks", "6",
                        "--cadence", "0", *SMALL, "--workdir", str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["verified"]
