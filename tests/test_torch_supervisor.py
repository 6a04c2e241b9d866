"""PyTorch port vs the JAX package: serve supervision.

* ``strip_supervise_flags`` equals the JAX package's on a sweep of argv
  forms (``--flag value``, ``--flag=value``, repeated, interleaved).
* ``python -m rtap_tpu_torch serve --supervise`` on the CPU with one
  scheduled ``proc_exit``: the supervisor restarts the child once, the
  journaled child completes its tick budget, and every alert id is
  delivered exactly once (the supervisor's events ride the same stream).
"""

import json
import os
import subprocess
import sys

import pytest

from rtap_tpu.resilience.supervisor import strip_supervise_flags as j_strip
from rtap_tpu_torch.resilience.supervisor import (
    BUDGET_EXHAUSTED_RC,
    Supervisor,
    strip_supervise_flags,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = {
    "none": ["serve", "--streams", "a,b"],
    "bare": ["serve", "--supervise", "--streams", "a"],
    "spaced": ["serve", "--supervise", "--supervise-restarts", "4", "--supervise-backoff",
               "0.1", "--ticks", "9"],
    "equals": ["serve", "--supervise-restarts=4", "--supervise", "--supervise-backoff=0.2",
               "--alerts=x.jsonl"],
    "interleaved": ["serve", "--ticks", "5", "--supervise", "--checkpoint-dir", "ck",
                    "--supervise-restarts", "2", "--journal-dir", "j"],
    "lookalike": ["serve", "--supervised-thing", "1", "--supervise", "--port", "0"],
    "trailing-value": ["serve", "--supervise-backoff"],
    "repeated": ["serve", "--supervise", "--supervise", "--supervise-restarts", "1",
                 "--supervise-restarts", "3", "--streams", "@ids.txt"],
}


@pytest.mark.parametrize("form", list(ARGVS))
def test_strip_supervise_flags_matches_jax(form):
    argv = ARGVS[form]
    assert strip_supervise_flags(argv) == j_strip(argv)
    assert not any(a.split("=", 1)[0] in ("--supervise", "--supervise-restarts",
                                          "--supervise-backoff")
                   for a in strip_supervise_flags(argv))


def test_supervisor_budget_and_clean_exit(tmp_path):
    events = tmp_path / "ev.jsonl"
    die = [sys.executable, "-c", "import sys; sys.exit(7)"]
    sup = Supervisor(die, restart_budget=2, backoff_base_s=0.01, backoff_max_s=0.02,
                     event_path=str(events))
    assert sup.run(install_signals=False) == BUDGET_EXHAUSTED_RC
    assert sup.deaths == 3 and sup.death_rcs == [7, 7, 7]
    kinds = [json.loads(ln)["event"] for ln in open(events)]
    assert kinds.count("serve_child_died") == 3
    assert kinds[-1] == "supervisor_budget_exhausted"
    ok = Supervisor([sys.executable, "-c", "pass"], backoff_base_s=0.01)
    assert ok.run(install_signals=False) == 0 and ok.deaths == 0
    # a usage error (rc 2) fails fast instead of burning the budget
    usage = Supervisor([sys.executable, "-c", "import sys; sys.exit(2)"], backoff_base_s=0.01)
    assert usage.run(install_signals=False) == 2 and usage.deaths == 0


def test_supervised_serve_restarts_once_and_delivers_every_alert_once(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"seed": 0, "faults": [{"kind": "proc_exit", "tick": 4}]}))
    alerts = tmp_path / "alerts.jsonl"
    cmd = [sys.executable, "-m", "rtap_tpu_torch", "serve", "--supervise",
           "--supervise-backoff", "0.05", "--streams", "a,b,c", "--device", "cpu",
           "--columns", "32", "--ticks", "8", "--cadence", "0.05", "--port", "0",
           "--threshold=-1e9", "--debounce", "1", "--alerts", str(alerts),
           "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3",
           "--journal-dir", str(tmp_path / "j"), "--chaos-spec", str(spec)]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    stats = json.loads(p.stdout.strip().splitlines()[-1])
    # the second life resumed at tick 5 (the killing tick is journaled) and
    # ran the rest of the 8-tick budget
    assert stats["ticks"] == 3
    assert "resuming at tick 5" in p.stderr
    lines = [json.loads(ln) for ln in open(alerts)]
    events = [e["event"] for e in lines if "event" in e]
    assert events.count("serve_child_died") == 1 and events.count("serve_child_restarting") == 1
    assert "journal_replayed" in events and events[-1] == "serve_child_completed"
    died = next(e for e in lines if e.get("event") == "serve_child_died")
    assert died["rc"] == 86
    ids = [e["alert_id"] for e in lines if "alert_id" in e]
    assert len(ids) == len(set(ids)) == 3 * 8
