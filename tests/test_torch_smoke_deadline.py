"""chip_smoke.py's whole-run deadline, exercised without a card: a script
that imports chip_smoke (and never runs its main) arms a 1 s deadline,
names a phase, and waits under ``run_guarded`` (what chip_smoke's main runs
under) on a child that sleeps 30 s. The run must fail
within a few seconds with the deadline's line naming that phase, exit with
the deadline's code, and leave the child killed. The background process
of the CPU references (``chip_smoke.CpuRefs``) is such a child, and its
failure, or a job it reports failed, fails the run."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import json, subprocess, sys, time
import chip_smoke as cs
cs.DEADLINE.arm(1.0, start=time.monotonic())
cs.DEADLINE.end("23 control plane", 12.5)
cs.DEADLINE.begin("24 imports")


def phase():
    child = cs.spawn_child([sys.executable, "-c", "import time; time.sleep(30)"])
    print(json.dumps({"child": child.pid}), flush=True)
    child.communicate(timeout=cs.DEADLINE.cap(60))
    print("after the wait", flush=True)
    return 0


sys.exit(cs.run_guarded(phase))
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_a_sleeping_child_under_a_1s_deadline_fails_naming_its_phase():
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                       text=True, timeout=60, env={**os.environ, "PYTHONPATH": str(REPO)})
    took = time.monotonic() - t0
    lines = [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
    import chip_smoke

    assert p.returncode == chip_smoke.DEADLINE_RC != 0, (p.returncode, p.stdout, p.stderr)
    assert "after the wait" not in p.stdout
    assert took < 20, took  # the interpreter and torch import, then ~1 s
    end, child, dead = lines[0], lines[1], lines[-1]
    assert end["phase"] == "phase_end" and end["name"] == "23 control plane"
    assert dead["phase"] == "deadline" and dead["running"] == "24 imports"
    assert dead["phase_seconds"] == {"23 control plane": 12.5}
    assert dead["children_killed"] >= 1 and not _alive(child["child"])


def test_an_unarmed_deadline_caps_nothing():
    import chip_smoke

    d = chip_smoke.Deadline()
    assert d.cap(7.5) == 7.5 and not d.passed() and d.left() == float("inf")


BACKGROUND = """
import json, sys, time
import chip_smoke as cs
cs.DEADLINE.arm(1.0, start=time.monotonic())
cs.DEADLINE.begin("11 nab corpus")
cs.BG.start(0, cmd=[sys.executable, "-c", "import time; time.sleep(30)"])
print(json.dumps({"background": cs.BG.proc.pid}), flush=True)
cs.run_guarded(lambda: cs.BG.result("nab_prefix"))
print("after the wait", flush=True)
"""


def test_the_background_references_are_killed_at_the_deadline():
    """The background CPU references' process is one of the run's children:
    a deadline reached while a phase waits for its result kills it."""
    p = subprocess.run([sys.executable, "-c", BACKGROUND], cwd=REPO, capture_output=True,
                       text=True, timeout=60, env={**os.environ, "PYTHONPATH": str(REPO)})
    lines = [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
    import chip_smoke

    assert p.returncode == chip_smoke.DEADLINE_RC, (p.returncode, p.stdout, p.stderr)
    assert "after the wait" not in p.stdout
    bg, dead = lines[0], lines[-1]
    assert dead["phase"] == "deadline" and dead["running"] == "11 nab corpus"
    assert dead["children_killed"] >= 1 and not _alive(bg["background"])


FAILING = {
    # the process ends without the result a phase waits for
    "exited": ("import sys; sys.exit(3)", "exited 3 without eval_cpu"),
    # the job ran and failed: its pickle says so
    "job_failed": ("import os, pickle, sys; d = sys.argv[-1]; "
                   "pickle.dump((False, 'ValueError: boom', 0.5), "
                   "open(os.path.join(d, 'eval_cpu.pkl'), 'wb'))", "eval_cpu failed: ValueError"),
}


@pytest.mark.parametrize("case", list(FAILING))
def test_a_failed_background_reference_fails_the_run(case):
    code, needle = FAILING[case]
    script = (
        "import sys, time\n"
        "import chip_smoke as cs\n"
        "cs.DEADLINE.arm(60.0, start=time.monotonic())\n"
        f"cs.BG.start(0, cmd=[sys.executable, '-c', {code!r}])\n"
        "sys.exit(cs.run_guarded(lambda: (cs.BG.result('eval_cpu'), 0)[1]))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                       timeout=60, env={**os.environ, "PYTHONPATH": str(REPO)})
    import chip_smoke

    assert p.returncode not in (0, chip_smoke.DEADLINE_RC), (p.returncode, p.stderr)
    assert "AssertionError: background CPU references: " + needle in p.stderr, p.stderr[-2000:]
