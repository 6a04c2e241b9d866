"""Child-process supervision for serve: crash, restart, catch up.

The port's copy of the JAX package's ``resilience/supervisor.py``. The
journal + checkpoint stack (resilience/journal.py, service/checkpoint.py)
makes a serve process RESUMABLE after a hard death; this module makes it
RESUMED without a human: ``serve --supervise`` runs the real serve loop in
a child process (``python -m rtap_tpu_torch serve``) and the
:class:`Supervisor` restarts it after every abnormal death with
exponential backoff and a restart budget. Each death is recorded as a
structured event on the incident stream (the alert JSONL file — the same
file the child writes) and, when a postmortem dir is armed, as a
death-marker JSON next to the child's own flight-recorder bundles
(SIGKILL leaves no in-process black box; the marker + journal ARE the
black box).

The supervisor never touches the card: it imports neither torch nor the
model stack, so the child owns the device.

Exit semantics: the child completing with rc 0 ends supervision with 0;
exhausting the restart budget exits 3 (the deaths are in the event
stream); a SIGTERM/SIGINT to the supervisor forwards to the child, waits,
and exits with the child's code. ``python -m rtap_tpu_torch.chaos_soak
--supervise`` drives this class with a seeded proc_exit schedule and
verifies the resumed run's alert stream is exactly-once.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time

from rtap_tpu_torch.obs import get_registry

__all__ = ["Supervisor", "strip_supervise_flags"]

#: serve CLI flags the supervisor consumes itself (value count follows);
#: strip_supervise_flags removes them when building the child argv
SUPERVISE_FLAGS = {
    "--supervise": 0,
    "--supervise-restarts": 1,
    "--supervise-backoff": 1,
}

#: exit code when the restart budget is exhausted
BUDGET_EXHAUSTED_RC = 3


def strip_supervise_flags(argv: list[str]) -> list[str]:
    """The child serve argv: the supervisor's own flags removed, every
    other flag passed through verbatim (both ``--flag value`` and
    ``--flag=value`` forms)."""
    out: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        name = arg.split("=", 1)[0]
        if name in SUPERVISE_FLAGS:
            i += 1
            if "=" not in arg:
                i += SUPERVISE_FLAGS[name]
            continue
        out.append(arg)
        i += 1
    return out


class Supervisor:
    """Run `cmd` as a child process; restart on abnormal death.

    - ``restart_budget``: maximum abnormal deaths tolerated; one more
      exits :data:`BUDGET_EXHAUSTED_RC`.
    - backoff: ``backoff_base_s * 2**(consecutive_fast_deaths - 1)``
      capped at ``backoff_max_s``; a child that stayed up at least
      ``healthy_after_s`` resets the exponent (a long-lived serve that
      finally dies deserves a fast restart, a crash loop does not).
    - ``event_path``: JSONL file for supervisor events (pass the serve
      run's ``--alerts`` file so deaths interleave with the incident
      stream); ``postmortem_dir``: death-marker JSONs land here.
    - ``log``: optional callable(str) for operator feedback (the CLI
      passes a stderr printer; this module itself never prints).
    """

    def __init__(self, cmd: list[str], restart_budget: int = 10,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 30.0,
                 healthy_after_s: float = 60.0, event_path: str | None = None,
                 postmortem_dir: str | None = None, env: dict | None = None,
                 log=None):
        if restart_budget < 0:
            raise ValueError(
                f"restart_budget must be >= 0; got {restart_budget}")
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError(
                "need 0 < backoff_base_s <= backoff_max_s; got "
                f"{backoff_base_s}, {backoff_max_s}")
        self.cmd = list(cmd)
        self.restart_budget = int(restart_budget)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.healthy_after_s = float(healthy_after_s)
        self.event_path = event_path
        self.postmortem_dir = postmortem_dir
        self.env = env
        self._log = log or (lambda msg: None)
        self.child: subprocess.Popen | None = None
        self.deaths = 0
        self.death_rcs: list[int] = []  # raw rc per abnormal death
        self.kill_signals: list[int] = []  # signal number (0 = exited)
        self._stop = threading.Event()
        self._obs_restarts = get_registry().counter(
            "rtap_obs_supervisor_restarts_total",
            "serve child processes restarted after an abnormal death")
        # the dashboard-facing restart counter. Lives
        # in the PARENT (which survives every child death), cumulative
        # over the supervision run — joined with the child-side
        # rtap_obs_run_epoch gauge it lets dashboards tell a restart's
        # counter reset from a rollover.
        self._obs_restarts_cum = get_registry().counter(
            "rtap_obs_restarts_total",
            "cumulative serve child restarts over this supervision run "
            "(parent-process registry; pairs with the child's "
            "rtap_obs_run_epoch gauge)")

    # ---- event plumbing ---------------------------------------------
    def _event(self, event: dict) -> None:
        """Best-effort structured event: one JSONL line, appended +
        flushed (the incident stream must tell the restart story even
        if nothing else survived the death)."""
        line = json.dumps({"event": event["event"], **event,
                           "supervisor_pid": os.getpid()})
        self._log(f"supervisor: {line}")
        if not self.event_path:
            return
        try:
            # heal a torn tail first: the child was very possibly killed
            # mid-write, and appending straight after its partial line
            # would merge THIS event into one unparseable fragment
            from rtap_tpu_torch.service.alerts import heal_torn_tail

            heal_torn_tail(self.event_path)
            with open(self.event_path, "a") as f:
                f.write(line + "\n")
                f.flush()
        except OSError:
            pass

    def _death_marker(self, rc: int, uptime_s: float) -> None:
        if not self.postmortem_dir:
            return
        try:
            os.makedirs(self.postmortem_dir, exist_ok=True)
            path = os.path.join(
                self.postmortem_dir,
                f"supervisor-death-{self.deaths:03d}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"rc": rc,
                           "signal": -rc if rc < 0 else None,
                           "uptime_s": round(uptime_s, 3),
                           "deaths": self.deaths,
                           "wall_time": time.time(),
                           "cmd": self.cmd}, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            pass

    # ---- run loop ----------------------------------------------------
    def request_stop(self) -> None:
        """Stop supervising: terminate the child and return its rc."""
        self._stop.set()
        child = self.child
        if child is not None and child.poll() is None:
            try:
                child.terminate()
            except OSError:
                pass

    def _wait(self) -> int:
        while True:
            try:
                return self.child.wait(timeout=0.2)
            except subprocess.TimeoutExpired:
                if self._stop.is_set():
                    try:
                        self.child.terminate()
                    except OSError:
                        pass
                    try:
                        return self.child.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        self.child.kill()
                        return self.child.wait()

    def run(self, install_signals: bool = True) -> int:
        """Supervise until the child completes cleanly, the budget is
        exhausted, or a stop is requested. Returns the final exit code."""
        prev: dict = {}
        if install_signals:
            def _on_signal(*_):
                self.request_stop()
                for s, h in prev.items():
                    signal.signal(s, h)

            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    prev[sig] = signal.signal(sig, _on_signal)
            except ValueError:
                prev = {}  # not the main thread: caller owns signals
        consecutive_fast = 0
        try:
            while True:
                t0 = time.monotonic()
                # restart-lineage handoff: each incarnation learns how
                # many predecessors died and how the last one went
                env = dict(self.env if self.env is not None
                           else os.environ)
                env["RTAP_SUPERVISED_RESTARTS"] = str(self.deaths)
                if self.death_rcs:
                    env["RTAP_SUPERVISED_LAST_RC"] = \
                        str(self.death_rcs[-1])
                self.child = subprocess.Popen(self.cmd, env=env)
                rc = self._wait()
                uptime = time.monotonic() - t0
                if self._stop.is_set():
                    self._event({"event": "supervisor_stopped", "rc": rc})
                    return rc
                if rc == 0:
                    self._event({"event": "serve_child_completed",
                                 "uptime_s": round(uptime, 3),
                                 "deaths": self.deaths})
                    return 0
                if rc == 2:
                    # usage/config error (argparse, bad flag values):
                    # deterministic and unhealable by restarting — fail
                    # fast instead of burning the budget on doomed
                    # respawns that bury the real flag error
                    self._event({"event": "serve_child_config_error",
                                 "rc": rc, "uptime_s": round(uptime, 3)})
                    return rc
                self.deaths += 1
                self.death_rcs.append(rc)
                self.kill_signals.append(-rc if rc < 0 else 0)
                self._event({"event": "serve_child_died", "rc": rc,
                             "signal": -rc if rc < 0 else None,
                             "uptime_s": round(uptime, 3),
                             "deaths": self.deaths})
                self._death_marker(rc, uptime)
                if self.deaths > self.restart_budget:
                    self._event({"event": "supervisor_budget_exhausted",
                                 "deaths": self.deaths,
                                 "budget": self.restart_budget})
                    return BUDGET_EXHAUSTED_RC
                consecutive_fast = (consecutive_fast + 1
                                    if uptime < self.healthy_after_s else 1)
                delay = min(self.backoff_max_s,
                            self.backoff_base_s
                            * (2 ** (consecutive_fast - 1)))
                self._obs_restarts.inc()
                self._obs_restarts_cum.inc()
                self._event({"event": "serve_child_restarting",
                             "delay_s": round(delay, 3),
                             "restart": self.deaths})
                if self._stop.wait(delay):
                    return rc
        finally:
            for sig, h in prev.items():
                try:
                    signal.signal(sig, h)
                except ValueError:
                    pass
