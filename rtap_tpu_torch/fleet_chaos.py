"""Fleet-wide chaos drill: failover as a routine operation.

    python -m rtap_tpu_torch.fleet_chaos --seed 0 [--streams 6] [--group-size 3]
        [--ticks 160] [--cadence 0.12] [--checkpoint-every 7] [--device cuda|cpu]
        [--threshold X] [--lease-timeout S] [--takeover-budget N] [--outage S]
        [--control-grace S] [--spike-every N] [--workdir DIR] [--out report.json]

The port of the JAX package's ``scripts/fleet_chaos.py``, the fleet-scale
generalisation of ``failover_soak``: TWO shards, each an HA pair (leader +
hot standby) holding its fencing epoch through a shared CONTROL-PLANE
process (``python -m rtap_tpu_torch serve --control-only``,
fleet/control.py) instead of a lease file, all under one fleet
observability aggregator hosted here. A seeded schedule then drills every
failure class in one run:

- SIGKILL the CURRENT leader of each shard (2 leader kills);
- SIGKILL a hot STANDBY (the plane must see DOWN -> rejoined; the
  leader's tick stream must not care);
- SIGKILL the CONTROL PLANE and restart it from its write-ahead epoch
  journal: during the outage every data plane keeps ticking on its cached
  lease (degraded ticks counted, no stalled tick), and the restarted plane
  recovers epochs exactly (never re-granting one);
- a SIGSTOP/SIGCONT zombie-fence round (the woken old leader must exit
  ``FENCED_RC``, its in-flight alerts fence-dropped);
- one rolling-upgrade DRAIN: ``control_drain`` marks the shard, the leader
  exits orderly (releasing the lease, BYE reason=drain), the standby takes
  over at once, the old leader rejoins as standby.

Verdict: per shard, the spliced alert stream and final model state must be
EXACTLY-ONCE and BIT-IDENTICAL to a fault-free reference over the same
seeded feed; every scheduled takeover must be visible through the FLEET
PLANE (old leader DOWN -> role_changed on the successor, judged by
fleet/verdict.py) at epochs equal to the control journal's ground truth;
control-journal grant epochs must be strictly monotonic per shard across
the control-plane kill; takeover detection must land inside the tick
budget. Exit 0 verified / 5 verification failed / 3 infra failed.

Every data-plane process starts as a warm SPARE (this module's hidden
``--child --spare`` mode): it imports the port, builds its registry and
warms every program and the kernel before it reads its assignment (member
name, shard, ports, role) from its stdin. Each member, the initial ones and
each respawn after a kill, a fence or the drain, is a new spare released
from a pool that is topped up as it is drawn, so a respawn is ready within
a fraction of a second instead of a process start; a killed member is
respawned only once the fleet plane no longer shows it up. Before a round
that needs the shard's standby (the kills, the fence round, the drain and
the standby kill; not the control-plane outage) the drill also waits until
that standby has journaled within two ticks of its leader. The two fault-free references run beside
the drill. This process imports no torch.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

from rtap_tpu_torch.fleet.verdict import (
    final_tick_check,
    member_counter,
    promotion_epoch_truth,
    takeover_sequence,
)

VERIFY_FAILED_EXIT = 5
INFRA_FAILED_EXIT = 3

SHARDS = 2  # one drill, two shards: enough to prove per-shard isolation
SPARES = 2  # warm spares kept beside the four members
CAUGHT_UP_TICKS = 2  # a standby this close to its leader's journal is ready
# the directory holding the package: every child runs from it
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"[fleetchaos] {msg}", file=sys.stderr, flush=True)


def _mark(path: str | None, **kw) -> None:
    """One milestone of a data-plane life (warm, following, leading) on the
    drill's lives file: written before a SIGKILL can lose it."""
    if path:
        with open(path, "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "t_unix": time.time(), **kw}) + "\n")


def _stats_line(args, line: dict) -> None:
    """A life's stats line on stdout and on the shard's stats file."""
    if args.stats_out:
        with open(args.stats_out, "a") as f:
            f.write(json.dumps(line) + "\n")
    print(json.dumps(line))


# ---------------------------------------------------------------- child
def run_child(args) -> int:
    """One data-plane process lifetime on one shard: build and warm the
    registry, take the assignment (a spare reads it from stdin), join the
    control plane, decide role through its lease, follow until promoted or
    stopped, then serve the remaining budget — journaled, checkpointed,
    replicated to the shard peer, fenced by the CONTROL lease. A drain
    mark arriving over the heartbeat exits orderly (release + BYE
    reason=drain). ``--ref`` runs the plain single-process reference for
    the shard's feed instead (no lease, no control plane)."""
    import threading

    import rtap_tpu_torch.ops.tm_learn as tm_learn
    from rtap_tpu_torch.chaos_soak import build_registry, seeded_source, soak_ids
    from rtap_tpu_torch.fleet.control import ControlLease
    from rtap_tpu_torch.resilience import TickJournal
    from rtap_tpu_torch.resilience.replicate import (
        FENCED_RC,
        ReplicationSender,
        StandbyFollower,
    )
    from rtap_tpu_torch.service.aot import prewarm
    from rtap_tpu_torch.service.checkpoint import peek_resume_ticks
    from rtap_tpu_torch.service.loop import live_loop

    # a stop (SIGTERM, SIGINT) is orderly from the first instant: a spare
    # stopped while it warms ends without taking its assignment
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    ids = soak_ids(args.streams)
    reg = build_registry(args, ids, threshold=args.threshold, debounce=1)
    # every program and the kernel's first load BEFORE the lease: a first
    # launch inside the loop can hold the GIL long enough to starve the
    # heartbeat of a sub-second lease (the JAX child warms orbax for this)
    prewarm(reg.groups, 1, True)
    launches0 = tm_learn.launches
    _mark(args.lives_out, event="warm")

    if args.spare:
        line = sys.stdin.readline()
        if not line.strip() or stop.is_set():
            return 0  # an unused spare, or one stopped before it served
        for k, v in json.loads(line).items():
            setattr(args, k, v)
    t_release = time.time()

    w = args.workdir
    os.makedirs(w, exist_ok=True)
    alerts = os.path.join(w, "alerts.jsonl")
    ckdir = os.path.join(w, "ck")
    jdir = os.path.join(w, "journal" if args.ref else f"journal-{args.name}")
    journal = TickJournal(jdir)

    lease = None
    resume_sup = None
    promote_info = None
    fleet_pub = None
    applied_group_ticks = 0
    if not args.ref and args.fleet_port:
        from rtap_tpu_torch.fleet import FleetPublisher

        fleet_pub = FleetPublisher(
            ("127.0.0.1", args.fleet_port), args.name, role="standby",
            shard=args.shard, push_interval_s=max(0.02, args.cadence / 2))
    if not args.ref:
        # this shard's fencing epoch lives in the control plane; the loop,
        # follower and heartbeat cannot tell this lease from the file one
        lease = ControlLease(
            ("127.0.0.1", args.control_port), owner=args.name,
            shard=args.shard, timeout_s=args.lease_timeout,
            degraded_grace_s=args.control_grace)
        lease.on_drain = stop.set
        lease.hello("member")
        cur = lease.read()
        fresh_other = (cur is not None and cur.get("owner") != args.name
                       and not lease._stale(cur))
        if args.follow or fresh_other or not lease.try_acquire():
            if fleet_pub is not None:
                fleet_pub.start()
            follower = StandbyFollower(
                reg, journal, lease=lease, port=args.listen,
                alert_path=alerts, checkpoint_dir=ckdir,
                cadence_s=args.cadence, stop_event=stop)
            log(f"{args.name}: standby following shard {args.shard} on :{args.listen}")
            _mark(args.lives_out, event="following", name=args.name, shard=args.shard,
                  release_s=round(time.time() - t_release, 3))
            outcome = follower.run()
            if outcome == "stopped":
                journal.close()
                if fleet_pub is not None:
                    fleet_pub.close()
                _stats_line(args, {"name": args.name, "shard": args.shard, "stopped": True,
                                   "applied": follower.applied,
                                   "kernel_launches": tm_learn.launches - launches0,
                                   "learned_group_ticks": follower.learned_group_ticks})
                return 0
            resume_sup = follower.resume_suppression
            applied_group_ticks = follower.learned_group_ticks
            promote_info = {
                "detect_s": round(follower.promote_detect_s, 3),
                "epoch": lease.epoch,
                "re_emitted": follower.promote_re_emitted,
                "suppressed": follower.promote_suppressed,
                "applied_ticks": follower.applied,
                "splice_s": follower.promote_splice_s,
                "checkpoint_s": follower.promote_checkpoint_s,
            }
            log(f"{args.name}: PROMOTED shard {args.shard} at epoch "
                f"{lease.epoch} (detect {follower.promote_detect_s:.3f}s)")
        lease.start_heartbeat()
        if fleet_pub is not None:
            fleet_pub.set_role("leader", lease_epoch=lease.epoch)
            fleet_pub.start()
        _mark(args.lives_out, event="leading", name=args.name, shard=args.shard,
              epoch=lease.epoch, release_s=round(time.time() - t_release, 3))

    base = max(journal.next_tick, peek_resume_ticks(ckdir))
    n_eff = max(0, args.ticks - base)
    if fleet_pub is not None:
        fleet_pub.set_tick_base(base)

    sender = None
    if not args.ref:
        sender = ReplicationSender(("127.0.0.1", args.peer), journal,
                                   checkpoint_dir=ckdir).start()
        journal.tee = sender.tee
        journal.compact_floor = sender.compact_floor

    # the feed depends only on (shard, GLOBAL tick)
    source = seeded_source(args.seed + args.shard, len(ids), base, args.spike_every)
    stats = live_loop(
        source, reg, n_ticks=n_eff, cadence_s=args.cadence,
        alert_path=alerts, checkpoint_dir=ckdir,
        checkpoint_every=args.checkpoint_every, journal=journal,
        lease=lease, stop_event=stop, resume_suppression=resume_sup,
        fleet=fleet_pub)
    if sender is not None:
        sender.close()
        journal.tee = None
    drained = bool(lease is not None and lease.draining and not stats.get("fenced"))
    if lease is not None:
        # order matters on the drain exit: stop the heartbeat FIRST so it
        # cannot observe its own release as a lost lease
        lease.stop_heartbeat()
        if drained:
            lease.release()
            log(f"{args.name}: shard {args.shard} drained — lease released, "
                "the standby takes over")
    journal.close()
    if fleet_pub is not None:
        fleet_pub.close(reason="drain" if drained else None)
    line = {"name": "ref" if args.ref else args.name,
            "shard": args.shard, "base": base,
            "ran": stats["ticks"], "alerts": stats["alerts"],
            "fenced": bool(stats.get("fenced")),
            "fenced_line_drops": stats.get("fenced_line_drops", 0),
            "drained": drained,
            "control_degraded_ticks": stats.get("control_degraded_ticks", 0),
            "promoted": promote_info,
            # this life's TM learning-kernel launches (0 on the CPU; the
            # warm-up's before it are not counted) against its learned
            # group-ticks: applied as a standby plus served
            "kernel_launches": tm_learn.launches - launches0,
            "learned_group_ticks": stats["learned_group_ticks"] + applied_group_ticks}
    _stats_line(args, line)
    if stats.get("fenced"):
        return FENCED_RC
    return 0


# --------------------------------------------------------------- parent
def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _wait(cond, timeout_s: float, poll_s: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return False


def child_cmd(args, workdir: str, shard: int = 0, ref: bool = False) -> list[str]:
    """A reference child (``ref``), or a spare whose member assignment
    comes on its stdin."""
    cmd = [sys.executable, "-m", "rtap_tpu_torch.fleet_chaos", "--child",
           "--workdir", workdir, "--seed", str(args.seed),
           "--shard", str(shard),
           "--ticks", str(args.ticks), "--streams", str(args.streams),
           "--group-size", str(args.group_size),
           "--cadence", str(args.cadence),
           "--checkpoint-every", str(args.checkpoint_every),
           "--device", args.device, f"--threshold={args.threshold}",
           "--lease-timeout", str(args.lease_timeout),
           "--control-grace", str(args.control_grace),
           "--spike-every", str(args.spike_every),
           "--stats-out", os.path.join(workdir, "stats.jsonl")]
    if ref:
        return cmd + ["--ref"]
    return cmd + ["--spare", "--control-port", str(args.control_port),
                  "--fleet-port", str(args.fleet_port),
                  "--lives-out", os.path.join(os.path.dirname(workdir), "lives.jsonl")]


def control_cmd(port: int, journal_dir: str, lease_timeout: float) -> list[str]:
    """The control plane runs through the REAL serve CLI — the drill covers
    the operator surface, not just the library."""
    return [sys.executable, "-m", "rtap_tpu_torch", "serve",
            "--control-listen", str(port),
            "--control-journal", journal_dir,
            "--lease-timeout", str(lease_timeout),
            "--control-only"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch.fleet_chaos",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", type=int, default=6)
    ap.add_argument("--group-size", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=160,
                    help="TOTAL tick budget PER SHARD across takeovers")
    ap.add_argument("--cadence", type=float, default=0.12)
    ap.add_argument("--checkpoint-every", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every data plane (default cuda; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--threshold", type=float, default=-1e9,
                    help="floor default = every scored tick is an alert "
                         "line, the densest exactly-once check")
    ap.add_argument("--lease-timeout", type=float, default=None,
                    help="default 4 * cadence (failover_soak's takeover "
                         "detection budget math)")
    ap.add_argument("--takeover-budget", type=int, default=10,
                    help="max takeover detection latency in ticks")
    ap.add_argument("--outage", type=float, default=None,
                    help="control-plane kill-to-restart window in "
                         "seconds (default 5 * lease timeout: several "
                         "staleness horizons of proven degraded "
                         "serving)")
    ap.add_argument("--control-grace", type=float, default=None,
                    help="data planes' bounded cached-lease window "
                         "(default: max(30s, 10 * outage) — the drill "
                         "outage must end well inside it)")
    ap.add_argument("--spike-every", type=int, default=13)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="report JSON path")
    # child-mode flags
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ref", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--spare", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--follow", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--name", default="A", help=argparse.SUPPRESS)
    ap.add_argument("--shard", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--listen", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--peer", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--control-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--fleet-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--stats-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lives-out", default=None, help=argparse.SUPPRESS)
    return ap


def shard_verdict(i: int, ref_dir: str, shard_dir: str) -> tuple[list, dict, list, int]:
    """One shard's ground truth: its spliced alert stream exactly-once
    against the fault-free reference's, record for record, and its final
    state bit-identical -> (failures, the shard's verdict, its
    standby_promoted events, its control-plane lost/regained events)."""
    from rtap_tpu_torch.chaos_soak import compare_states, parse_alert_stream

    failures: list[str] = []
    ref_alerts = parse_alert_stream(os.path.join(ref_dir, "alerts.jsonl"))
    got_alerts = parse_alert_stream(os.path.join(shard_dir, "alerts.jsonl"))
    if got_alerts["dup"]:
        failures.append(f"shard {i}: {len(got_alerts['dup'])} DUPLICATED alert_id(s): "
                        f"{got_alerts['dup'][:5]}")
    ref_ids = set(ref_alerts["alerts"])
    got_ids = set(got_alerts["alerts"])
    lost = sorted(ref_ids - got_ids)
    extra = sorted(got_ids - ref_ids)
    if lost:
        failures.append(f"shard {i}: {len(lost)} LOST alert_id(s): {lost[:5]}")
    if extra:
        failures.append(f"shard {i}: {len(extra)} EXTRA alert_id(s): {extra[:5]}")
    mismatched = [a for a in (ref_ids & got_ids)
                  if ref_alerts["alerts"][a] != got_alerts["alerts"][a]]
    if mismatched:
        failures.append(f"shard {i}: {len(mismatched)} alert record(s) differ: "
                        f"{mismatched[:5]}")
    if not ref_ids:
        failures.append(f"shard {i}: reference emitted zero alerts — the drill proves nothing")
    leaves = compare_states(os.path.join(ref_dir, "ck"), os.path.join(shard_dir, "ck"),
                            failures)
    promos = [e for e in got_alerts["events"] if e.get("event") == "standby_promoted"]
    degraded = sum(1 for e in got_alerts["events"]
                   if e.get("event") in ("control_plane_lost", "control_plane_regained"))
    verdict = {
        "shard": i, "alert_ids": len(ref_ids),
        "duplicated": len(got_alerts["dup"]), "lost": len(lost),
        "extra": len(extra), "garbage_lines": got_alerts["garbage"],
        "state_leaves_compared": leaves,
        "promotions": [{k: e.get(k) for k in ("tick", "epoch", "detect_s", "detect_ticks")}
                       for e in promos]}
    return failures, verdict, promos, degraded


def _read_jsonl(path: str) -> list[dict]:
    try:
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        return []


def resolve_defaults(args) -> argparse.Namespace:
    """The JAX drill's derived defaults: lease 4 x cadence, outage 5 x lease,
    grace max(30 s, 10 x outage)."""
    if args.lease_timeout is None:
        args.lease_timeout = 4 * args.cadence
    if args.outage is None:
        args.outage = 5 * args.lease_timeout
    if args.control_grace is None:
        args.control_grace = max(30.0, 10.0 * args.outage)
    args.columns = None  # chaos_soak.build_registry: the cluster preset at full width
    return args


def main(argv: list[str] | None = None) -> int:
    args = resolve_defaults(build_parser().parse_args(argv))
    if args.child:
        return run_child(args)
    children: list[subprocess.Popen] = []
    try:
        return drill(args, children)
    finally:
        for p in children:  # whatever an early exit left running
            if p.poll() is None:
                p.kill()
                p.wait()


def drill(args, children: list) -> int:
    """The orchestrator: every process it starts goes into `children`."""
    from rtap_tpu_torch.fleet import FleetAggregator
    from rtap_tpu_torch.fleet.control import control_drain, control_read, read_control_journal
    from rtap_tpu_torch.resilience.journal import last_journal_tick
    from rtap_tpu_torch.resilience.replicate import FENCED_RC

    workdir = os.path.abspath(args.workdir or tempfile.mkdtemp(prefix="fleet_chaos_"))
    control_dir = os.path.join(workdir, "control")
    os.makedirs(control_dir, exist_ok=True)
    shard_dirs = [os.path.join(workdir, f"shard{i}") for i in range(SHARDS)]
    ref_dirs = [os.path.join(workdir, f"ref{i}") for i in range(SHARDS)]
    for d in shard_dirs + ref_dirs:
        os.makedirs(d, exist_ok=True)
    lives_path = os.path.join(workdir, "lives.jsonl")
    t_all = time.monotonic()
    failures: list[str] = []
    timing: dict = {}

    # 1. the fault-free per-shard references over the identical feeds, run
    # beside the drill (independent processes; the verdict waits for them)
    refs = []
    for i in range(SHARDS):
        log(f"reference run shard {i} ({args.ticks} ticks, {args.streams} streams, "
            f"device {args.device})")
        refs.append((time.monotonic(), subprocess.Popen(
            child_cmd(args, ref_dirs[i], shard=i, ref=True), cwd=PKG_ROOT)))
        children.append(refs[-1][1])

    # 2. the fleet aggregator, the warm spares and the control plane (REAL
    # serve CLI), all starting together
    agg = FleetAggregator(port=0, sweep_interval_s=max(0.02, min(0.2, args.cadence))).start()
    args.fleet_port = agg.port
    log(f"fleet aggregator on :{agg.port}")
    (args.control_port,) = _free_ports(1)
    caddr = ("127.0.0.1", args.control_port)
    spares: list[subprocess.Popen] = []  # warming or warm, oldest first
    spawned: dict[int, float] = {}  # pid -> wall time of the process start
    lives: list[dict] = []  # every member life, in release order

    def new_spare() -> None:
        p = subprocess.Popen(child_cmd(args, shard_dirs[0]), stdin=subprocess.PIPE,
                             cwd=PKG_ROOT, text=True)
        spawned[p.pid] = time.time()
        spares.append(p)
        children.append(p)

    for _ in range(2 * SHARDS + SPARES):
        new_spare()
    control_lives: list[dict] = []

    def spawn_control():
        t0 = time.monotonic()
        p = subprocess.Popen(control_cmd(args.control_port, control_dir, args.lease_timeout),
                             stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                             cwd=PKG_ROOT)
        children.append(p)
        ok = _wait(lambda: control_read(caddr, -1, timeout_s=0.5) is not None, 120.0,
                   poll_s=0.05)
        control_lives.append({"pid": p.pid, "answered_s": round(time.monotonic() - t0, 3)
                              if ok else None})
        return p, ok

    control, ok = spawn_control()
    if not ok:
        log("FATAL: control plane never answered")
        return INFRA_FAILED_EXIT
    log(f"control plane on :{args.control_port} (journal {control_dir})")

    # 3. two HA pairs: per shard, A first (acquires through the control
    # plane), then B (standby); every member is a released spare
    ports = {(i, n): p for (i, n), p in zip([(i, n) for i in range(SHARDS) for n in "AB"],
                                            _free_ports(2 * SHARDS))}
    procs: dict[str, subprocess.Popen] = {}

    def member(shard: int, n: str) -> str:
        return f"s{shard}{n}"

    def spawn(shard: int, n: str, follow: bool = True, top_up: bool = True) \
            -> subprocess.Popen:
        """Release the oldest spare as member (shard, n) and top the pool up."""
        other = "B" if n == "A" else "A"
        p = spares.pop(0)
        p.stdin.write(json.dumps({
            "name": member(shard, n), "shard": shard, "workdir": shard_dirs[shard],
            "stats_out": os.path.join(shard_dirs[shard], "stats.jsonl"),
            "listen": ports[(shard, n)], "peer": ports[(shard, other)],
            "follow": follow}) + "\n")
        p.stdin.close()
        lives.append({"name": member(shard, n), "pid": p.pid, "released_unix": time.time()})
        if top_up and len(spares) < SPARES:
            new_spare()
        return p

    def shard_owner(shard: int) -> str | None:
        p = control_read(caddr, shard, timeout_s=0.5)
        cur = (p or {}).get("cur")
        return cur.get("owner") if cur else None

    def shard_epoch(shard: int):
        return (((control_read(caddr, shard) or {}).get("cur")) or {}).get("epoch")

    t_members = time.monotonic()
    for i in range(SHARDS):
        procs[member(i, "A")] = spawn(i, "A", follow=False)
    for i in range(SHARDS):
        if not _wait(lambda: shard_owner(i) == member(i, "A"), 300.0):
            log(f"FATAL: {member(i, 'A')} never acquired shard {i}")
            return INFRA_FAILED_EXIT
        procs[member(i, "B")] = spawn(i, "B")
    timing["leaders_acquired_s"] = round(time.monotonic() - t_members, 3)
    unscheduled_fences: list[str] = []

    def reap() -> str | None:
        """Unscheduled FENCED_RC exits are legitimate lease behavior under
        host jitter (see failover_soak.reap): respawn as standby and carry
        on. Any other unexpected death is fatal."""
        for nm, pp in list(procs.items()):
            rc = pp.poll()
            if rc is None or rc == 0:
                continue
            if rc == FENCED_RC:
                unscheduled_fences.append(nm)
                log(f"{nm} fenced by an unscheduled takeover — respawning as standby")
                respawn(int(nm[1]), nm)
            else:
                return f"child {nm} died unexpectedly rc={rc}"
        return None

    def shard_tick(shard: int, name: str) -> int:
        return last_journal_tick(os.path.join(shard_dirs[shard], f"journal-{name}"))

    def standby_of(name: str) -> str:
        return name[:2] + ("B" if name.endswith("A") else "A")

    def caught_up(shard: int, leader: str) -> bool:
        sb = standby_of(leader)
        return procs[sb].poll() is None and \
            shard_tick(shard, sb) >= shard_tick(shard, leader) - CAUGHT_UP_TICKS

    def not_up(name: str) -> bool:
        return all(m.get("state") != "up" for m in agg.members_view()
                   if m.get("member") == name)

    def respawn(shard: int, name: str, top_up: bool = True) -> None:
        """The killed/fenced/drained member rejoins as standby once the fleet
        plane no longer shows its dead life up."""
        if not _wait(lambda: not_up(name), 30.0):
            failures.append(f"fleet plane still shows {name} up after its exit")
        procs[name] = spawn(shard, name[2], top_up=top_up)

    def await_leader(shard: int, target: int, what: str,
                     standby: bool = True) -> str | None:
        """Block until the shard's CURRENT leader has journaled tick >=
        target and, for a round that needs it, its standby has caught up
        (the journal-observed kill discipline). Returns the leader's name,
        or None with a failure recorded."""
        hit: dict = {}

        def reached():
            err = reap()
            if err is not None:
                hit["dead"] = err
                return True
            name = shard_owner(shard)
            if name in procs and shard_tick(shard, name) >= target and (
                    not standby or caught_up(shard, name)):
                hit["name"] = name
                return True
            return False

        if not _wait(reached, 240.0):
            failures.append(f"{what} missed target tick {target} on shard {shard} "
                            f"(owner={shard_owner(shard)})")
            return None
        if "dead" in hit:
            failures.append(hit["dead"])
            return None
        fired[what] = shard_tick(shard, hit["name"])
        return hit["name"]

    def kill_leader(shard: int, target: int) -> dict | None:
        name = await_leader(shard, target, f"leader kill shard {shard}")
        if name is None:
            return None
        p = procs[name]
        t_kill = time.monotonic()
        p.kill()
        p.wait()
        log(f"killed shard-{shard} leader {name} near tick {target}")
        if not _wait(lambda: shard_owner(shard) not in (None, name), 120.0):
            failures.append(f"standby never promoted on shard {shard} after killing "
                            f"{name} at tick {target}")
            return None
        obs = {"shard": shard, "target": target, "killed": name,
               "new_leader": shard_owner(shard),
               "takeover_wall_s": round(time.monotonic() - t_kill, 3)}
        respawn(shard, name)
        return obs

    # 4. the seeded drill schedule (targets on each shard's own journal
    # axis; jitter from a seeded rng so runs differ by seed, but every
    # phase keeps its order — the phases ARE the coverage)
    rng = random.Random(args.seed)

    def jitter(base_frac: float) -> int:
        t = int(args.ticks * base_frac) + rng.randrange(5)
        return min(args.ticks - 12, max(1, t))

    targets = {
        "kill0": jitter(0.12), "kill1": jitter(0.20),
        "standby_kill": jitter(0.30), "outage": jitter(0.40),
        "fence": jitter(0.62), "drain": jitter(0.80),
    }
    log(f"drill schedule (per-shard ticks): {targets}; outage {args.outage:.2f}s; "
        f"grace {args.control_grace:.1f}s")
    fired: dict = {}  # each round's leader journal tick when it fired
    t_rounds = time.monotonic()

    observed: list[dict] = []
    fence_report: dict | None = None
    drain_report: dict | None = None
    outage_report: dict | None = None

    # 4a. leader kills, one per shard
    obs = kill_leader(0, targets["kill0"])
    if obs:
        observed.append(obs)
    obs = None if failures else kill_leader(1, targets["kill1"])
    if obs:
        observed.append(obs)

    # 4b. standby kill on shard 0: the plane must see it; the leader must
    # not (its journal keeps advancing without a takeover)
    standby_kill: dict | None = None
    if not failures:
        name = await_leader(0, targets["standby_kill"], "standby kill")
        if name is not None:
            sb = standby_of(name)
            before = shard_tick(0, name)
            epoch_before = shard_epoch(0)
            procs[sb].kill()
            procs[sb].wait()
            log(f"killed shard-0 standby {sb} near tick {targets['standby_kill']}")
            if not _wait(lambda: shard_tick(0, name) >= before + 4, 120.0):
                failures.append("shard-0 leader stalled after its standby was killed")
            epoch_after = shard_epoch(0)
            if epoch_after != epoch_before:
                failures.append(
                    f"standby kill moved shard-0 epoch {epoch_before} -> {epoch_after} (a "
                    "takeover happened; the leader should not have cared)")
            standby_kill = {"killed": sb, "leader": name, "epoch": epoch_after}
            respawn(0, sb)

    # 4c. control-plane kill + journal-recovery restart: both shards must
    # keep ticking on cached leases (no stalled tick), the restarted plane
    # must recover every epoch, and no leader may fence
    if not failures:
        # no standby takes part: the one respawned after the standby kill
        # may still be starting, and joins through the outage
        name0 = await_leader(0, targets["outage"], "control outage", standby=False)
        name1 = shard_owner(1)
        if name0 is not None and name1 is not None:
            epochs_before = {i: shard_epoch(i) for i in range(SHARDS)}
            control.kill()
            control.wait()
            t0 = time.monotonic()
            ticks_at_kill = {0: shard_tick(0, name0), 1: shard_tick(1, name1)}
            log(f"killed the CONTROL PLANE (outage {args.outage:.2f}s; shard ticks at "
                f"kill {ticks_at_kill})")
            time.sleep(args.outage)
            ticks_at_restart = {0: shard_tick(0, name0), 1: shard_tick(1, name1)}
            # the availability bar: a control-plane outage degrades, never
            # stalls — each shard's leader kept journaling
            min_advance = max(2, int(args.outage / args.cadence) // 4)
            for i in range(SHARDS):
                adv = ticks_at_restart[i] - ticks_at_kill[i]
                if adv < min_advance:
                    failures.append(
                        f"shard {i} STALLED during the control outage: advanced {adv} "
                        f"tick(s) in {args.outage:.2f}s (want >= {min_advance})")
            err = reap()
            if err is not None:
                failures.append(f"during control outage: {err}")
            control, ok = spawn_control()
            if not ok:
                failures.append("restarted control plane never answered")
            else:
                # recovery contract: same owners, same epochs — the restart
                # must not have fenced a healthy leader
                def _settled():
                    return all(shard_owner(i) == (name0, name1)[i] for i in range(SHARDS))

                settled = _wait(_settled, 60.0, poll_s=0.1)
                epochs_after = {i: shard_epoch(i) for i in range(SHARDS)}
                if not settled or epochs_after != epochs_before:
                    failures.append(
                        f"control restart changed lease state: owners settled={settled}, "
                        f"epochs {epochs_before} -> {epochs_after}")
                # sample the MERGED degraded counter NOW, while the
                # outage-era leaders still own their member rows: a later
                # same-name respawn overwrites the snap with a fresh
                # process's zeroed counters (latest-push-wins)
                degraded_fleet = sum(
                    member_counter(s, "rtap_obs_control_degraded_ticks_total") or 0
                    for s in agg.member_snaps().values())
                outage_report = {
                    "outage_s": round(time.monotonic() - t0, 3),
                    "ticks_at_kill": ticks_at_kill,
                    "ticks_at_restart": ticks_at_restart,
                    "epochs": epochs_before,
                    "degraded_ticks_fleet": degraded_fleet,
                    "leaders_survived": settled,
                    "restart_answered_s": control_lives[-1]["answered_s"]}
                log(f"control plane restarted: {outage_report}")

    # 4d. zombie-fence round on shard 1: SIGSTOP the leader, let the
    # standby take over through the control plane, SIGCONT the zombie — it
    # must exit FENCED_RC
    if not failures:
        name = await_leader(1, targets["fence"], "fence round")
        if name is not None:
            p = procs[name]
            os.kill(p.pid, signal.SIGSTOP)
            log(f"SIGSTOPped shard-1 leader {name} near tick {targets['fence']}")
            promoted = _wait(lambda: shard_owner(1) not in (None, name), 120.0)
            os.kill(p.pid, signal.SIGCONT)
            if not promoted:
                failures.append("standby never promoted during the fence round")
            else:
                try:
                    rc = p.wait(timeout=120.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rc = p.wait()
                    failures.append(f"paused old leader {name} never exited after "
                                    "SIGCONT (fence did not bite)")
                fence_report = {"paused": name, "rc": rc, "new_leader": shard_owner(1)}
                if rc != FENCED_RC:
                    failures.append(f"woken old leader {name} exited rc={rc}, expected "
                                    f"FENCED_RC={FENCED_RC}")
                respawn(1, name)

    # 4e. rolling-upgrade drain on shard 0: mark it draining at the control
    # plane; the leader exits ORDERLY (rc 0, lease released, BYE
    # reason=drain), the standby takes over at once, the old leader rejoins
    # as standby
    if not failures:
        name = await_leader(0, targets["drain"], "drain round")
        if name is not None:
            control_drain(caddr, 0)
            log(f"drain marked on shard 0 (leader {name})")
            p = procs[name]
            try:
                rc = p.wait(timeout=120.0)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            if rc != 0:
                failures.append(f"draining leader {name} exited rc={rc}, expected an "
                                "orderly 0")
            if not _wait(lambda: shard_owner(0) not in (None, name), 120.0):
                failures.append("standby never took over the drained shard")
            drain_report = {"drained": name, "rc": rc, "new_leader": shard_owner(0)}
            respawn(0, name, top_up=False)  # the last round: no spare after it
    timing["rounds_s"] = round(time.monotonic() - t_rounds, 3)

    # 5. completion: each shard's leader finishes its budget (exit 0 with
    # the journal at ticks-1); its standby is stopped once the leader has
    # journaled the last tick, before the leader's exit lets the lease go
    # stale (a promotion there would serve nothing)
    done: dict[int, str] = {}
    # one SIGTERM each: a second one can land after the interpreter has put
    # the default handler back on its way out, and kill an orderly exit
    terminated: set[int] = set()

    def stop_member(p: subprocess.Popen) -> None:
        if p.poll() is None and p.pid not in terminated:
            terminated.add(p.pid)
            p.terminate()

    def budget_done():
        err = reap()
        if err is not None:
            done["err"] = err
            return True
        for i in range(SHARDS):
            owner = shard_owner(i)
            if i in done or owner not in procs or shard_tick(i, owner) < args.ticks - 1:
                continue
            stop_member(procs[standby_of(owner)])
            if procs[owner].poll() == 0:
                done[i] = owner
        return all(i in done for i in range(SHARDS))

    if not _wait(budget_done, 600.0, poll_s=0.05):
        failures.append(f"shards never completed the budget (done={done})")
    if "err" in done:
        failures.append(str(done.pop("err")))
    for nm, p in procs.items():
        stop_member(p)
        try:
            p.wait(timeout=60.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            failures.append(f"standby {nm} ignored SIGTERM")
    for p in spares:  # unused spares end on their stdin's EOF
        p.stdin.close()
    for p in spares:
        try:
            p.wait(timeout=60.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    timing["drill_s"] = round(time.monotonic() - t_all, 3)
    ref_s = []
    for i, (t0, p) in enumerate(refs):
        rc = p.wait()
        ref_s.append(round(time.monotonic() - t0, 3))
        if rc != 0:
            log(f"FATAL: reference run shard {i} failed rc={rc}")
            agg.close()
            control.kill()
            return INFRA_FAILED_EXIT
    timing["references_waited_s"] = round(time.monotonic() - t_all, 3)

    # 6. verdict — ground truth first: per-shard exactly-once alerts +
    # bit-identical state vs the fault-free references, one process per
    # shard (the streams' parse is most of the verdict's time)
    shards_verdict: list[dict] = []
    promotions_all: list[dict] = []
    degraded_events = 0
    with ProcessPoolExecutor(SHARDS, mp_context=multiprocessing.get_context("spawn")) as ex:
        for fails, verdict, promos, degraded in ex.map(
                shard_verdict, range(SHARDS), ref_dirs, shard_dirs):
            failures += fails
            shards_verdict.append(verdict)
            promotions_all.extend(promos)
            degraded_events += degraded

    # takeover budget, anchored to the SCHEDULED faults
    budget_anchors = [(k["target"], f"kill shard {k['shard']}") for k in observed]
    if fence_report:
        budget_anchors.append((targets["fence"], "fence"))
    for target, kind in budget_anchors:
        cand = [p for p in promotions_all
                if p.get("detect_ticks") is not None
                and abs(p["tick"] - target) <= args.takeover_budget + 6]
        if not cand:
            failures.append(f"no standby_promoted event near the {kind} at tick {target}")
            continue
        p = min(cand, key=lambda q: abs(q["tick"] - target))
        if p["detect_ticks"] > args.takeover_budget:
            failures.append(
                f"takeover at tick {p['tick']} ({kind} at {target}) detected in "
                f"{p['detect_ticks']} ticks — over the {args.takeover_budget}-tick budget")

    # 7. control-journal ground truth: grant epochs STRICTLY monotonic per
    # shard across the control-plane kill (the never-re-invert bar)
    journal_recs = read_control_journal(control_dir)
    grants: dict[int, list[int]] = {}
    for rec in journal_recs:
        if rec.get("kind") == "grant":
            grants.setdefault(int(rec["shard"]), []).append(int(rec["epoch"]))
    for i in range(SHARDS):
        eps = grants.get(i, [])
        if len(eps) < 3:
            failures.append(f"shard {i}: only {len(eps)} journaled grant(s) — the drill's "
                            "takeovers are not in the epoch journal")
        if any(b <= a for a, b in zip(eps, eps[1:])):
            failures.append(f"shard {i}: journaled grant epochs not strictly monotonic: "
                            f"{eps} — the restart re-inverted a fence")

    # 8. the fleet plane's story, judged with the shared helpers
    members = agg.members_view()
    events = agg.events_view()
    anchors = [(k["killed"], k["new_leader"], "kill") for k in observed]
    if fence_report:
        anchors.append((fence_report["paused"], fence_report["new_leader"], "fence"))
    checks = takeover_sequence(events, anchors, failures)
    fleet_epochs = promotion_epoch_truth(events, promotions_all, failures)
    final_tick = final_tick_check(members, args.ticks - 1, failures)
    # the drain is an OPERATION on the plane: BYE reason=drain ("left",
    # never DOWN), then role_changed on the successor
    if drain_report:
        drained_nm = drain_report["drained"]
        left = next((e for e in events if e["event"] == "left"
                     and e["member"] == drained_nm
                     and e.get("reason") == "drain"), None)
        if left is None:
            failures.append(f"drained leader {drained_nm} never sent BYE reason=drain to "
                            "the fleet plane")
        if any(e["event"] == "down" and e["member"] == drained_nm
               and e["t_unix"] >= (left or {}).get("t_unix", 0) for e in events):
            failures.append(f"drained leader {drained_nm} was marked DOWN — a drain must "
                            "read as an operation")
    # the standby kill is VISIBLE: its member went down and rejoined
    if standby_kill:
        sb_ev = [e for e in events if e["member"] == standby_kill["killed"]]
        if not any(e["event"] == "down" for e in sb_ev):
            failures.append(f"fleet plane never marked the killed standby "
                            f"{standby_kill['killed']} DOWN")
        if not any(e["event"] == "rejoined" for e in sb_ev):
            failures.append(f"killed standby {standby_kill['killed']} never rejoined on "
                            "the plane")
    # degraded serving is COUNTED: the merged fleet counter (sampled while
    # the outage-era leaders still owned their member rows) must show the
    # outage window, the per-process stats lines must agree, and the
    # lost/regained event pair must be on the incident stream
    degraded_total = (outage_report or {}).get("degraded_ticks_fleet", 0)
    stats_lines = {i: _read_jsonl(os.path.join(shard_dirs[i], "stats.jsonl"))
                   for i in range(SHARDS)}
    stats_degraded = sum(int(s.get("control_degraded_ticks") or 0)
                         for i in range(SHARDS) for s in stats_lines[i])
    if outage_report and degraded_total <= 0:
        failures.append("control outage ran but the fleet plane never showed a degraded "
                        "tick (rtap_obs_control_degraded_ticks_total)")
    if outage_report and stats_degraded <= 0:
        failures.append("control outage ran but no child's stats line counted a degraded "
                        "tick")
    if outage_report and degraded_events <= 0:
        failures.append("control outage ran but no control_plane_lost/regained event "
                        "reached an incident stream")

    fleetobs = {
        "members": [{k: m.get(k) for k in ("member", "state", "role", "shard",
                                           "lease_epoch", "tick", "snapshots",
                                           "left_reason")}
                    for m in members],
        "sequence": checks,
        "promotion_epochs": fleet_epochs,
        "final_tick": final_tick,
        "degraded_ticks_total": degraded_total,
        "events_total": len(events),
    }
    with open(os.path.join(workdir, "fleet_snapshot.json"), "w") as f:
        json.dump(agg.snapshot(), f, indent=2)
    agg.close()
    control.terminate()
    try:
        control.wait(timeout=30.0)
    except subprocess.TimeoutExpired:
        control.kill()
        control.wait()

    # each member life: process start -> warm, release -> following/leading
    marks: dict[int, dict] = {}
    for m in _read_jsonl(lives_path):
        marks.setdefault(m["pid"], {})[m["event"]] = m
    for life in lives:
        mk = marks.get(life["pid"], {})
        warm = mk.get("warm")
        role = mk.get("following") or mk.get("leading")
        life["start_to_warm_s"] = (round(warm["t_unix"] - spawned[life["pid"]], 3)
                                   if warm else None)
        life["release_to_role_s"] = role["release_s"] if role else None
        life["role"] = "following" if "following" in mk else (
            "leading" if "leading" in mk else None)
        life["start_to_role_s"] = (round(role["t_unix"] - spawned[life["pid"]], 3)
                                   if role else None)

    report = {
        "seed": args.seed,
        "shards": SHARDS,
        "ticks_per_shard": args.ticks,
        "cadence_s": args.cadence,
        "lease_timeout_s": args.lease_timeout,
        "takeover_budget_ticks": args.takeover_budget,
        "schedule": targets,
        "fired_at_ticks": fired,
        "leader_kills": observed,
        "standby_kill": standby_kill,
        "control_outage": outage_report,
        "fence_round": fence_report,
        "drain_round": drain_report,
        "completed_by": {str(k): v for k, v in done.items()},
        "unscheduled_fences": unscheduled_fences,
        "shards_verdict": shards_verdict,
        "control_journal": {
            "records": len(journal_recs),
            "grants_per_shard": {str(s): e for s, e in sorted(grants.items())}},
        "degraded_ticks_total": degraded_total,
        "degraded_ticks_stats": stats_degraded,
        "degraded_events": degraded_events,
        "fleetobs": fleetobs,
        "device": args.device,
        "stats_lines": {str(i): stats_lines[i] for i in range(SHARDS)},
        "reference_lines": [(_read_jsonl(os.path.join(d, "stats.jsonl")) or [None])[-1]
                            for d in ref_dirs],
        "reference_s": ref_s,
        "lives": lives,
        "control_lives": control_lives,
        "timing": timing,
        "wall_s": round(time.monotonic() - t_all, 1),
        "verified": not failures,
        "failures": failures,
        "workdir": workdir,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))
    if failures:
        log(f"VERIFY FAILED ({len(failures)}):")
        for msg in failures:
            log(f"  - {msg}")
        return VERIFY_FAILED_EXIT
    log(f"VERIFIED: {len(observed)} leader kill(s), 1 standby kill, 1 control-plane kill, "
        f"1 fence round, 1 drain; {degraded_total} degraded tick(s), exactly-once on "
        f"{SHARDS} shard(s), epochs monotonic")
    return 0


if __name__ == "__main__":
    sys.exit(main())
