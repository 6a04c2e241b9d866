"""Chaos soak: a seeded fault schedule against the port's REAL live loop.

    python -m rtap_tpu_torch.chaos_soak --seed 1 [--streams 12]
        [--group-size 4] [--ticks 120] [--cadence 0.05] [--rate 0.08]
        [--device cuda|cpu] [--columns C] [--twin] [--out report.json]
        [--supervise --kills 2] [--topology-burst] [--degrade] [--replication]

The port of the JAX package's ``scripts/chaos_soak.py`` (its supervise
child is the port of ``scripts/crash_soak.py --child``). Modes:

- the seeded in-process soak (default): ``ChaosSpec.generate(seed)`` — the
  JAX package's schedule and digest for the same seed — drives source
  faults, group quarantine + checkpoint restore, alert-sink quarantine and
  the checkpoint-save breaker through ``service/loop.live_loop``, with the
  span and flight recorders armed. The run FAILS (exit 5) if any group's
  streams silently stopped being scored while unquarantined: the loop's
  ``scored_by_group`` must match the unquarantined intervals of its
  ``quarantine_log`` exactly, alert ids must be unique and every
  postmortem bundle must validate; the report lists the groups left
  quarantined (``unrestored``) and each restore's wall seconds.
  ``--inject KIND@TICK:GROUP`` adds explicit faults to the generated
  schedule (``schedule_digest`` stays the generated one's; ``run_digest``
  covers both). ``--twin`` also runs a twin without the faults that
  change a group's inputs or state (dispatch/collect exceptions,
  group-targeted source timeouts) and holds the final state leaves of
  every group none of them named bit-equal to it.
- ``--degrade``: group 0's dispatch hangs past the cadence for a window,
  with the degradation ladder armed: it must escalate, then
  recover to level 0 once the hangs stop; on cuda the learning-kernel
  launches must equal the loop's learned group-ticks.
- ``--supervise --kills N``: the schedule gains N ``proc_exit`` faults and
  this module's ``--child`` (journaled + checkpointed) runs under the
  real :class:`~rtap_tpu_torch.resilience.Supervisor`: one restart per
  kill, the tick budget completed, ``journal_replayed`` events on the
  stream and every alert id exactly once.
- ``--topology-burst``: one correlated multi-group ``topology_burst``
  with incident correlation armed: exactly ONE incident pages, its node
  set the flooded nodes, every member alert id on the stream.

- ``--replication``: seeded wire faults (``conn_drop``, ``stall_socket``,
  ``corrupt_bytes``) against a live in-process leader/standby pair through
  the chaos engine's ``on_wire`` seam on the replication socket: every
  scheduled kind must be injected, the standby must apply every tick, and
  its final state must be bit-identical to the leader's.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile

import numpy as np

VERIFY_FAILED_EXIT = 5


def log(msg: str) -> None:
    print(f"[chaos] {msg}", file=sys.stderr, flush=True)


def soak_config(columns: int | None = None, probation: tuple[int, int] | None = None):
    """The soak's model: the cluster preset (``columns`` width-scales it;
    ``probation`` = (learning_period, estimation_samples) shortens the
    likelihood probation)."""
    import dataclasses

    from rtap_tpu_torch.config import cluster_preset, scaled_cluster_preset

    cfg = cluster_preset() if columns is None else scaled_cluster_preset(columns)
    if probation is not None:
        cfg = dataclasses.replace(cfg, likelihood=dataclasses.replace(
            cfg.likelihood, learning_period=probation[0], estimation_samples=probation[1]))
    return cfg


def soak_ids(n: int) -> list[str]:
    return [f"n{i // 3}.m{i % 3}" for i in range(n)]


def seeded_source(seed: int, n: int, base: int = 0, spike_every: int = 0):
    """The soak feed: values keyed by (seed, global tick) only, so every
    restart and every twin sees the same rows."""
    def source(k: int):
        g = base + k
        rng = np.random.Generator(np.random.Philox(key=(seed, g)))
        v = (30 + 5 * rng.random(n)).astype(np.float32)
        if spike_every and g % spike_every == 0:
            v[(g // spike_every) % n] += 30.0
        return v, 1_700_000_000 + g
    return source


def build_registry(args, ids: list[str], cfg=None, threshold: float = 0.5,
                   debounce: int = 2):
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    reg = StreamGroupRegistry(cfg if cfg is not None else soak_config(args.columns),
                              group_size=args.group_size, device=args.device,
                              threshold=threshold, debounce=debounce)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()
    return reg


def parse_alert_stream(path: str) -> dict:
    """Split a JSONL incident stream into alert records by alert_id, plus
    events, duplicated ids and torn fragments (the shared tolerant line
    walker, service/alerts.iter_alert_records)."""
    from rtap_tpu_torch.service.alerts import iter_alert_records

    alerts: dict = {}
    dup: list[str] = []
    events: list[dict] = []
    garbage = 0
    for kind, rec in iter_alert_records(path):
        if kind == "garbage":
            garbage += 1  # torn fragment from a kill mid-write
            continue
        if kind == "event":
            events.append(rec)
            continue
        aid = rec.get("alert_id")
        if aid is None:
            garbage += 1
            continue
        if aid in alerts:
            dup.append(aid)
        alerts[aid] = rec
    return {"alerts": alerts, "dup": dup, "events": events, "garbage": garbage}


def load_checkpoints(ckdir: str) -> dict:
    """Every group checkpoint of a dir -> {group name: (meta, state tree)}."""
    from rtap_tpu_torch.service.ckpt_tree import read_npy_tree

    out = {}
    for name in sorted(os.listdir(ckdir)):
        meta = os.path.join(ckdir, name, "meta.json")
        if name.startswith("group") and os.path.isfile(meta):
            with open(meta) as f:
                out[name] = (json.load(f), read_npy_tree(os.path.join(ckdir, name, "state")))
    return out


def _flat(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(tree[k])


def compare_states(ref_ck: str, got_ck: str, failures: list[str]) -> int:
    """Bitwise comparison of two checkpoint dirs' full state trees (the
    JAX package's ``scripts/crash_soak.compare_states``); returns the
    leaves compared."""
    ref, got = load_checkpoints(ref_ck), load_checkpoints(got_ck)
    if sorted(ref) != sorted(got):
        failures.append(f"checkpoint groups differ: {sorted(ref)} vs {sorted(got)}")
        return 0
    leaves = 0
    for name in sorted(ref):
        (rmeta, rtree), (gmeta, gtree) = ref[name], got[name]
        if rmeta["ticks"] != gmeta["ticks"]:
            failures.append(f"{name}: final tick cursor {gmeta['ticks']} "
                            f"!= fault-free {rmeta['ticks']}")
        rl, gl = dict(_flat(rtree)), dict(_flat(gtree))
        if sorted(rl) != sorted(gl):
            failures.append(f"{name}: state tree keys differ")
            continue
        for key in sorted(rl):
            leaves += 1
            a, b = rl[key], gl[key]
            equal = a.shape == b.shape and (np.array_equal(a, b, equal_nan=True)
                                            if a.dtype.kind in "fc" else np.array_equal(a, b))
            if not equal:
                failures.append(f"{name}{key}: state diverges from the fault-free run")
    return leaves


def unquarantined_intervals(events: list[dict], n_groups: int,
                            ticks: int) -> list[list[tuple[int, int]]]:
    """Per group, the [start, end) tick intervals it was being scored,
    from the quarantine log's quarantine/restore entries."""
    start = [0] * n_groups
    active = [True] * n_groups
    intervals: list[list[tuple[int, int]]] = [[] for _ in range(n_groups)]
    for e in events:
        g = e.get("group")
        if g is None or not 0 <= g < n_groups:
            continue
        if e["event"] == "group_quarantined" and active[g]:
            intervals[g].append((start[g], e["tick"]))
            active[g] = False
        elif e["event"] == "group_restored" and not active[g]:
            start[g] = e["tick"]
            active[g] = True
    for g in range(n_groups):
        if active[g]:
            intervals[g].append((start[g], ticks))
    return intervals


def _write_report(args, report: dict) -> None:
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))


def _finish(args, report: dict, failures: list[str], ok_msg: str) -> int:
    report["verified"] = not failures
    report["failures"] = failures
    _write_report(args, report)
    if failures:
        for msg in failures:
            log(f"FAIL: {msg}")
        return VERIFY_FAILED_EXIT
    log(ok_msg)
    return 0


#: group faults that change the group's inputs or state (a hang or a
#: failed checkpoint save changes neither)
STATE_FAULTS = ("dispatch_exception", "collect_exception", "source_timeout")


def _state_faulted(f) -> bool:
    return f.kind in STATE_FAULTS and (f.kind != "source_timeout" or f.group is not None)


def parse_inject(specs: list[str]) -> list:
    """``KIND@TICK[:GROUP]`` strings -> Faults."""
    from rtap_tpu_torch.resilience import Fault

    out = []
    for spec in specs or ():
        kind, _, rest = spec.partition("@")
        tick, _, group = rest.partition(":")
        out.append(Fault(kind=kind, tick=int(tick), group=int(group) if group else None))
    return out


def _state_leaves(grp) -> dict:
    from rtap_tpu_torch.models.state import state_to_numpy

    return state_to_numpy(grp.state)


def run_soak(args) -> int:
    """The seeded in-process soak (and its fault-free twin with --twin)."""
    import rtap_tpu_torch.ops.tm_learn as tm_learn
    from rtap_tpu_torch.obs import FlightRecorder, TraceRecorder, validate_bundle
    from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec
    from rtap_tpu_torch.service.loop import live_loop

    ids = soak_ids(args.streams)
    reg = build_registry(args, ids)
    n_groups = len(reg.groups)
    spec = ChaosSpec.generate(seed=args.seed, n_ticks=args.ticks, n_groups=n_groups,
                              rate=args.rate)
    digest = spec.digest()
    # reproducibility is a hard contract: regenerate and compare first
    if ChaosSpec.generate(seed=args.seed, n_ticks=args.ticks, n_groups=n_groups,
                          rate=args.rate).digest() != digest:
        log("FATAL: schedule generation is not deterministic")
        return 3
    injected = parse_inject(args.inject)
    if injected:
        spec = ChaosSpec(faults=sorted(spec.faults + injected, key=lambda f: f.tick),
                         seed=spec.seed)
    engine = ChaosEngine(spec)
    log(f"schedule: {len(spec.faults)} faults over {args.ticks} ticks, digest {digest}")
    source = seeded_source(args.seed, len(ids))
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_soak_")
    os.makedirs(workdir, exist_ok=True)
    alerts_path = os.path.join(workdir, "alerts.jsonl")
    # every chaos run flies with the span and flight recorders armed; a
    # chaos-induced quarantine must leave a valid postmortem bundle
    trace = TraceRecorder(capacity=32768)
    pm_dir = os.path.join(workdir, "postmortems")
    flight = FlightRecorder(
        trace=trace, n_ticks=min(args.ticks, 240), out_dir=pm_dir,
        info={"command": "chaos_soak", "seed": args.seed, "schedule_digest": digest,
              "streams": args.streams, "group_size": args.group_size})
    launches0 = tm_learn.launches
    stats = live_loop(source, reg, n_ticks=args.ticks, cadence_s=args.cadence,
                      alert_path=alerts_path, checkpoint_dir=os.path.join(workdir, "ck"),
                      checkpoint_every=args.checkpoint_every,
                      quarantine_restore_after=args.restore_after,
                      chaos=engine, trace=trace, flight=flight)
    launches = tm_learn.launches - launches0

    failures: list[str] = []
    if stats["ticks"] != args.ticks:
        failures.append(f"loop stopped at tick {stats['ticks']} of {args.ticks}")
    # intervals come from the loop's own quarantine log, not the alert
    # stream: the sink may have been the faulted component
    qlog = stats.get("quarantine_log", [])
    intervals = unquarantined_intervals(qlog, n_groups, stats["ticks"])
    expected = [sum(b - a for a, b in intervals[g]) * reg.groups[g].n_live
                for g in range(n_groups)]
    got = stats["scored_by_group"]
    for g in range(n_groups):
        if got[g] != expected[g]:
            failures.append(
                f"group{g}: scored {got[g]} but its unquarantined intervals "
                f"{intervals[g]} require {expected[g]} — streams silently stopped "
                "being scored while unquarantined")
    if sum(got) != stats["scored"]:
        failures.append(f"per-group counts sum to {sum(got)} != scored {stats['scored']}")
    parsed = parse_alert_stream(alerts_path)
    if parsed["dup"]:
        failures.append(f"{len(parsed['dup'])} duplicated alert id(s): {parsed['dup'][:5]}")
    if reg.groups[0].device.type == "cuda" and launches != stats["learned_group_ticks"]:
        failures.append(f"{launches} kernel launches != {stats['learned_group_ticks']} "
                        "learned group-ticks")
    quarantines = [e for e in qlog if e["event"] == "group_quarantined"]
    restores = [e for e in qlog if e["event"] == "group_restored"]
    bundle_dirs = sorted(os.path.join(pm_dir, d) for d in os.listdir(pm_dir)
                         if not d.startswith(".tmp")) if os.path.isdir(pm_dir) else []
    verdicts = [validate_bundle(b) for b in bundle_dirs]
    if quarantines and not bundle_dirs:
        failures.append(f"{len(quarantines)} quarantine(s) occurred but no postmortem "
                        "bundle was dumped")
    for b, v in zip(bundle_dirs, verdicts):
        if not v["ok"]:
            failures.append(f"invalid postmortem bundle {b}: {v['problems']}")
        elif v["events"] == 0:
            failures.append(f"postmortem bundle {b} captured zero events")
    pm_report = {
        "dir": pm_dir,
        "bundles": [os.path.basename(b) for b in bundle_dirs],
        "valid": sum(1 for v in verdicts if v["ok"]),
        "spans": sum(v["spans"] for v in verdicts),
        "instants": sum(v["instants"] for v in verdicts),
        "events": sum(v["events"] for v in verdicts),
        "dumps_skipped": stats.get("postmortem", {}).get("dumps_skipped", 0),
        "trace_records": trace.total,
        "trace_dropped": trace.dropped,
    }
    twin = None
    if args.twin:
        # the schedule without its state-changing group faults: a group none
        # of them named saw the same inputs in both runs, so its final state
        # must be bit-equal
        twin_spec = ChaosSpec(faults=[f for f in spec.faults if not _state_faulted(f)],
                              seed=spec.seed)
        named = set()
        for f in spec.faults:
            if _state_faulted(f):
                named |= set(range(n_groups)) if f.group is None else {f.group}
        untouched = sorted(set(range(n_groups)) - named - {e["group"] for e in quarantines})
        twin_reg = build_registry(args, ids)
        twin_dir = os.path.join(workdir, "twin")
        os.makedirs(twin_dir, exist_ok=True)
        live_loop(source, twin_reg, n_ticks=args.ticks, cadence_s=args.cadence,
                  alert_path=os.path.join(twin_dir, "alerts.jsonl"),
                  chaos=ChaosEngine(twin_spec))
        diff = []
        for g in untouched:
            a, b = _state_leaves(reg.groups[g]), _state_leaves(twin_reg.groups[g])
            diff += [f"group{g}/{k}" for k in a
                     if not np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f")]
        if diff:
            failures.append(f"untouched groups diverge from the fault-free twin: {diff[:8]}")
        twin = {"groups_compared": untouched, "leaves_equal": not diff,
                "twin_digest": twin_spec.digest()}
    report = {
        "mode": "soak",
        "seed": args.seed,
        "device": str(reg.device),
        "schedule_digest": digest,
        "run_digest": spec.digest(),
        "faults_scheduled": len(spec.faults),
        "faults_added": [f"{f.kind}@{f.tick}:{f.group}" for f in injected],
        "faults_injected": engine.injected,
        "events": sorted({e["event"] for e in parsed["events"]}),
        "intervals": {f"group{g}": intervals[g] for g in range(n_groups)},
        "expected_by_group": expected,
        "quarantines": len(quarantines),
        "restores": len(restores),
        # quarantined at the end: restores that failed or were not yet due
        "unrestored": sorted(stats.get("quarantined", {})),
        "alert_ids": len(parsed["alerts"]),
        "kernel_launches": launches,
        "postmortem": pm_report,
        "twin": twin,
        "stats": stats,
        "workdir": workdir,
    }
    return _finish(args, report, failures,
                   f"OK: {stats['scored']} scored, {len(engine.injected)} faults injected, "
                   f"{len(quarantines)} quarantines, {pm_report['valid']} valid postmortem "
                   "bundle(s)")


def run_degrade(args) -> int:
    """`--degrade`: a window of dispatch hangs past the cadence on every
    group; the ladder must engage, then recover to level 0."""
    import rtap_tpu_torch.ops.tm_learn as tm_learn
    from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, DegradationController, Fault
    from rtap_tpu_torch.service.loop import live_loop

    ids = soak_ids(args.streams)
    reg = build_registry(args, ids)
    degradation = DegradationController()
    hang_from, hang_ticks = args.ticks // 6, args.ticks // 4
    # group 0's dispatch hangs twice the cadence: every tick of the window
    # misses its deadline, even at tick_widen's doubled cadence
    spec = ChaosSpec(faults=[Fault(kind="dispatch_hang", tick=hang_from, duration=hang_ticks,
                                   group=0, seconds=2 * args.cadence)], seed=args.seed)
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_degrade_")
    os.makedirs(workdir, exist_ok=True)
    alerts_path = os.path.join(workdir, "alerts.jsonl")
    launches0 = tm_learn.launches
    stats = live_loop(seeded_source(args.seed, len(ids)), reg, n_ticks=args.ticks,
                      cadence_s=args.cadence, alert_path=alerts_path,
                      chaos=ChaosEngine(spec), degradation=degradation)
    launches = tm_learn.launches - launches0
    parsed = parse_alert_stream(alerts_path)
    kinds = [e["event"] for e in parsed["events"]]
    deg = stats["degradation"]
    failures: list[str] = []
    if stats["ticks"] != args.ticks:
        failures.append(f"loop stopped at tick {stats['ticks']} of {args.ticks}")
    if deg["max_level"] < 1 or "degraded" not in kinds:
        failures.append(f"the ladder never engaged ({deg})")
    if deg["level"] != 0 or "recovered" not in kinds:
        failures.append(f"the ladder did not recover to level 0 ({deg})")
    if stats["scored"] != args.ticks * len(ids):
        failures.append(f"scored {stats['scored']} != {args.ticks * len(ids)}: degradation "
                        "must never stop scoring")
    full = args.ticks * len(reg.groups)
    if not stats["learned_group_ticks"] < full:
        failures.append("no learning was shed while degraded")
    if reg.groups[0].device.type == "cuda" and launches != stats["learned_group_ticks"]:
        failures.append(f"{launches} kernel launches != {stats['learned_group_ticks']} "
                        "learned group-ticks")
    report = {"mode": "degrade", "seed": args.seed, "device": str(reg.device),
              "hang_ticks": [hang_from, hang_from + hang_ticks],
              "hang_seconds": 2 * args.cadence, "degradation": deg,
              "missed_deadlines": stats["missed_deadlines"],
              "learned_group_ticks": stats["learned_group_ticks"],
              "group_ticks": full, "kernel_launches": launches,
              "events": {k: kinds.count(k) for k in sorted(set(kinds))},
              "stats": stats, "workdir": workdir}
    return _finish(args, report, failures,
                   f"OK: ladder max level {deg['max_level']}, recovered, "
                   f"{stats['learned_group_ticks']} of {full} group-ticks learned")


def run_child(args) -> int:
    """One serve-process lifetime of the supervised soak: recover the
    journal, resume the checkpoints, replay, then run the REMAINING ticks
    of the total budget over the seeded feed keyed by the global tick.
    Completing children print (and append to --stats-out) one stats line."""
    from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, TickJournal, parse_fsync
    from rtap_tpu_torch.service.checkpoint import peek_resume_ticks
    from rtap_tpu_torch.service.loop import live_loop

    w = args.workdir
    os.makedirs(w, exist_ok=True)
    policy, every_n = parse_fsync(args.journal_fsync)
    journal = TickJournal(os.path.join(w, "journal"), fsync=policy, fsync_every=every_n)
    ckdir = os.path.join(w, "ck")
    base = max(journal.next_tick, peek_resume_ticks(ckdir))
    ids = soak_ids(args.streams)
    reg = build_registry(args, ids, threshold=args.threshold, debounce=1)
    chaos = None
    if args.spec:
        # the schedule is GLOBAL-tick-indexed: a restarted child shifts it
        # onto its local clock (fired faults drop out — in particular the
        # proc_exit that killed the previous incarnation)
        chaos = ChaosEngine(ChaosSpec.from_file(args.spec).shifted(base))
    latency = slo = None
    # at cadence 0 there is no tick budget to default the SLO to
    if args.slo != "off" and (args.slo or args.cadence > 0):
        # the seeded feed runs on a synthetic epoch: the child contracts
        # on per-tick host latency, not the wall-anchored detect SLO
        from rtap_tpu_torch.obs.slo import tick_slo_pair

        latency, slo = tick_slo_pair(args.cadence, args.slo)
    stats = live_loop(seeded_source(args.seed, len(ids), base, args.spike_every), reg,
                      n_ticks=max(0, args.ticks - base), cadence_s=args.cadence,
                      alert_path=os.path.join(w, "alerts.jsonl"), checkpoint_dir=ckdir,
                      checkpoint_every=args.checkpoint_every,
                      pipeline_depth=args.pipeline_depth, journal=journal, chaos=chaos,
                      latency=latency, slo=slo)
    journal.close()
    line = {"base": base, "ran": stats["ticks"], "alerts": stats["alerts"],
            "scored": stats["scored"],
            "kernel_launches": stats["kernel_launches"]["tm_learn"],
            "learned_group_ticks": stats["learned_group_ticks"],
            "group_save_s_mean": stats.get("group_save_s_mean"),
            "checkpoints_saved": stats["checkpoints_saved"],
            "phase_ms_per_tick": stats.get("phase_ms_per_tick"),
            "journal": stats.get("journal", {}), "slo": stats.get("slo")}
    if args.stats_out:
        with open(args.stats_out, "a") as f:
            f.write(json.dumps(line) + "\n")
            f.flush()
    print(json.dumps(line), flush=True)
    return 0


def child_cmd(args, workdir: str, spec: str | None = None) -> list[str]:
    """The supervised child's argv (``python -m rtap_tpu_torch.chaos_soak
    --child ...``)."""
    cmd = [sys.executable, "-m", "rtap_tpu_torch.chaos_soak", "--child",
           "--workdir", workdir, "--seed", str(args.seed), "--ticks", str(args.ticks),
           "--streams", str(args.streams), "--group-size", str(args.group_size),
           "--cadence", str(args.cadence), "--checkpoint-every", str(args.checkpoint_every),
           "--device", args.device or "cuda", f"--threshold={args.threshold}",
           "--journal-fsync", "os", "--spike-every", str(args.spike_every),
           "--pipeline-depth", str(args.pipeline_depth),
           "--stats-out", os.path.join(workdir, "stats.jsonl")]
    if args.columns is not None:
        cmd += ["--columns", str(args.columns)]
    if args.slo is not None:
        cmd += ["--slo", args.slo]
    if spec:
        cmd += ["--spec", spec]
    return cmd


def run_supervised(args) -> int:
    """`--supervise`: seeded proc_exit kills + source/sink faults against
    the journaled child under the real Supervisor."""
    from rtap_tpu_torch.resilience import PROC_EXIT_CODE, ChaosSpec, Fault, Supervisor

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_supervise_")
    os.makedirs(workdir, exist_ok=True)
    n_groups = -(-args.streams // args.group_size)
    # in-process-safe kinds ride along at the normal rate; group-killing
    # kinds stay out (the journal replays a restart back to health anyway)
    base = ChaosSpec.generate(seed=args.seed, n_ticks=args.ticks, n_groups=n_groups,
                              rate=args.rate,
                              kinds=("source_timeout", "source_malformed", "alert_sink_oserror"))
    rng = random.Random(args.seed ^ 0x5EED)
    lo, hi = max(1, args.ticks // 5), max(2, args.ticks * 4 // 5)
    if not 1 <= args.kills <= hi - lo:
        log(f"--kills {args.kills} does not fit the schedulable window [{lo}, {hi}) of a "
            f"{args.ticks}-tick run (1..{hi - lo})")
        return 2
    kill_ticks = sorted(rng.sample(range(lo, hi), args.kills))
    faults = sorted(base.faults + [Fault(kind="proc_exit", tick=t) for t in kill_ticks],
                    key=lambda f: f.tick)
    spec = ChaosSpec(faults=faults, seed=args.seed)
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec.to_dict(), f)
    log(f"supervised schedule: {len(base.faults)} in-process faults + proc_exit at ticks "
        f"{kill_ticks}, digest {spec.digest()}")
    alerts_path = os.path.join(workdir, "alerts.jsonl")
    sup = Supervisor(child_cmd(args, workdir, spec_path), restart_budget=args.kills + 2,
                     backoff_base_s=0.05, backoff_max_s=1.0, event_path=alerts_path, log=log)
    rc = sup.run(install_signals=False)

    failures: list[str] = []
    if rc != 0:
        failures.append(f"supervised run ended rc={rc} (deaths={sup.deaths})")
    if sup.deaths != args.kills:
        failures.append(f"{sup.deaths} death(s) for {args.kills} scheduled proc_exit faults "
                        "— each must fire exactly once across restarts")
    bad_rc = [r for r in sup.death_rcs if r != PROC_EXIT_CODE]
    if bad_rc:
        failures.append(f"death rc(s) {bad_rc} are not the injected proc_exit "
                        f"(rc {PROC_EXIT_CODE}) — a real crash rode the schedule")
    total, lives = 0, []
    stats_path = os.path.join(workdir, "stats.jsonl")
    if os.path.isfile(stats_path):
        with open(stats_path) as f:
            for line in f:
                s = json.loads(line)
                lives.append(s)
                total = max(total, s["base"] + s["ran"])
    if total != args.ticks:
        failures.append(f"run completed {total} of {args.ticks} total ticks across restarts")
    parsed = parse_alert_stream(alerts_path)
    replay_events = sum(1 for e in parsed["events"] if e.get("event") == "journal_replayed")
    if parsed["dup"]:
        failures.append(f"{len(parsed['dup'])} duplicated alert_id(s) across restarts: "
                        f"{parsed['dup'][:5]}")
    if args.kills and not replay_events:
        failures.append("no journal_replayed event despite kills — recovery never ran")
    restarts = sum(1 for e in parsed["events"] if e.get("event") == "serve_child_restarting")
    report = {"mode": "supervise", "seed": args.seed, "schedule_digest": spec.digest(),
              "proc_exit_ticks": kill_ticks, "deaths": sup.deaths, "restarts": restarts,
              "ticks_completed": total, "alert_ids": len(parsed["alerts"]),
              "duplicated": len(parsed["dup"]), "journal_replay_events": replay_events,
              "last_life": lives[-1] if lives else None, "workdir": workdir}
    return _finish(args, report, failures,
                   f"OK: {sup.deaths} proc_exit death(s), {total} ticks completed, "
                   f"{len(parsed['alerts'])} alert ids unique, {replay_events} journal replays")


def run_topology_burst(args) -> int:
    """`--topology-burst`: a correlated multi-group value burst rides the
    seeded schedule; the verdict is ONE cluster-level incident."""
    from rtap_tpu_torch.correlate import IncidentCorrelator, TopologyMap
    from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, Fault
    from rtap_tpu_torch.service.loop import live_loop

    if args.streams < 12:
        log("--topology-burst floods nodes n1+n2 (stream indices 3..8) and needs healthy "
            "bystanders; use --streams >= 12")
        return 2
    # short probation so the default 120-tick run has a mature burst
    # window: burst at 3/4 of the run, likelihood ready at tick 60
    probation = 40 + 20
    burst_tick = args.ticks * 3 // 4
    burst_dur = 8
    if burst_tick <= probation + 5:
        log(f"burst tick {burst_tick} inside the likelihood probation {probation} — "
            "raise --ticks (>= 96)")
        return 2
    ids = soak_ids(args.streams)
    reg = build_registry(args, ids, cfg=soak_config(args.columns, probation=(40, 20)),
                         threshold=0.1, debounce=2)
    # the blast radius: every metric of nodes n1 and n2, straddling a group
    # boundary at the default group size
    burst_idx = tuple(range(3, 9))
    burst_nodes = sorted({ids[i].split(".")[0] for i in burst_idx})
    burst_groups = sorted({i // args.group_size for i in burst_idx})
    if len(burst_groups) < 2:
        log(f"burst indices {burst_idx} land in one group at --group-size "
            f"{args.group_size}; use a size that splits them")
        return 2
    base = ChaosSpec.generate(seed=args.seed, n_ticks=args.ticks, rate=args.rate,
                              kinds=("source_timeout",))
    burst = Fault(kind="topology_burst", tick=burst_tick, duration=burst_dur, streams=burst_idx)
    spec = ChaosSpec(faults=sorted(base.faults + [burst], key=lambda f: f.tick), seed=args.seed)
    engine = ChaosEngine(spec)
    log(f"schedule: burst on {burst_nodes} (groups {burst_groups}) at tick {burst_tick} + "
        f"{len(base.faults)} background fault(s), digest {spec.digest()}")
    correlator = IncidentCorrelator(TopologyMap.infer(), window_s=6, min_streams=4)
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_topo_")
    os.makedirs(workdir, exist_ok=True)
    alerts_path = os.path.join(workdir, "alerts.jsonl")
    stats = live_loop(seeded_source(args.seed, len(ids)), reg, n_ticks=args.ticks,
                      cadence_s=args.cadence, alert_path=alerts_path, chaos=engine,
                      correlator=correlator)
    failures: list[str] = []
    if stats["ticks"] != args.ticks:
        failures.append(f"loop stopped at tick {stats['ticks']} of {args.ticks}")
    if "topology_burst" not in {e["kind"] for e in engine.injected}:
        failures.append("the scheduled topology_burst never injected")
    parsed = parse_alert_stream(alerts_path)
    incs = [e for e in parsed["events"] if e.get("event") == "incident"]
    if len(incs) != 1:
        failures.append(f"{len(incs)} incident(s) emitted, expected exactly 1 for the burst")
    else:
        inc = incs[0]
        if len(inc["streams"]) < correlator.min_streams:
            failures.append(f"incident groups {len(inc['streams'])} distinct stream(s), below "
                            f"min_streams {correlator.min_streams}")
        if sorted(inc["nodes"]) != burst_nodes:
            failures.append(f"blast radius {inc['nodes']} != faulted nodes {burst_nodes}")
        missing = [a for a in inc["alert_ids"] if a not in parsed["alerts"]]
        if missing:
            failures.append(f"{len(missing)} incident member alert_id(s) not on the alert "
                            f"stream: {missing[:5]}")
    report = {"mode": "topology_burst", "seed": args.seed, "device": str(reg.device),
              "schedule_digest": spec.digest(), "burst_tick": burst_tick,
              "burst_nodes": burst_nodes, "burst_groups": burst_groups,
              "faults_injected": engine.injected, "alert_ids": len(parsed["alerts"]),
              "incidents": len(incs), "incident": incs[0] if len(incs) == 1 else None,
              "correlator": correlator.stats(), "workdir": workdir}
    return _finish(args, report, failures,
                   f"OK: 1 incident across groups {burst_groups} from "
                   f"{len(parsed['alerts'])} per-stream alert(s)")


def run_replication(args) -> int:
    """`--replication`: seeded wire faults against a live leader/standby
    pair; the verdict is standby state bit-identical to the leader's."""
    import threading
    import time

    from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, TickJournal
    from rtap_tpu_torch.resilience.replicate import Lease, ReplicationSender, StandbyFollower
    from rtap_tpu_torch.service.loop import _save_all, live_loop

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_repl_")
    os.makedirs(workdir, exist_ok=True)
    ids = soak_ids(args.streams)
    leader_reg = build_registry(args, ids, threshold=-1e9, debounce=1)
    standby_reg = build_registry(args, ids, threshold=-1e9, debounce=1)
    spec = ChaosSpec.generate(seed=args.seed, n_ticks=args.ticks, rate=args.rate,
                              kinds=("conn_drop", "stall_socket", "corrupt_bytes"))
    engine = ChaosEngine(spec)
    log(f"replication schedule: {len(spec.faults)} wire faults over {args.ticks} ticks, "
        f"digest {spec.digest()}")
    lease_path = os.path.join(workdir, "lease")
    # the pair must STAY a pair for this soak: the standby's view of the
    # lease has an enormous timeout, so it never promotes mid-run
    leader_lease = Lease(lease_path, "leader", timeout_s=30.0)
    standby_lease = Lease(lease_path, "standby", timeout_s=1e9)
    if not leader_lease.try_acquire():
        log(f"FATAL: the fresh lease {lease_path} is held by {leader_lease.holder()!r}")
        return 3
    stop = threading.Event()
    standby_journal = TickJournal(os.path.join(workdir, "standby-journal"))
    ckdir = os.path.join(workdir, "ck")
    follower = StandbyFollower(standby_reg, standby_journal, lease=standby_lease, port=0,
                               alert_path=None, checkpoint_dir=ckdir, cadence_s=args.cadence,
                               stop_event=stop)
    results: dict = {}
    t = threading.Thread(target=lambda: results.update(follow=follower.run()),
                         name="rtap-chaos-standby", daemon=True)
    t.start()
    deadline = time.monotonic() + 30.0
    while follower.address is None and time.monotonic() < deadline:
        time.sleep(0.01)
    if follower.address is None:
        log("FATAL: standby listener never came up")
        return 3
    leader_journal = TickJournal(os.path.join(workdir, "leader-journal"))
    sender = ReplicationSender(follower.address, leader_journal, checkpoint_dir=ckdir,
                               chaos=engine).start()
    leader_journal.tee = sender.tee
    leader_journal.compact_floor = sender.compact_floor
    stats = live_loop(seeded_source(args.seed, len(ids)), leader_reg, n_ticks=args.ticks,
                      cadence_s=args.cadence, alert_path=os.path.join(workdir, "alerts.jsonl"),
                      checkpoint_dir=ckdir, checkpoint_every=args.checkpoint_every,
                      journal=leader_journal, lease=leader_lease)
    failures: list[str] = []
    # let the standby drain the tail (the wire is asynchronous)
    deadline = time.monotonic() + 60.0
    while follower.expected < args.ticks and time.monotonic() < deadline:
        time.sleep(0.02)
    if follower.expected < args.ticks:
        failures.append(f"standby applied only {follower.expected} of {args.ticks} ticks "
                        "before the drain deadline")
    leader_journal.close()
    sender.close()
    leader_lease.stop_heartbeat()
    stop.set()
    t.join(timeout=30.0)
    standby_journal.close()
    # the verdict: bit-identical model state, leader vs standby, through
    # the soak's checkpoint comparison
    lck, sck = os.path.join(workdir, "verify-leader"), os.path.join(workdir, "verify-standby")
    _save_all(leader_reg.groups, lck)
    _save_all(standby_reg.groups, sck)
    leaves = compare_states(lck, sck, failures)
    missing = sorted({f.kind for f in spec.faults} - {e["kind"] for e in engine.injected})
    if missing:
        failures.append(f"scheduled wire fault kind(s) never injected: {missing}")
    if stats["ticks"] != args.ticks:
        failures.append(f"leader ran {stats['ticks']} of {args.ticks}")
    report = {"mode": "replication", "seed": args.seed, "schedule_digest": spec.digest(),
              "faults_scheduled": len(spec.faults), "faults_injected": engine.injected,
              "standby": follower.stats(), "sender": sender.stats(),
              "state_leaves_compared": leaves,
              "leader_kernel_launches": stats["kernel_launches"]["tm_learn"],
              "leader_learned_group_ticks": stats["learned_group_ticks"],
              "workdir": workdir}
    return _finish(args, report, failures,
                   f"OK: {len(engine.injected)} wire fault(s) injected, standby applied "
                   f"{follower.applied} ticks, {leaves} state leaves bit-identical")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch.chaos_soak",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-schedule seed; same seed = same schedule")
    ap.add_argument("--streams", type=int, default=12)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--cadence", type=float, default=0.05)
    ap.add_argument("--rate", type=float, default=0.08,
                    help="per-tick fault probability in the generated schedule")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--columns", type=int, default=None,
                    help="width-scale the cluster preset (default: full width)")
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--restore-after", type=int, default=6,
                    help="quarantine cooldown before checkpoint restore")
    ap.add_argument("--workdir", default=None,
                    help="alerts + checkpoints land here (default: a fresh temp dir)")
    ap.add_argument("--out", default=None, help="report JSON path")
    ap.add_argument("--inject", action="append", default=None, metavar="KIND@TICK:GROUP",
                    help="add an explicit fault to the generated schedule (repeatable), "
                         "e.g. collect_exception@40:1")
    ap.add_argument("--twin", action="store_true",
                    help="also run the fault-free twin and hold the untouched groups' "
                         "final state bit-equal to it")
    ap.add_argument("--degrade", action="store_true",
                    help="degradation drill: dispatch hangs on every group with the "
                         "ladder armed; verify it engages and recovers")
    ap.add_argument("--supervise", action="store_true",
                    help="out-of-process mode: seeded proc_exit kills of the journaled "
                         "child under the Supervisor; verify restarts, journal recovery "
                         "and zero duplicated alert ids")
    ap.add_argument("--kills", type=int, default=2,
                    help="proc_exit faults scheduled with --supervise")
    ap.add_argument("--topology-burst", action="store_true",
                    help="incident-correlation mode: a correlated multi-group burst; "
                         "verify exactly ONE cluster-level incident pages")
    ap.add_argument("--replication", action="store_true",
                    help="replication mode: seeded wire faults against a live "
                         "leader/standby pair; verify the standby applies every tick "
                         "and ends bit-identical to the leader")
    # the supervised child's own flags
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stats-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--threshold", type=float, default=-1e9,
                    help="alert threshold of the supervised child (default: every "
                         "stream alerts every tick, so exactly-once covers every id)")
    ap.add_argument("--journal-fsync", default="os", help=argparse.SUPPRESS)
    ap.add_argument("--spike-every", type=int, default=0,
                    help="the supervised child's feed spikes one stream every N ticks")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="the supervised child's pipeline depth")
    ap.add_argument("--slo", default=None,
                    help="the supervised child's tick SLO (default tick=<cadence>s@p99, "
                         "none at cadence 0; 'off' disarms it)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.child:
        return run_child(args)
    if sum((args.supervise, args.topology_burst, args.degrade, args.replication)) > 1:
        log("--supervise, --topology-burst, --degrade and --replication are separate drills")
        return 2
    if args.replication:
        return run_replication(args)
    if args.topology_burst:
        return run_topology_burst(args)
    if args.supervise:
        return run_supervised(args)
    if args.degrade:
        return run_degrade(args)
    return run_soak(args)


if __name__ == "__main__":
    sys.exit(main())
