"""rtap_tpu_torch command line: ``python -m rtap_tpu_torch <command>``.

    serve    live scoring loop at a fixed cadence, fed by a TCP JSONL push
             listener, an HTTP poll endpoint, or the RB1 binary batch
             protocol over sockets or a shared-memory ring (--ingest-*);
             prints one JSON stats line.
    replay   synthetic cluster replay through stream groups at full speed;
             prints one JSON line of stats.
    nab      NAB-style detection quality over a corpus: detect, sweep the
             threshold, print the normalized score of each cost profile.
    eval     fault-injection evaluation of the cluster preset: replay
             kind-labelled synthetic streams, sweep threshold x debounce,
             print (and --out) the JSON report.
    report   matplotlib overlays (metric, likelihood, alerts) of a replay,
             and a fault-eval report's per-kind recall chart.

All run on cuda unless --device cpu. The flags mirror the JAX package's
subcommands where they apply (``--device`` takes the place of
``--backend``). ``serve`` takes the JAX package's resilience and
observability flags (--chaos-spec, --degrade*, --quarantine-restore-after,
--supervise*, --latency*, --slo*, --trace-*, --postmortem-dir,
--flight-ticks, --obs-port, --obs-snapshot, --alert-attribution), its
binary ingest flags (--ingest-port, --ingest-shm, --ingest-quota,
--ingest-backfill-horizon), hot-standby replication under a leadership
lease (--replicate-to, --replicate-listen, --standby, --lease-file,
--lease-timeout), the fleet observability plane (--fleet-join,
--fleet-listen, --fleet-push-interval), the fleet control plane with its
shards (--control-listen, --control-journal, --control-only,
--control-join, --control-grace, --shard) and the scheduling flags
(--dispatch-threads, --chunk-stagger, --stagger-learn, --aot-warmup, on by
default); the two JAX serve flags with no meaning here exit 2 naming them
(:data:`UNPORTED_SERVE_FLAGS`), so nothing is silently ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

from rtap_tpu_torch.eval.report import add_report_flags

#: JAX-package serve flags the port does not take -> (takes a value, why:
#: the flag that replaces it). Each is parsed (hidden) so that giving it
#: exits 2 with its name instead of argparse's generic error.
UNPORTED_SERVE_FLAGS = {
    # an XLA device trace has no meaning here
    "--jax-trace": (True, "it traces XLA programs; the port's device profiler is "
                          "python -m rtap_tpu_torch.profile_tick"),
    "--backend": (True, "it takes --device cuda|cpu"),
}


def _apply_cadence(cfg, args: argparse.Namespace):
    """ModelConfig.learn_every from the operator flags (the shared policy
    ``with_learn_every``: an invalid k fails loudly)."""
    return cfg.with_learn_every(args.learn_every,
                                full_until=getattr(args, "learn_full_until", None),
                                burst=args.learn_burst)


def _sized_cluster(args: argparse.Namespace):
    from rtap_tpu_torch.config import cluster_preset, scaled_cluster_preset

    return cluster_preset() if args.columns is None else scaled_cluster_preset(args.columns)


def _serve_preset(args: argparse.Namespace):
    """The model family of ``serve --preset`` (``--columns`` scales the
    cluster preset only; main() refuses it with the others)."""
    from rtap_tpu_torch.config import categorical_preset, composite_preset, nab_preset

    if args.preset == "nab":
        return nab_preset()
    if args.preset == "composite":
        return composite_preset()
    if args.preset == "categorical":
        return categorical_preset()
    return _sized_cluster(args)


def _refused_serve_flag(args: argparse.Namespace) -> str | None:
    """The first given serve flag this package does not port, with why."""
    for flag, (_takes_value, why) in UNPORTED_SERVE_FLAGS.items():
        v = getattr(args, "unported_" + flag[2:].replace("-", "_"))
        if v is None or v is False:
            continue
        return f"{flag} is not ported to rtap_tpu_torch: {why}"
    return None


def _model_side_usage_error(args: argparse.Namespace) -> str | None:
    """The JAX package's usage errors of the health/predict/topology flags."""
    if (args.correlate_window is not None or args.correlate_min_streams is not None) \
            and not args.topology:
        return ("--correlate-window/--correlate-min-streams are incident-correlation "
                "knobs; add --topology (a spec path or 'infer')")
    if args.topology and not args.alerts:
        return ("--topology needs --alerts — incidents are emitted on (and "
                "resume-recovered from) the alert stream")
    if args.correlate_window is not None and args.correlate_window < 1:
        return "--correlate-window must be >= 1"
    if args.correlate_min_streams is not None and args.correlate_min_streams < 2:
        return ("--correlate-min-streams must be >= 2 (one stream is a per-stream "
                "alert, not an incident)")
    if (args.predict_horizon is not None or args.predict_threshold is not None
            or args.predict_min_ticks is not None) and not args.predict:
        return ("--predict-horizon/--predict-threshold/--predict-min-ticks are "
                "predictive-horizon knobs; add --predict")
    if args.predict_horizon is not None and args.predict_horizon < 1:
        return ("--predict-horizon must be >= 1 (the reducer scores each tick's "
                "prediction against the input that many ticks later)")
    if args.predict_min_ticks is not None and args.predict_min_ticks < 1:
        return "--predict-min-ticks must be >= 1"
    return None


def _resilience_obs_usage_error(args: argparse.Namespace) -> str | None:
    """The JAX package's usage errors of the latency/SLO, quarantine and
    supervision flags, checked before any device work."""
    if args.slo and not args.latency:
        return ("--slo declares an objective over the latency tracker's "
                "measurements; add --latency")
    if args.latency_window is not None and not args.latency:
        return "--latency-window sizes the quantile-sketch window; add --latency"
    if (args.slo_fast_window is not None or args.slo_slow_window is not None) \
            and not args.slo:
        return ("--slo-fast-window/--slo-slow-window are burn-rate knobs; add "
                "--slo NAME=TARGET@pQ")
    if args.latency_window is not None and args.latency_window < 1:
        return "--latency-window must be >= 1"
    if args.quarantine_restore_after < 0:
        return (f"--quarantine-restore-after must be >= 0; got "
                f"{args.quarantine_restore_after}")
    if args.quarantine_restore_after and not args.checkpoint_dir:
        return ("--quarantine-restore-after needs --checkpoint-dir: restore means "
                "re-loading the group's last checkpoint")
    if args.trace_ring < 1:
        return f"--trace-ring must be >= 1; got {args.trace_ring}"
    if args.flight_ticks < 1:
        return f"--flight-ticks must be >= 1; got {args.flight_ticks}"
    if args.supervise and not args.checkpoint_dir:
        return ("--supervise needs --checkpoint-dir (a restarted child must resume "
                "its fleet, not rescore from scratch); add --journal-dir for "
                "tick-exact catch-up")
    return None


def _ingest_usage_error(args: argparse.Namespace) -> str | None:
    """The JAX package's usage errors of the binary ingest flags."""
    binary = args.ingest_port is not None or bool(args.ingest_shm)
    if args.http and binary:
        return ("--http and --ingest-port/--ingest-shm are exclusive "
                "(one source feeds the loop)")
    if args.port and binary:
        return ("--port (JSONL listener) and --ingest-port/--ingest-shm "
                "are exclusive — the binary source replaces the JSONL one; "
                "a JSONL producer pointed at --port would get connection "
                "refused while serve reports healthy")
    if (args.ingest_quota or args.ingest_backfill_horizon) and not binary:
        return ("--ingest-quota/--ingest-backfill-horizon are binary-"
                "ingest admission knobs; add --ingest-port or --ingest-shm")
    return None


def _replication_usage_error(args: argparse.Namespace) -> str | None:
    """The JAX package's usage errors of the replication, lease and fleet
    flags (the same text), checked before any device work."""
    replicated = args.standby or bool(args.replicate_to)
    if args.replicate_to and not args.journal_dir:
        return "--replicate-to ships the write-ahead journal — add --journal-dir"
    if args.replicate_to and not args.lease_file and not args.control_join \
            and not args.standby:
        return ("--replicate-to needs --lease-file (or --control-join) — a leader "
                "without the lease cannot be fenced, and its standby (which "
                "requires the lease) would find it absent and promote "
                "immediately: two live leaders on one alert sink")
    if args.replicate_to and not args.checkpoint_dir:
        return ("--replicate-to needs --checkpoint-dir — the shared checkpoint dir "
                "is the reconnect-after-gap fallback (a standby whose position was "
                "compacted or evicted out of the journal resyncs from it) and the "
                "promotion target")
    if args.standby:
        missing = [f for f, v in (("--replicate-listen", args.replicate_listen is not None),
                                  ("--journal-dir", bool(args.journal_dir)),
                                  ("--checkpoint-dir", bool(args.checkpoint_dir)),
                                  ("--lease-file or --control-join",
                                   bool(args.lease_file) or bool(args.control_join)))
                   if not v]
        if missing:
            return (f"--standby needs {', '.join(missing)} (the standby mirrors the "
                    "journal, promotes from the shared checkpoint dir, and watches "
                    "the lease)")
        if args.supervise:
            return ("--standby under --supervise is unsupported — supervise the PAIR "
                    "from python -m rtap_tpu_torch.failover_soak instead (roles swap "
                    "across restarts)")
    if replicated and (args.auto_register or args.auto_release_after):
        return ("replication requires a FIXED fleet — --auto-register/"
                "--auto-release-after change membership mid-stream and the "
                "standby's slot addressing would diverge (elastic membership "
                "under replication is future work)")
    if replicated and args.topology:
        return ("--topology under replication is unsupported — the standby buffers "
                "would-be alert lines without correlation state, so a post-failover "
                "incident stream could not stay identical to the leader's "
                "(correlation under replication is future work)")
    if replicated and args.alert_attribution:
        return ("--alert-attribution under replication is unsupported — the "
                "standby buffers would-be alert lines WITHOUT the attributor's "
                "routing history, so a post-failover splice could not stay "
                "byte-identical to the leader's stream (attribution under "
                "replication is future work)")
    if replicated and args.predict:
        return ("--predict under replication is unsupported — the standby buffers "
                "would-be alert lines WITHOUT the tracker's hysteresis state, so a "
                "post-failover precursor stream could not stay identical to the "
                "leader's (predictive horizon under replication is future work)")
    if args.replicate_listen is not None and not args.standby:
        return ("--replicate-listen is the standby's listen port — add --standby "
                "(the leader side uses --replicate-to)")
    if args.fleet_join:
        _host, sep, port_s = args.fleet_join.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            port = -1
        if not sep or not 0 < port < 65536:
            return (f"bad --fleet-join {args.fleet_join!r} — expected HOST:PORT (the "
                    "fleet aggregator's listen address; an empty HOST means "
                    "127.0.0.1)")
    if args.fleet_listen is not None:
        if not 0 <= args.fleet_listen < 65536:
            return "--fleet-listen must be a TCP port (0 = ephemeral)"
        if args.obs_port is None:
            return ("--fleet-listen serves the merged fleet views on the obs HTTP "
                    "server's /fleet/* routes; add --obs-port")
    if args.fleet_push_interval is not None:
        if not args.fleet_join:
            return ("--fleet-push-interval paces the fleet telemetry push; add "
                    "--fleet-join HOST:PORT")
        if args.fleet_push_interval <= 0:
            return "--fleet-push-interval must be > 0"
    return None


def _control_usage_error(args: argparse.Namespace) -> str | None:
    """The JAX package's usage errors of the control-plane and shard flags
    (the same text), checked before any device work."""
    if args.control_listen is not None:
        if not 0 <= args.control_listen < 65536:
            return "--control-listen must be a TCP port (0 = ephemeral)"
        if not args.control_journal:
            return ("--control-listen needs --control-journal — the write-ahead "
                    "epoch journal is what keeps fencing monotonic across a "
                    "control-plane crash")
    if args.control_journal and args.control_listen is None:
        return ("--control-journal is the control plane's journal dir; add "
                "--control-listen PORT")
    if args.control_only and args.control_listen is None:
        return ("--control-only runs just the control plane; add --control-listen "
                "PORT (and --control-journal)")
    if args.streams is None and not args.control_only:
        # --streams is only optional for the pure control-plane process (it
        # scores nothing); every data-plane serve must name its fleet
        return "--streams is required (only --control-only runs without a stream fleet)"
    if args.control_join:
        if args.lease_file:
            return ("--control-join and --lease-file are exclusive — one lease "
                    "authority per process (under a control plane, IT owns the "
                    "shard lease)")
        _host, sep, port_s = args.control_join.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            port = -1
        if not sep or not 0 < port < 65536:
            return (f"bad --control-join {args.control_join!r} — expected HOST:PORT "
                    "(the control plane's listen address; an empty HOST means "
                    "127.0.0.1)")
    if args.control_grace is not None:
        if not args.control_join:
            return ("--control-grace bounds the cached-lease window under "
                    "--control-join; add --control-join HOST:PORT")
        if args.control_grace <= 0:
            return "--control-grace must be > 0"
    if args.shard < 0:
        return "--shard must be >= 0 (the mesh shard index)"
    return None


def _host_port(addr: str) -> tuple[str, int]:
    """``HOST:PORT`` (an empty HOST is 127.0.0.1) -> (host, port)."""
    host, _sep, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _resilience_obs(args: argparse.Namespace):
    """(chaos spec, degradation, latency, slo) from the flags, each None
    when off; a bad value is a usage error raised as ValueError with the
    JAX package's message."""
    from rtap_tpu_torch.obs import LatencyTracker, SloTracker, parse_slo
    from rtap_tpu_torch.resilience import ChaosSpec, DegradationController

    spec = None
    if args.chaos_spec:
        try:
            spec = ChaosSpec.from_file(args.chaos_spec)
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise ValueError(f"bad --chaos-spec {args.chaos_spec}: {e}") from e
        print(f"serve: chaos spec loaded ({len(spec.faults)} faults, digest "
              f"{spec.digest()})", file=sys.stderr)
    try:
        slo_specs = [parse_slo(x) for x in args.slo or ()]
    except ValueError as e:
        raise ValueError(f"bad --slo: {e}") from e
    latency = slo = None
    if args.latency:
        try:
            latency = LatencyTracker(window_ticks=args.latency_window
                                     if args.latency_window is not None else 120,
                                     cadence_s=args.cadence)
        except ValueError as e:
            raise ValueError(f"bad --latency-window: {e}") from e
        print(f"serve: detection-latency tracking armed (window {latency.window_ticks} "
              "ticks; GET /latency with --obs-port)", file=sys.stderr)
    if slo_specs:
        try:
            slo = SloTracker(slo_specs, cadence_s=args.cadence,
                             fast_window=args.slo_fast_window
                             if args.slo_fast_window is not None else 60,
                             slow_window=args.slo_slow_window
                             if args.slo_slow_window is not None else 600,
                             quantile_source=latency.quantile)
        except ValueError as e:
            raise ValueError(f"bad --slo/--slo-*-window: {e}") from e
        print("serve: SLOs armed: " + ", ".join(x.label() for x in slo_specs)
              + f" (burn windows {slo.fast_window}/{slo.slow_window} ticks)",
              file=sys.stderr)
    degradation = None
    if args.degrade:
        try:
            degradation = DegradationController(degrade_after=args.degrade_after,
                                                recover_after=args.degrade_recover_after)
        except ValueError as e:
            raise ValueError(f"bad --degrade parameters: {e}") from e
    return spec, degradation, latency, slo


def _supervise(args: argparse.Namespace) -> int:
    """``serve --supervise``: run ``python -m rtap_tpu_torch serve`` (the
    same argv, the supervisor's own flags removed) as a child and restart
    it after every abnormal death. This process never touches the card:
    the child owns it."""
    from rtap_tpu_torch.resilience.supervisor import Supervisor, strip_supervise_flags

    if not args.journal_dir:
        print("serve: --supervise without --journal-dir will lose the ticks since the "
              "last checkpoint on every restart (continuity yes, bit-exact catch-up no)",
              file=sys.stderr)
    child = [sys.executable, "-m", "rtap_tpu_torch", *strip_supervise_flags(args.argv)]
    sup = Supervisor(child, restart_budget=args.supervise_restarts,
                     backoff_base_s=args.supervise_backoff,
                     backoff_max_s=max(30.0, args.supervise_backoff),
                     event_path=args.alerts, postmortem_dir=args.postmortem_dir,
                     log=lambda m: print(m, file=sys.stderr))
    print(f"serve: supervising {' '.join(child[3:])} (restart budget "
          f"{args.supervise_restarts})", file=sys.stderr)
    return sup.run()


def _model_side_trackers(args: argparse.Namespace, cfg, ids: list[str], predict_k: int):
    """(health, correlator, predictor) from the flags, each None when off;
    a bad value is a usage error (exit 2) raised as ValueError with the
    JAX package's message."""
    from rtap_tpu_torch.correlate import IncidentCorrelator, TopologyMap
    from rtap_tpu_torch.obs.health import HealthTracker
    from rtap_tpu_torch.predict import BlastFuser, PredictTracker

    correlator = None
    if args.topology:
        try:
            topo = TopologyMap.infer() if args.topology == "infer" \
                else TopologyMap.from_spec(args.topology)
            # only user-set knobs become kwargs: the class owns the defaults
            knobs = {k: v for k, v in (("window_s", args.correlate_window),
                                       ("min_streams", args.correlate_min_streams))
                     if v is not None}
            correlator = IncidentCorrelator(topo, **knobs)
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise ValueError(f"bad --topology {args.topology}: {e}") from e
        print(f"serve: incident correlation armed "
              f"({'inferred' if args.topology == 'infer' else args.topology}; "
              f"window {correlator.window_s}s, min {correlator.min_streams} streams)",
              file=sys.stderr)
    health = None
    if args.health:
        try:
            health = HealthTracker(cfg, occupancy_threshold=args.health_occupancy_threshold,
                                   sparsity_min_frac=args.health_sparsity_min_frac,
                                   drift_threshold=args.health_drift_threshold,
                                   drift_min_ticks=args.health_drift_min_ticks)
        except ValueError as e:
            raise ValueError(f"bad --health parameters: {e}") from e
        print("serve: model-health reducers armed "
              f"(drift tvd>={args.health_drift_threshold} after "
              f"{args.health_drift_min_ticks} ticks, pool occupancy>="
              f"{args.health_occupancy_threshold})", file=sys.stderr)
    predictor = None
    if args.predict:
        try:
            predictor = PredictTracker(
                horizon=predict_k,
                threshold=args.predict_threshold if args.predict_threshold is not None else 0.35,
                min_ticks=args.predict_min_ticks if args.predict_min_ticks is not None else 12,
                blast=BlastFuser(correlator.topology, seed_streams=ids)
                if correlator is not None else None)
        except ValueError as e:
            raise ValueError(f"bad --predict parameters: {e}") from e
        print(f"serve: predictive horizon armed (k={predict_k} ticks, miss ewma>="
              f"{predictor.threshold} for {predictor.min_ticks} ticks"
              + (", blast fusion on" if predictor.blast is not None else "") + ")",
              file=sys.stderr)
    return health, correlator, predictor


def _cmd_serve(args: argparse.Namespace) -> int:
    refused = _refused_serve_flag(args) or _model_side_usage_error(args) \
        or _resilience_obs_usage_error(args) or _ingest_usage_error(args) \
        or _replication_usage_error(args) or _control_usage_error(args)
    if refused:
        print(f"serve: {refused}", file=sys.stderr)
        return 2
    if args.freeze and args.auto_register:
        print("serve: --freeze with --auto-register would claim fresh models "
              "that can never learn; register streams in a learning serve, "
              "then freeze", file=sys.stderr)
        return 2
    if args.supervise:
        # before any device work: the parent must never hold the card its
        # child needs
        return _supervise(args)
    if args.control_listen is None:
        return _serve_data_plane(args)
    # the control plane (fleet/control.py): one fencing lease per shard,
    # membership and the shard map, epochs journaled write-ahead. Started
    # before any device or service import, so a --control-only process never
    # touches the card
    from rtap_tpu_torch.fleet.control import ControlPlane

    try:
        plane = ControlPlane(args.control_journal, port=args.control_listen,
                             lease_timeout_s=args.lease_timeout).start()
    except (OSError, ValueError) as e:
        print(f"serve: control plane failed to start: {e}", file=sys.stderr)
        return 2
    try:
        chost, cport = plane.address
        print(f"serve: control plane on {chost}:{cport} (journal {args.control_journal}, "
              f"{plane.recovered_shards} shard lease(s) recovered)", file=sys.stderr, flush=True)
        if not args.control_only:
            return _serve_data_plane(args)
        cstop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: cstop.set())
        cstop.wait()
        print(json.dumps({"control": plane.stats(), "stopped": True}))
        return 0
    finally:
        plane.close()


def _serve_data_plane(args: argparse.Namespace) -> int:
    """One data-plane serve: the stream groups, the journal, the lease (a
    file or the control plane's), the standby phase, the live loop."""
    from rtap_tpu_torch.obs import (
        ExpositionServer,
        FlightRecorder,
        TraceRecorder,
        default_snapshot_path,
        write_snapshot,
    )
    from rtap_tpu_torch.obs.health import bump_run_epoch, set_build_info
    from rtap_tpu_torch.obs.metrics import get_registry
    from rtap_tpu_torch.resilience.journal import TickJournal, parse_fsync
    from rtap_tpu_torch.service.checkpoint import peek_resume_ticks
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry
    from rtap_tpu_torch.service.shardpath import shard_scoped_path
    from rtap_tpu_torch.service.sources import HttpPollSource, TcpJsonlSource

    for attr in ("journal_dir", "checkpoint_dir", "lease_file", "alerts"):
        if getattr(args, attr):
            setattr(args, attr, shard_scoped_path(getattr(args, attr), args.shard))
    if args.streams.startswith("@"):
        # @file: one id per line (a large fleet's comma list exceeds argv limits)
        try:
            with open(args.streams[1:]) as f:
                ids = [s.strip() for s in f if s.strip()]
        except OSError as e:
            print(f"serve: cannot read stream-id file {args.streams[1:]}: {e}", file=sys.stderr)
            return 2
    else:
        ids = [s.strip() for s in args.streams.split(",") if s.strip()]
    if not ids:
        print("serve: --streams must name at least one stream id", file=sys.stderr)
        return 2
    if args.group_size < 1:
        print("serve: --group-size must be >= 1", file=sys.stderr)
        return 2
    cfg = _apply_cadence(_serve_preset(args), args)
    gsize = min(args.group_size, len(ids))
    # --auto-register without reserved capacity can only claim rounding
    # pads: one extra group's worth by default
    reserve = args.reserve if args.reserve is not None else (gsize if args.auto_register else 0)
    # the horizon sizes device state, so it is fixed when the groups are built
    predict_k = (args.predict_horizon if args.predict_horizon is not None else 8) \
        if args.predict else 0
    try:
        health, correlator, predictor = _model_side_trackers(args, cfg, ids, predict_k)
        chaos_spec, degradation, latency, slo = _resilience_obs(args)
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    # built before any listener: without a card (and without --device cpu)
    # this raises, and nothing is left to clean up
    t_reg = time.perf_counter()
    reg = StreamGroupRegistry(cfg, group_size=gsize, device=args.device,
                              threshold=args.threshold, debounce=args.debounce,
                              health=args.health, predict=predict_k,
                              stagger_learn=args.stagger_learn)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize(reserve=reserve)
    registry_build_s = time.perf_counter() - t_reg
    # the write-ahead journal: constructing it recovers (torn tails
    # truncated, rows loaded for replay); with it, --ticks is the run's
    # TOTAL budget across restarts
    journal = None
    n_ticks = args.ticks
    if args.journal_dir:
        try:
            policy, every = parse_fsync(args.journal_fsync)
            journal = TickJournal(args.journal_dir, segment_bytes=args.journal_segment_bytes,
                                  max_segments=args.journal_max_segments,
                                  fsync=policy, fsync_every=every)
        except (OSError, ValueError) as e:
            print(f"serve: bad --journal-dir/--journal-fsync: {e}", file=sys.stderr)
            return 2
        base = journal.next_tick
        if args.checkpoint_dir:
            base = max(base, peek_resume_ticks(args.checkpoint_dir))
        n_ticks = max(0, args.ticks - base)
        if base:
            print(f"serve: resuming at tick {base} ({len(journal.recovered_ticks)} "
                  f"journaled rows recovered; --ticks {args.ticks} is the total "
                  f"budget -> {n_ticks} new ticks)", file=sys.stderr)
        if base and chaos_spec is not None:
            # the schedule is GLOBAL-tick-indexed: a restarted serve shifts it
            # onto its local clock, so the proc_exit that killed the previous
            # incarnation does not fire again
            chaos_spec = chaos_spec.shifted(base)
            print(f"serve: chaos schedule shifted to resume base {base} "
                  f"({len(chaos_spec.faults)} faults remain)", file=sys.stderr)
        if journal.truncations or journal.dropped_segments:
            print(f"serve: journal tail truncated on recovery ({journal.truncations} "
                  f"truncation(s), {journal.truncated_bytes} bytes, "
                  f"{journal.dropped_segments} dropped segment(s)) — continuing "
                  "from the last valid record", file=sys.stderr)
    chaos = None
    if chaos_spec is not None:
        from rtap_tpu_torch.resilience import ChaosEngine

        chaos = ChaosEngine(chaos_spec)
    # the leadership lease: a LEADER acquires it now (refusing to start
    # split-brained), a STANDBY only watches it until promotion
    lease = None
    if args.lease_file:
        from rtap_tpu_torch.resilience.replicate import Lease

        lease = Lease(args.lease_file, owner=f"{os.uname().nodename}:{os.getpid()}",
                      timeout_s=args.lease_timeout)
        if not args.standby:
            if not lease.try_acquire():
                print(f"serve: lease {args.lease_file} is held by {lease.holder()!r} and "
                      "fresh — refusing to serve split-brained (start this process with "
                      "--standby, or wait out the lease timeout)", file=sys.stderr)
                return 2
            # liveness = process alive, not tick-loop fast: the heartbeat
            # keeps the lease fresh through multi-second save rounds
            lease.start_heartbeat()
    elif args.control_join:
        # the same FencingLease surface with the control plane behind it: the
        # loop, alert fence, follower and heartbeat cannot tell the two apart
        from rtap_tpu_torch.fleet.control import ControlLease, parse_control_addr

        lease = ControlLease(parse_control_addr(args.control_join),
                             owner=f"{os.uname().nodename}:{os.getpid()}", shard=args.shard,
                             timeout_s=args.lease_timeout, degraded_grace_s=args.control_grace)
        lease.hello("standby" if args.standby else "leader")
        if not args.standby:
            if not lease.try_acquire():
                print(f"serve: control plane {args.control_join} refused the shard "
                      f"{args.shard} lease (held by {lease.holder()!r}, in its restart "
                      "grace, or unreachable) — start with --standby, or wait out the "
                      "lease timeout", file=sys.stderr)
                return 2
            lease.start_heartbeat()
    # orderly shutdown: SIGTERM/SIGINT finish the current tick (or end a
    # standby's follow loop), save final state and still print stats; a
    # second signal force-exits
    stop = threading.Event()
    prev = {}

    def _on_signal(*_):
        stop.set()
        for s, h in prev.items():
            signal.signal(s, h)

    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, _on_signal)
    if lease is not None and hasattr(lease, "on_drain"):
        # a control-plane drain mark becomes an orderly between-tick exit:
        # the SIGTERM path, so final state is saved and the stats line printed
        lease.on_drain = stop.set
    # the fleet plane's member side, started before the standby block so
    # the aggregator sees the follow loop, the promotion and the served
    # remainder as one member timeline
    fleet_pub = None
    if args.fleet_join:
        from rtap_tpu_torch.fleet import FleetPublisher

        frole = "standby" if args.standby else "leader"
        fleet_pub = FleetPublisher(
            _host_port(args.fleet_join), f"{frole}-{os.getpid()}", role=frole,
            lease_epoch=lease.epoch if lease is not None else 0,
            push_interval_s=args.fleet_push_interval
            if args.fleet_push_interval is not None else 1.0).start()
        print(f"serve: fleet member {fleet_pub.member!r} pushing to {args.fleet_join} "
              f"every {fleet_pub.push_interval_s}s", file=sys.stderr, flush=True)
    follower = resume_sup = None
    if args.standby:
        follower, n_ticks = _follow_as_standby(args, reg, journal, lease, stop, fleet_pub)
        if follower is None:
            return 0  # stopped while following (its stats line is printed)
        resume_sup = follower.resume_suppression
    sender = None
    if args.replicate_to:
        from rtap_tpu_torch.resilience.replicate import ReplicationSender

        sender = ReplicationSender(_host_port(args.replicate_to), journal,
                                   checkpoint_dir=args.checkpoint_dir, chaos=chaos).start()
        journal.tee = sender.tee
        journal.compact_floor = sender.compact_floor
        print(f"serve: replicating journal appends to {args.replicate_to} (bounded "
              "buffer, drop-oldest)", file=sys.stderr, flush=True)
    # restart continuity: <alerts>.epoch counts this serve's starts; the
    # build-info gauge says who this process is (a serve reaching this point
    # serves as the leader: a standby already promoted above)
    run_epoch = bump_run_epoch(args.alerts)
    set_build_info(role="leader", shard=args.shard, run_epoch=run_epoch, config=cfg)
    # the span ring also backs the obs server's /trace route
    trace = flight = None
    if args.trace_out or args.postmortem_dir or args.obs_port is not None:
        # real process identity on the timeline: fleet.trace stitches
        # multi-process traces by pid and labels tracks by this name
        trace = TraceRecorder(capacity=args.trace_ring,
                              process_name=fleet_pub.member if fleet_pub is not None
                              else f"rtap-serve-{os.getpid()}")
    if args.postmortem_dir:
        os.makedirs(args.postmortem_dir, exist_ok=True)
        flight = FlightRecorder(
            trace=trace, n_ticks=args.flight_ticks, out_dir=args.postmortem_dir,
            info={"command": "serve", "streams": len(ids), "group_size": gsize,
                  "cadence_s": args.cadence, "ticks": args.ticks,
                  "device": str(reg.device), "preset": args.preset,
                  "micro_chunk": args.micro_chunk,
                  "pipeline_depth": args.pipeline_depth, "freeze": bool(args.freeze)})
        print(f"serve: flight recorder armed (last {args.flight_ticks} ticks -> "
              f"{args.postmortem_dir})", file=sys.stderr)
    attributor = None
    if args.alert_attribution:
        from rtap_tpu_torch.service.attribution import AlertAttributor

        attributor = AlertAttributor(cfg)
    if fleet_pub is not None:
        fleet_pub.set_role("leader", run_epoch=run_epoch)
        fleet_pub.attach(health=health, latency=latency, slo=slo, correlator=correlator,
                         trace=trace)
    if latency is not None:
        # lag gauges polled once per tick: the replication-ack lag while a
        # standby is attached, the incident-close lag while correlating
        if sender is not None:
            latency.lag_providers["repl_ack_ticks"] = lambda _t, _ts: sender.ack_lag_ticks()
        if correlator is not None:
            latency.lag_providers["incident_close_s"] = \
                lambda _t, ts: correlator.oldest_open_age_s(ts)
    if args.http:
        source = HttpPollSource(args.http, reg.dispatch_ids(), track_unknown=args.auto_register)
        close = lambda: None  # noqa: E731
    elif args.ingest_port is not None or args.ingest_shm:
        # the RB1 binary batch protocol over persistent sockets and/or a
        # shared-memory ring, addressed by the registry's slot map
        from rtap_tpu_torch.ingest import BinaryBatchSource

        bsrc = BinaryBatchSource(reg.slot_map(), port=args.ingest_port,
                                 shm=args.ingest_shm or None, quota_rows=args.ingest_quota,
                                 backfill_horizon=args.ingest_backfill_horizon,
                                 track_unknown=args.auto_register).start()
        if bsrc.address is not None:
            bhost, bport = bsrc.address
            print(f"serve: listening for binary batch frames on {bhost}:{bport}",
                  file=sys.stderr, flush=True)
        if bsrc.ring_name is not None:
            print(f"serve: binary ingest shm ring {bsrc.ring_name!r} created "
                  "(co-located exporters attach by name)", file=sys.stderr, flush=True)
        source, close = bsrc, bsrc.close
    else:
        tcp = TcpJsonlSource(reg.dispatch_ids(), port=args.port,
                             track_unknown=args.auto_register).start()
        host, port = tcp.address
        print(f"serve: listening for JSONL records on {host}:{port}", file=sys.stderr,
              flush=True)
        source, close = tcp, tcp.close
    # the fleet plane's aggregator side: the merged views ride the obs HTTP
    # server's /fleet/* routes (--fleet-listen requires --obs-port)
    fleet_agg = None
    if args.fleet_listen is not None:
        from rtap_tpu_torch.fleet import FleetAggregator

        fleet_agg = FleetAggregator(port=args.fleet_listen).start()
        print(f"serve: fleet aggregator on {fleet_agg.host}:{fleet_agg.port} (merged "
              "views at the obs server's GET /fleet/* routes)", file=sys.stderr, flush=True)
    obs_server = None
    if args.obs_port is not None:
        obs_server = ExpositionServer(
            port=args.obs_port, trace=trace, flight=flight, health=health,
            correlator=correlator, latency=latency, slo=slo, predict=predictor,
            fleet=fleet_agg, healthz_stale_after_s=max(30.0, 10 * args.cadence)).start()
        ohost, oport = obs_server.address
        print(f"serve: obs telemetry on http://{ohost}:{oport}/metrics", file=sys.stderr,
              flush=True)
    obs_snapshot = args.obs_snapshot or default_snapshot_path()
    if lease is not None and hasattr(source, "announce_leader") \
            and getattr(source, "address", None) is not None:
        # the lease advertises this leader's binary ingest address, so a
        # fenced predecessor can re-point its producers (the MAP leader hint)
        lhost, lport = source.address
        lease.set_meta(ingest=f"{lhost}:{lport}")
    try:
        try:
            stats = live_loop(source, reg, n_ticks=n_ticks, cadence_s=args.cadence,
                              alert_path=args.alerts, checkpoint_dir=args.checkpoint_dir,
                              checkpoint_every=args.checkpoint_every, stop_event=stop,
                              pipeline_depth=args.pipeline_depth,
                              dispatch_threads=args.dispatch_threads, learn=not args.freeze,
                              auto_register=args.auto_register,
                              auto_release_after=args.auto_release_after,
                              micro_chunk=args.micro_chunk, chunk_stagger=args.chunk_stagger,
                              chaos=chaos, degradation=degradation,
                              quarantine_restore_after=args.quarantine_restore_after,
                              alert_flush_every=args.alert_flush_every,
                              aot_warmup=args.aot_warmup, trace=trace,
                              flight=flight, attributor=attributor, journal=journal,
                              health=health, correlator=correlator, latency=latency,
                              slo=slo, predictor=predictor, lease=lease,
                              resume_suppression=resume_sup, fleet=fleet_pub)
        except BaseException as e:
            # the crash black box: an exception escaping serve dumps a
            # postmortem bundle before the traceback
            if flight is not None:
                flight.record_event({"event": "unhandled_exception",
                                     "error": f"{type(e).__name__}: {e}"})
                flight.dump("unhandled_exception")
            raise
        if stats.get("fenced"):
            # fenced out by a promoted standby: re-point any connected
            # binary producers at the new leader before the source closes
            hint = lease.holder_meta().get("ingest")
            if hint and hasattr(source, "announce_leader"):
                source.announce_leader(hint)
                print(f"serve: pushed MAP re-point to new leader {hint}", file=sys.stderr)
        if lease is not None and hasattr(lease, "degraded"):
            stats["control_lease"] = lease.stats()
        if _drained(lease):
            # drained by the control plane: an orderly handoff — release the
            # lease (the plane keeps the epoch floor) so the standby promotes
            # at once instead of waiting out staleness
            lease.stop_heartbeat()
            lease.release()
            stats["drained"] = True
            print(f"serve: shard {args.shard} drained — lease released, the standby "
                  "takes over", file=sys.stderr)
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        close()
        if sender is not None:
            sender.close()
        if lease is not None:
            lease.stop_heartbeat()
        if journal is not None:
            journal.tee = None
            journal.close()
        if fleet_pub is not None:
            # joined push-thread exit with a best-effort BYE; an abrupt death
            # instead goes stale and the aggregator marks it DOWN. A drain
            # exit says so in the BYE: a rolling upgrade is not an outage
            fleet_pub.close(reason="drain" if _drained(lease) else None)
        if obs_server is not None:
            obs_server.close()
        if fleet_agg is not None:
            # after the obs server: no /fleet/* route may race a closed
            # aggregator
            fleet_agg.close()
        if args.trace_out and trace is not None:
            # Chrome trace JSON, atomically (tmp + replace), even on an
            # error path; best effort: it must not mask the loop's exception
            try:
                tmp = args.trace_out + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(trace.chrome_trace(), f)
                os.replace(tmp, args.trace_out)
                print(f"serve: host trace written to {args.trace_out} ({trace.total} "
                      f"records, {trace.dropped} dropped)", file=sys.stderr)
            except OSError as e:
                print(f"serve: trace write failed: {e}", file=sys.stderr)
        if obs_snapshot:
            # the final registry snapshot, even on an error path
            try:
                write_snapshot(obs_snapshot)
            except OSError as e:
                print(f"serve: obs snapshot write failed: {e}", file=sys.stderr)
    # ingest health belongs in the service artifact: a zero-missed-deadline
    # line is only evidence if data was flowing and parsing cleanly
    for attr in ("records_parsed", "parse_errors", "unknown_ids", "native_active",
                 "poll_failures", "polls_short_circuited", "frames_applied",
                 "garbage_bytes", "rows_quota_dropped", "rows_late_dropped",
                 "rows_backfilled", "rows_backpressure_dropped", "rows_stale_epoch"):
        v = getattr(source, attr, None)
        if v is not None:
            stats[attr] = v
    stats["device"] = str(reg.device)
    stats["preset"] = args.preset
    stats["registry_build_s"] = round(registry_build_s, 4)
    if sender is not None:
        stats["replication"] = sender.stats()
    if follower is not None:
        stats["promoted_from_standby"] = True
        stats["promote_detect_s"] = round(follower.promote_detect_s, 3)
        stats["standby"] = {
            **follower.stats(), "kernel_launches": follower.kernel_launches,
            # the takeover split: lease-staleness detection, the alert-stream
            # splice and the warm-fleet checkpoint at the takeover tick
            "takeover": {"detect_s": follower.promote_detect_s,
                         "splice_s": follower.promote_splice_s,
                         "checkpoint_s": follower.promote_checkpoint_s}}
    # the process's telemetry registry, read once at exit (live: --obs-port)
    stats["telemetry"] = get_registry().snapshot()
    if stats.get("fenced"):
        from rtap_tpu_torch.resilience.replicate import FENCED_RC

        print(f"serve: FENCED by {lease.holder()!r} at epoch "
              f"{lease.holder_meta().get('epoch')} — exiting rc {FENCED_RC}", file=sys.stderr)
        print(json.dumps(stats))
        return FENCED_RC
    print(json.dumps(stats))
    return 0


def _drained(lease) -> bool:
    """Whether the control plane marked this serve's shard draining."""
    return bool(getattr(lease, "draining", False))


def _follow_as_standby(args: argparse.Namespace, reg, journal, lease, stop, fleet_pub):
    """``serve --standby``: mirror the leader's journal stream and keep the
    fleet warm at the live edge (one learning pass per group per applied
    tick), promote when the lease goes stale -> (follower, the ticks left
    to serve as leader), or (None, 0) when stopped while following (its
    stats line printed)."""
    import rtap_tpu_torch.ops.tm_learn as tm_learn
    from rtap_tpu_torch.resilience.replicate import StandbyFollower
    from rtap_tpu_torch.service.checkpoint import peek_resume_ticks

    follower = StandbyFollower(reg, journal, lease=lease, port=args.replicate_listen,
                               alert_path=args.alerts, checkpoint_dir=args.checkpoint_dir,
                               learn=not args.freeze, cadence_s=args.cadence, stop_event=stop)
    print(f"serve: standby following on port {args.replicate_listen} (lease "
          f"{args.lease_file or f'control:{args.control_join}'}, timeout "
          f"{args.lease_timeout}s)", file=sys.stderr, flush=True)
    launches0 = tm_learn.launches
    outcome = follower.run()
    launches = tm_learn.launches - launches0
    if outcome == "stopped":
        journal.close()
        if fleet_pub is not None:
            fleet_pub.close()  # orderly BYE: the fleet sees "left"
        print(json.dumps({"standby": {**follower.stats(), "kernel_launches": launches},
                          "stopped": True}))
        return None, 0
    # promoted: the follower checkpointed the warm fleet and spliced the
    # alert stream; serve the REMAINING budget as the leader (the loop's
    # resume picks it all up)
    base = max(journal.next_tick, 0)
    if args.checkpoint_dir:
        base = max(base, peek_resume_ticks(args.checkpoint_dir))
    n_ticks = max(0, args.ticks - base)
    follower.kernel_launches = launches
    lease.start_heartbeat()
    if fleet_pub is not None:
        # the promotion IS a fleet event: the same member, a new role, the
        # successor lease epoch
        fleet_pub.set_role("leader", lease_epoch=lease.epoch)
        fleet_pub.set_tick_base(base)
    print(f"serve: standby PROMOTED to leader at tick {base} (lease epoch {lease.epoch}, "
          f"detected in {follower.promote_detect_s:.3f}s; {n_ticks} ticks remain)",
          file=sys.stderr, flush=True)
    return follower, n_ticks


def _cmd_replay(args: argparse.Namespace) -> int:
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.service.replay import replay_streams

    min_len = 80  # the generator needs room for post-probation injections
    if args.length < min_len:
        print(f"replay: --length must be >= {min_len} (fault injections land "
              "past the probation region)", file=sys.stderr)
        return 2
    cfg = _apply_cadence(_sized_cluster(args), args)
    streams = cluster_streams(3 * args.nodes, args.length, args.seed,
                              anomaly_magnitude=args.magnitude)
    res = replay_streams(streams, cfg, device=args.device, group_size=args.group_size,
                         chunk_ticks=args.chunk_ticks, threshold=args.threshold,
                         alert_path=args.alerts, checkpoint_dir=args.checkpoint_dir,
                         checkpoint_every=args.checkpoint_every,
                         debounce=args.debounce, learn=not args.freeze)
    print(json.dumps({"streams": len(res.stream_ids), "ticks": len(res.timestamps),
                      "device": args.device or "cuda", **res.throughput}))
    return 0


def _cmd_nab(args: argparse.Namespace) -> int:
    """Load a NAB-layout corpus, run the detector over every file, sweep
    the threshold exhaustively, report normalized per-profile scores."""
    import numpy as np

    from rtap_tpu_torch.data.nab_corpus import NAB_CORPUS_ENV, NabFile, load_corpus
    from rtap_tpu_torch.nab.runner import run_corpus

    repo =os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = args.corpus or os.environ.get(NAB_CORPUS_ENV) or os.path.join(repo, "data", "nab")
    if not os.path.isfile(os.path.join(root, "labels", "combined_windows.json")):
        print(f"nab: no corpus at {root} (need data/**/*.csv + labels/"
              "combined_windows.json). Pass --corpus, set "
              f"${NAB_CORPUS_ENV}, or regenerate the stand-in: "
              "python -c 'from rtap_tpu_torch.data.nab_corpus import "
              "ensure_standin_corpus; ensure_standin_corpus(\"data/nab\")'",
              file=sys.stderr)
        return 2
    files = load_corpus(root, subset=args.subset)
    if not files:
        print(f"nab: corpus at {root} matched no files "
              f"(subset={args.subset!r})", file=sys.stderr)
        return 2
    if args.rows:
        files = [NabFile(f.name, f.timestamps[: args.rows],
                         f.values[: args.rows], f.windows) for f in files]
    cfg = None
    if args.columns:
        from rtap_tpu_torch.config import scaled_nab_preset

        cfg = scaled_nab_preset(args.columns)
    from rtap_tpu_torch.ops import tm_learn

    launches0 = tm_learn.launches
    t0 = time.time()
    res = run_corpus(files, cfg=cfg, device=args.device)
    wall = time.time() - t0
    scores = {prof: {"threshold": round(thr, 4), "score": round(score, 2)}
              for prof, (thr, score) in res.scores.items()}
    report = {
        "corpus_root": os.path.abspath(root),
        "device": args.device or "cuda",
        "files": [f.name for f in files],
        "records": int(sum(len(f.values) for f in files)),
        "wall_s": round(wall, 1),
        "scores": scores,
        # unrounded, for comparing two runs
        "scores_exact": {prof: {"threshold": thr, "score": score}
                         for prof, (thr, score) in res.scores.items()},
        "wall_s_exact": wall,
        "kernel_launches": {"tm_learn": tm_learn.launches - launches0},
    }
    if res.group is not None and res.group.device.type == "cuda":
        import torch

        report["max_memory_allocated"] = torch.cuda.max_memory_allocated(res.group.device)
    if args.save_group:
        from rtap_tpu_torch.service.checkpoint import save_group

        save_group(res.group, args.save_group)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    if args.detections:
        # per-file rows: detection score (log-likelihood), and raw on the
        # batched path
        arrays = {f"loglik/{f.name}": s for f, (s, _, _) in zip(files, res.per_file)}
        if res.raw is not None:
            arrays.update({f"raw/{f.name}": r for f, r in zip(files, res.raw)})
        os.makedirs(os.path.dirname(os.path.abspath(args.detections)), exist_ok=True)
        with open(args.detections, "wb") as f:  # the name as given, no .npz added
            np.savez(f, **arrays)
    print(json.dumps(scores))
    return 0


def _cmd_eval(args: argparse.Namespace) -> int:
    """The fault-injection eval (eval/fault_eval.py) at the flags' config."""
    from rtap_tpu_torch.data.synthetic import ANOMALY_KINDS
    from rtap_tpu_torch.eval.fault_eval import eval_config, run_fault_eval

    if args.backend is not None:
        print("eval: --backend is not ported to rtap_tpu_torch: it takes --device cuda|cpu",
              file=sys.stderr)
        return 2
    cfg = eval_config(likelihood=args.likelihood, learning_period=args.learning_period,
                      learn_every=args.learn_every, learn_burst=args.learn_burst)
    kinds = ANOMALY_KINDS if args.all_kinds else ("spike", "level_shift", "dropout")
    report = run_fault_eval(n_streams=args.streams, length=args.length, kinds=kinds,
                            magnitude=args.magnitude, cfg=cfg, device=args.device,
                            default_debounce=args.debounce)
    print(report.to_json())
    if args.out:
        with open(args.out, "w") as f:
            f.write(report.to_json())
        print(f"report written to {args.out}", file=sys.stderr)
    return 0


def _cmd_report(args: argparse.Namespace) -> int:
    from rtap_tpu_torch.eval.report import write_report

    write_report(args.out_dir, args.streams, args.length, args.eval_report,
                 device=args.device)
    return 0


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--debounce", type=int, default=2,
                   help="alert only after this many consecutive ticks at/above threshold")
    p.add_argument("--learn-every", type=int, default=1,
                   help="learning cadence: learn every k-th tick once the "
                        "likelihood learning_period has passed (k=1 = full rate)")
    p.add_argument("--learn-burst", type=int, default=1,
                   help="burst shape of the thinned cadence: B consecutive "
                        "learn ticks per k*B cycle")
    p.add_argument("--columns", type=int, default=None,
                   help="width-scale the cluster preset")
    p.add_argument("--alerts", default=None, help="JSONL alert sink path")
    p.add_argument("--checkpoint-dir", default=None,
                   help="atomic per-group resume checkpoints (numpy leaves + "
                        "meta.json); a rerun with the same dir resumes every group")


def _add_resilience_obs_flags(p: argparse.ArgumentParser) -> None:
    """serve's resilience and observability flags (the JAX package's)."""
    p.add_argument("--chaos-spec", default=None,
                   help="JSON fault-injection schedule ({'seed': S, 'faults': [...]} or "
                        "{'seed': S, 'generate': {'n_ticks': T, 'n_groups': G, 'rate': R}}): "
                        "source timeouts, dispatch/collect exceptions, alert-sink and "
                        "checkpoint OSErrors, proc_exit etc. at exactly the scheduled ticks")
    p.add_argument("--degrade", action="store_true",
                   help="shed load under sustained deadline misses down the ladder "
                        "learn_thin -> score_only -> tick_widen, with hysteresis; emits "
                        "degraded/recovered events and rtap_obs_degradation_level")
    p.add_argument("--degrade-after", type=int, default=3,
                   help="misses within the 10-tick window that escalate the ladder one "
                        "level (with --degrade)")
    p.add_argument("--degrade-recover-after", type=int, default=15,
                   help="consecutive clean ticks that de-escalate one level (with --degrade)")
    p.add_argument("--quarantine-restore-after", type=int, default=0,
                   help="re-load a quarantined group from its last checkpoint after this "
                        "many ticks (needs --checkpoint-dir; 0 = quarantine is permanent "
                        "for the run)")
    p.add_argument("--supervise", action="store_true",
                   help="run serve as a supervised child process: abnormal deaths restart "
                        "it with exponential backoff under a restart budget, each death "
                        "evented on the alert stream (needs --checkpoint-dir; pair with "
                        "--journal-dir for tick-exact catch-up)")
    p.add_argument("--supervise-restarts", type=int, default=10,
                   help="supervisor restart budget: abnormal deaths beyond it exit 3")
    p.add_argument("--supervise-backoff", type=float, default=0.5,
                   help="supervisor restart backoff base seconds (doubles per fast death, "
                        "capped at 30 s)")
    p.add_argument("--latency", action="store_true",
                   help="detection-latency observability: per-tick stage waterfalls and a "
                        "per-alert end-to-end detect sketch (host wall clocks only: the "
                        "alert stream and model state are the same with it off)")
    p.add_argument("--latency-window", type=int, default=None,
                   help="quantile-sketch window in ticks (default 120); needs --latency")
    p.add_argument("--slo", action="append", default=None, metavar="NAME=TARGET@pQ",
                   help="declare a latency SLO (repeatable), e.g. detect=2s@p99 or "
                        "tick=500ms@p95, judged with fast/slow burn rates; slo_burn events "
                        "ride the alert stream; needs --latency")
    p.add_argument("--slo-fast-window", type=int, default=None,
                   help="fast burn-rate window in ticks (default 60); needs --slo")
    p.add_argument("--slo-slow-window", type=int, default=None,
                   help="slow burn-rate window in ticks (default 600); needs --slo")
    p.add_argument("--trace-out", default=None,
                   help="write the per-tick host span timeline as Chrome trace JSON here "
                        "on exit (also GET /trace?last=N with --obs-port)")
    p.add_argument("--trace-ring", type=int, default=65536,
                   help="span-ring capacity in records per writer thread")
    p.add_argument("--postmortem-dir", default=None,
                   help="arm the flight recorder: the last --flight-ticks ticks dump here "
                        "as a postmortem bundle on a quarantine, a ladder move, a miss "
                        "burst, an incident or a crash")
    p.add_argument("--flight-ticks", type=int, default=240,
                   help="flight-recorder window in ticks")
    p.add_argument("--obs-port", type=int, default=None,
                   help="serve the telemetry over localhost HTTP (GET /metrics, /healthz, "
                        "/snapshot, /trace, /latency, /slo, /health, /predict, /incidents, "
                        "/postmortem); 0 binds an ephemeral port")
    p.add_argument("--obs-snapshot", default=None,
                   help="append one JSONL telemetry snapshot line to this file on exit "
                        "(default: $RTAP_OBS_SNAPSHOT if set)")
    p.add_argument("--alert-attribution", action="store_true",
                   help="alert lines gain a top_fields block naming the encoder fields "
                        "whose representation moved most")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="live scoring loop fed by TCP push or HTTP poll")
    _add_model_flags(p)
    p.add_argument("--streams", default=None,
                   help="comma-separated stream ids, or @/path/to/file with one id per line")
    p.add_argument("--http", default=None,
                   help="poll this metrics endpoint each tick (default: TCP listener)")
    p.add_argument("--port", type=int, default=0, help="TCP listen port (0 = ephemeral)")
    p.add_argument("--ingest-port", type=int, default=None,
                   help="listen for the RB1 binary batch protocol on this "
                        "port (0 = ephemeral) instead of per-record JSONL: "
                        "length-prefixed CRC-framed frames of packed "
                        "(slot, value, ts_delta) rows addressed by the "
                        "registry's (shard, group, slot) slot map, decoded "
                        "with zero per-record Python — the wire-speed "
                        "ingest front end (python -m "
                        "rtap_tpu_torch.ingest_bench measures it)")
    p.add_argument("--ingest-shm", default=None,
                   help="also create a shared-memory frame ring under this "
                        "name for co-located exporters (same RB1 frames, "
                        "no socket; combine with --ingest-port or use "
                        "alone). The ring is drained once per tick")
    p.add_argument("--ingest-quota", type=int, default=0,
                   help="admission control: max binary-ingest rows per "
                        "tenant per tick (frames carry a tenant header); "
                        "rows beyond the quota are dropped + counted "
                        "(rtap_obs_ingest_quota_dropped_total). 0 = off")
    p.add_argument("--ingest-backfill-horizon", type=int, default=0,
                   help="binary-ingest timestamp alignment: hold emission "
                        "this many SECONDS (of row timestamp) behind the "
                        "newest row seen, so late rows land in the slot "
                        "their timestamp names instead of overwriting "
                        "the latest value; older-than-horizon rows drop "
                        "(counted). At the standard 1 s cadence a second "
                        "is a tick. 0 = latest-wins (JSONL-equivalent "
                        "semantics, the default)")
    p.add_argument("--ticks", type=int, default=60)
    p.add_argument("--cadence", type=float, default=1.0)
    p.add_argument("--preset", default="cluster",
                   choices=("cluster", "nab", "composite", "categorical"),
                   help="model family: cluster (default; --columns scales it), nab "
                        "(2048 columns, f32, window likelihood), composite (value, "
                        "delta and event-class fields of one wire value) or "
                        "categorical (the value as a category id)")
    p.add_argument("--group-size", type=int, default=1024, help="streams per device group")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint cadence in ticks (0 = save only on exit)")
    p.add_argument("--journal-dir", default=None,
                   help="per-tick write-ahead journal: rows are appended before "
                        "scoring and a restarted serve replays those past its "
                        "checkpoint; --ticks becomes the total budget across restarts")
    p.add_argument("--journal-fsync", default="os",
                   help="'os' (default), 'every-tick', or 'every-N'")
    p.add_argument("--journal-segment-bytes", type=int, default=4 << 20)
    p.add_argument("--journal-max-segments", type=int, default=256)
    p.add_argument("--learn-full-until", type=int, default=None,
                   help="ticks of full-rate learning before the cadence thins "
                        "(default: the likelihood learning_period). 0 measures the "
                        "mature steady state")
    p.add_argument("--chunk-stagger", action="store_true",
                   help="with --micro-chunk M: rotate chunk boundaries across groups "
                        "(group i flushes at ticks == i mod M) so each tick dispatches "
                        "~1/M of the fleet instead of the whole fleet's chunk work on "
                        "every M-th tick. Elastic membership and periodic checkpoints "
                        "force a one-tick boundary realignment when they fire")
    p.add_argument("--stagger-learn", action="store_true",
                   help="stagger the learning-cadence phase across groups (group i "
                        "learns on ticks == i mod k): spreads the fleet's learning load "
                        "evenly over ticks instead of spiking every k-th tick")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="2 = collect tick k after dispatching k+1 (alerts lag one tick)")
    p.add_argument("--micro-chunk", type=int, default=1,
                   help="batch M consecutive ticks into one dispatch per group, at <= "
                        "(depth*M - 1) ticks of alert staleness")
    p.add_argument("--dispatch-threads", type=int, default=1,
                   help="issue per-group dispatch/collect calls from N threads (one "
                        "default CUDA stream: the threads overlap host work); output "
                        "is bit-identical to serial dispatch")
    p.add_argument("--aot-warmup", action=argparse.BooleanOptionalAction, default=True,
                   help="run every knowable (chunk length, config, learn-phase) program "
                        "once before tick 0 (service/aot.py) so no first kernel launch, "
                        "allocation or pinned block lands inside a scored tick; "
                        "--no-aot-warmup leaves that to tick 0")
    p.add_argument("--shard", type=int, default=0,
                   help="this serve's mesh shard index: scopes the journal/checkpoint/lease/"
                        "alert paths per shard and names the control-plane lease this "
                        "process claims under --control-join")
    p.add_argument("--control-listen", type=int, default=None, metavar="PORT",
                   help="host the fleet CONTROL PLANE on localhost PORT (0 = ephemeral): one "
                        "fencing lease per shard, membership/claims, and the shard map. "
                        "Needs --control-journal — every epoch grant is journaled "
                        "write-ahead (RJ framing, fsync before the reply), so a kill-9'd "
                        "control plane restarts with epochs strictly monotonic")
    p.add_argument("--control-journal", default=None, metavar="DIR",
                   help="the control plane's write-ahead journal dir — the "
                        "epoch-durability root for --control-listen")
    p.add_argument("--control-only", action="store_true",
                   help="run ONLY the control plane (no data plane, no card): serve "
                        "leases/membership until SIGTERM, then print a stats line. Needs "
                        "--control-listen")
    p.add_argument("--control-join", default=None, metavar="HOST:PORT",
                   help="hold this shard's lease THROUGH the control plane at HOST:PORT "
                        "instead of a --lease-file: acquire/heartbeat/fence over control "
                        "RPCs. An unreachable plane degrades — the loop keeps ticking on "
                        "the cached lease for a bounded, counted window (--control-grace), "
                        "then self-fences; a standby never promotes on control-plane "
                        "silence")
    p.add_argument("--control-grace", type=float, default=None, metavar="SECONDS",
                   help="the bounded cached-lease window under --control-join (default "
                        "max(10x lease timeout, 30s)): a control plane unreachable past "
                        "this self-fences the holder — fail-safe, never split-brain")
    p.add_argument("--replicate-to", default=None, metavar="HOST:PORT",
                   help="hot-standby replication: tee every journal append — the "
                        "exact CRC-framed record bytes — to a standby serve listening "
                        "there, through a bounded drop-oldest buffer (a slow standby "
                        "never stalls the tick; rtap_obs_repl_* sizes the lag). Needs "
                        "--journal-dir, --lease-file and --checkpoint-dir; journal "
                        "compaction pauses at the standby's ack while one is connected")
    p.add_argument("--standby", action="store_true",
                   help="run as the hot standby: listen for a leader's replication "
                        "stream (--replicate-listen), apply every shipped tick through "
                        "the normal scoring path (bit-identical warm state), emit "
                        "nothing, and PROMOTE to leader when the lease goes stale — "
                        "splicing the alert stream exactly-once and serving the "
                        "remaining --ticks budget. Needs --replicate-listen, "
                        "--journal-dir, --checkpoint-dir and --lease-file")
    p.add_argument("--replicate-listen", type=int, default=None,
                   help="standby replication listen port (0 = ephemeral)")
    p.add_argument("--lease-file", default=None,
                   help="leadership lease file (shared storage): the leader's heartbeat "
                        "thread refreshes it at timeout/3; a standby promotes when it "
                        "goes stale, bumping the monotonic fencing epoch — a paused old "
                        "leader that wakes up is fenced out of the alert sink and exits "
                        "rc 7")
    p.add_argument("--lease-timeout", type=float, default=5.0,
                   help="seconds without a lease refresh before a standby declares the "
                        "leader dead and promotes (staleness must persist an extra "
                        "timeout/2; detection ~= 1.5x timeout)")
    p.add_argument("--fleet-join", default=None, metavar="HOST:PORT",
                   help="join the fleet observability plane: push this process's full "
                        "telemetry (registry snapshot, health rollup, latency sketch "
                        "states, SLO windows, open-incident digest) to the fleet "
                        "aggregator at HOST:PORT once per --fleet-push-interval, off "
                        "the tick path")
    p.add_argument("--fleet-listen", type=int, default=None, metavar="PORT",
                   help="host the fleet aggregator: accept member pushes on localhost "
                        "PORT (0 = ephemeral) and serve the merged views on the obs "
                        "server's GET /fleet/* routes (requires --obs-port)")
    p.add_argument("--fleet-push-interval", type=float, default=None, metavar="SECONDS",
                   help="fleet telemetry push cadence (default 1.0; needs --fleet-join); "
                        "the member declares 3 missed pushes as its DOWN horizon")
    p.add_argument("--auto-register", action="store_true",
                   help="lazily create a model for every new stream id seen on the wire")
    p.add_argument("--reserve", type=int, default=None,
                   help="extra claimable pad slots (default 0, or one group with "
                        "--auto-register)")
    p.add_argument("--auto-release-after", type=int, default=0,
                   help="release a stream's slot after N consecutive silent ticks")
    p.add_argument("--alert-flush-every", type=int, default=1,
                   help="flush the alert sink once per N batches")
    p.add_argument("--freeze", action="store_true",
                   help="inference-only serving: model state frozen, likelihood "
                        "adapts, the checkpoint dir is read-only")
    p.add_argument("--health", action="store_true",
                   help="model-health reducers: per-group segment-pool occupancy, "
                        "permanence sketch, SDR sparsity, hit rate and score "
                        "histogram each tick (reads only: scores and state are "
                        "unchanged), folded into scorecards with score-drift "
                        "detection; pool_saturated / sparsity_collapsed / "
                        "score_drift events ride the alert stream")
    p.add_argument("--health-occupancy-threshold", type=float, default=0.9,
                   help="segment-pool mean occupancy at/above which a group raises "
                        "pool_saturated (with --health)")
    p.add_argument("--health-sparsity-min-frac", type=float, default=0.5,
                   help="fraction of the expected active-column density (k/C) below "
                        "which a live group raises sparsity_collapsed (with --health)")
    p.add_argument("--health-drift-threshold", type=float, default=0.25,
                   help="total-variation distance between the fast and slow EWMA "
                        "score distributions at/above which a group raises "
                        "score_drift (with --health)")
    p.add_argument("--health-drift-min-ticks", type=int, default=120,
                   help="scored ticks a group folds before the drift detector may fire")
    p.add_argument("--predict", action="store_true",
                   help="predictive horizon: each tick's predicted-active columns are "
                        "scored against the input k ticks later (scores and state "
                        "unchanged); sustained divergence pages a precursor event "
                        "before the anomaly score crosses the threshold, and with "
                        "--topology one predicted_incident with the predicted blast "
                        "radius at the first node")
    p.add_argument("--predict-horizon", type=int, default=None,
                   help="prediction lead k in ticks (default 8, with --predict)")
    p.add_argument("--predict-threshold", type=float, default=None,
                   help="predictive-miss EWMA level at/above which a stream counts "
                        "as diverging (default 0.35, with --predict)")
    p.add_argument("--predict-min-ticks", type=int, default=None,
                   help="consecutive diverging scored ticks before a precursor fires "
                        "(default 12, with --predict)")
    p.add_argument("--topology", default=None,
                   help="topology-aware incident correlation: a JSON topology spec "
                        "path ({'services': {...}, 'links': [...]}) or 'infer' (node/"
                        "service from stream-name prefixes); alerts on adjacent nodes "
                        "fold into cluster-level 'incident' events on the alert "
                        "stream. Needs --alerts")
    p.add_argument("--correlate-window", type=int, default=None,
                   help="incident quiescence window in seconds of source timestamp "
                        "(default 30; above the pipeline's alert staleness); needs "
                        "--topology")
    p.add_argument("--correlate-min-streams", type=int, default=None,
                   help="distinct alerting streams a closed window needs to emit an "
                        "incident (default 3); needs --topology")
    _add_resilience_obs_flags(p)
    for flag, (takes_value, _where) in UNPORTED_SERVE_FLAGS.items():
        dest = "unported_" + flag[2:].replace("-", "_")
        p.add_argument(flag, dest=dest, help=argparse.SUPPRESS,
                       **({"default": None} if takes_value
                          else {"action": "store_true", "default": None}))
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("replay", help="synthetic cluster replay at full speed")
    _add_model_flags(p)
    p.add_argument("--nodes", type=int, default=32, help="nodes x 3 metrics = streams")
    p.add_argument("--length", type=int, default=1500)
    p.add_argument("--magnitude", type=float, default=6.0)
    p.add_argument("--group-size", type=int, default=None)
    p.add_argument("--chunk-ticks", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=4,
                   help="checkpoint cadence in collected chunks (with --checkpoint-dir)")
    p.add_argument("--freeze", action="store_true",
                   help="inference-only replay: no SP/TM updates; likelihood still adapts")
    p.set_defaults(fn=_cmd_replay)

    p = sub.add_parser("nab", help="NAB corpus run: detect -> threshold sweep -> "
                                   "normalized score")
    p.add_argument("--corpus", default=None,
                   help="NAB-layout corpus root (data/**/*.csv + labels/"
                        "combined_windows.json). Default: $RTAP_NAB_CORPUS, else the "
                        "committed stand-in at <repo>/data/nab")
    p.add_argument("--subset", default=None,
                   help="relative-path prefix filter, e.g. realAWSCloudwatch")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    p.add_argument("--columns", type=int, default=None,
                   help="width-scaled NAB model (scaled_nab_preset) instead of the "
                        "2048-column preset")
    p.add_argument("--rows", type=int, default=None,
                   help="truncate files to this many rows")
    p.add_argument("--out", default=None, help="report JSON path (default: print "
                                               "scores only)")
    p.add_argument("--detections", default=None,
                   help="write each file's per-row detection scores (and raw "
                        "scores on the batched path) to this .npz")
    p.add_argument("--save-group", default=None,
                   help="save the batched group's final state (every file's model and "
                        "likelihood) as a group checkpoint in this directory")
    p.set_defaults(fn=_cmd_nab)

    p = sub.add_parser("eval", help="fault-injection evaluation -> JSON report")
    p.add_argument("--streams", type=int, default=120)
    p.add_argument("--length", type=int, default=1500)
    p.add_argument("--magnitude", type=float, default=6.0)
    p.add_argument("--all-kinds", action="store_true",
                   help="include the hard gradual kinds (drift, stuck)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    p.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    p.add_argument("--debounce", type=int, default=2)
    p.add_argument("--likelihood", choices=("window", "streaming"), default="streaming",
                   help="likelihood mode; streaming is the production config, "
                        "window the NuPIC-faithful comparison study")
    p.add_argument("--learning-period", type=int, default=None,
                   help="override the likelihood probation length in ticks")
    p.add_argument("--learn-every", type=int, default=1,
                   help="learning cadence: learn every k-th tick once the "
                        "likelihood learning_period has passed (k=1 = full rate)")
    p.add_argument("--learn-burst", type=int, default=1,
                   help="burst shape of the thinned cadence: B consecutive "
                        "learn ticks per k*B cycle")
    p.add_argument("--out", default=None, help="write the JSON report here")
    p.set_defaults(fn=_cmd_eval)

    p = sub.add_parser("report", help="matplotlib overlays (metric/likelihood/alerts)")
    add_report_flags(p)
    p.set_defaults(fn=_cmd_report)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # serve --supervise re-runs this argv (its own flags removed) as the child
    args.argv = list(argv) if argv is not None else sys.argv[1:]
    # a usage error surfaces before any device work
    if getattr(args, "preset", "cluster") != "cluster" and \
            getattr(args, "columns", None) is not None:
        print("serve: --columns applies to the cluster preset only "
              "(the NAB family scales via scaled_nab_preset; the "
              "composite/categorical presets fix their field geometry)",
              file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
