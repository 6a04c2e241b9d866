"""rtap_tpu_torch command line: ``python -m rtap_tpu_torch <command>``.

    serve    live scoring loop at a fixed cadence, fed by a TCP JSONL push
             listener or an HTTP poll endpoint; prints one JSON stats line.
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
``--backend``); every JAX serve flag this package does not port yet exits 2
naming it, so nothing is silently ignored.
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

#: JAX-package serve flags not ported yet -> (takes a value, ROADMAP.md queue
#: item that ports it; "--device" for the flag it replaces). Each is parsed
#: (hidden) so that giving it exits 2 with its name instead of argparse's
#: generic error.
UNPORTED_SERVE_FLAGS = {
    **dict.fromkeys(("--chaos-spec", "--degrade-after", "--degrade-recover-after",
                     "--quarantine-restore-after", "--supervise-restarts",
                     "--supervise-backoff", "--replicate-to", "--replicate-listen",
                     "--lease-file", "--lease-timeout", "--control-listen",
                     "--control-journal", "--control-join", "--control-grace"),
                    (True, "the resilience slice")),
    **dict.fromkeys(("--degrade", "--supervise", "--standby", "--control-only"),
                    (False, "the resilience slice")),
    **dict.fromkeys(("--fleet-join", "--fleet-listen", "--fleet-push-interval"),
                    (True, "the resilience slice")),
    **dict.fromkeys(("--ingest-port", "--ingest-shm", "--ingest-quota",
                     "--ingest-backfill-horizon"), (True, "binary ingest")),
    **dict.fromkeys(("--latency-window", "--slo", "--slo-fast-window", "--slo-slow-window",
                     "--trace-out", "--trace-ring", "--postmortem-dir", "--flight-ticks",
                     "--obs-port", "--obs-snapshot", "--jax-trace"),
                    (True, "observability")),
    **dict.fromkeys(("--latency", "--alert-attribution"), (False, "observability")),
    **dict.fromkeys(("--chunk-stagger", "--stagger-learn", "--aot-warmup"),
                    (False, "scheduling")),
    "--backend": (True, "--device"),
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
    for flag, (_takes_value, where) in UNPORTED_SERVE_FLAGS.items():
        v = getattr(args, "unported_" + flag[2:].replace("-", "_"))
        if v is None or v is False:
            continue
        if where == "--device":
            return f"{flag} is not ported to rtap_tpu_torch: it takes --device cuda|cpu"
        return f"{flag} is not ported to rtap_tpu_torch yet ({where}; ROADMAP.md queue A)"
    for flag, ok, where in (("--shard", args.shard == 0, "A.11"),
                            ("--dispatch-threads", args.dispatch_threads == 1, "scheduling")):
        if not ok:
            return (f"{flag} {getattr(args, flag[2:].replace('-', '_'))} is not ported to "
                    f"rtap_tpu_torch yet ({where}; ROADMAP.md queue A)")
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
    refused = _refused_serve_flag(args) or _model_side_usage_error(args)
    if refused:
        print(f"serve: {refused}", file=sys.stderr)
        return 2
    if args.freeze and args.auto_register:
        print("serve: --freeze with --auto-register would claim fresh models "
              "that can never learn; register streams in a learning serve, "
              "then freeze", file=sys.stderr)
        return 2
    if args.streams is None:
        print("serve: --streams is required", file=sys.stderr)
        return 2
    from rtap_tpu_torch.obs.health import bump_run_epoch
    from rtap_tpu_torch.obs.metrics import get_registry
    from rtap_tpu_torch.resilience.journal import TickJournal, parse_fsync
    from rtap_tpu_torch.service.checkpoint import peek_resume_ticks
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry
    from rtap_tpu_torch.service.shardpath import shard_scoped_path
    from rtap_tpu_torch.service.sources import HttpPollSource, TcpJsonlSource

    for attr in ("journal_dir", "checkpoint_dir", "alerts"):
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
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    # built before any listener: without a card (and without --device cpu)
    # this raises, and nothing is left to clean up
    reg = StreamGroupRegistry(cfg, group_size=gsize, device=args.device,
                              threshold=args.threshold, debounce=args.debounce,
                              health=args.health, predict=predict_k)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize(reserve=reserve)
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
        if journal.truncations or journal.dropped_segments:
            print(f"serve: journal tail truncated on recovery ({journal.truncations} "
                  f"truncation(s), {journal.truncated_bytes} bytes, "
                  f"{journal.dropped_segments} dropped segment(s)) — continuing "
                  "from the last valid record", file=sys.stderr)
    # restart continuity: <alerts>.epoch counts this serve's starts
    bump_run_epoch(args.alerts)
    # orderly shutdown: SIGTERM/SIGINT finish the current tick, save final
    # state and still print stats; a second signal force-exits
    stop = threading.Event()
    prev = {}

    def _on_signal(*_):
        stop.set()
        for s, h in prev.items():
            signal.signal(s, h)

    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, _on_signal)
    if args.http:
        source = HttpPollSource(args.http, reg.dispatch_ids(), track_unknown=args.auto_register)
        close = lambda: None  # noqa: E731
    else:
        tcp = TcpJsonlSource(reg.dispatch_ids(), port=args.port,
                             track_unknown=args.auto_register).start()
        host, port = tcp.address
        print(f"serve: listening for JSONL records on {host}:{port}", file=sys.stderr,
              flush=True)
        source, close = tcp, tcp.close
    try:
        stats = live_loop(source, reg, n_ticks=n_ticks, cadence_s=args.cadence,
                          alert_path=args.alerts, checkpoint_dir=args.checkpoint_dir,
                          checkpoint_every=args.checkpoint_every, stop_event=stop,
                          pipeline_depth=args.pipeline_depth, learn=not args.freeze,
                          auto_register=args.auto_register,
                          auto_release_after=args.auto_release_after,
                          micro_chunk=args.micro_chunk,
                          alert_flush_every=args.alert_flush_every, journal=journal,
                          health=health, correlator=correlator, predictor=predictor)
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        close()
        if journal is not None:
            journal.close()
    # ingest health belongs in the service artifact: a zero-missed-deadline
    # line is only evidence if data was flowing and parsing cleanly
    for attr in ("records_parsed", "parse_errors", "unknown_ids", "native_active",
                 "poll_failures", "polls_short_circuited"):
        v = getattr(source, attr, None)
        if v is not None:
            stats[attr] = v
    stats["device"] = str(reg.device)
    stats["preset"] = args.preset
    # the process's telemetry registry, read once at exit (the JAX
    # package's live exposition, --obs-port/--obs-snapshot, is not ported)
    stats["telemetry"] = get_registry().snapshot()
    print(json.dumps(stats))
    return 0


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
                        "(default: the likelihood learning_period)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="2 = collect tick k after dispatching k+1 (alerts lag one tick)")
    p.add_argument("--micro-chunk", type=int, default=1,
                   help="batch M consecutive ticks into one dispatch per group")
    p.add_argument("--dispatch-threads", type=int, default=1,
                   help="only 1 is ported (serial dispatch)")
    p.add_argument("--shard", type=int, default=0, help="only shard 0 is ported")
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
    for flag, (takes_value, _where) in UNPORTED_SERVE_FLAGS.items():
        dest = "unported_" + flag[2:].replace("-", "_")
        if flag == "--aot-warmup":
            # --no-aot-warmup asks for what this package always does
            p.add_argument(flag, dest=dest, action=argparse.BooleanOptionalAction,
                           default=None, help=argparse.SUPPRESS)
            continue
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
