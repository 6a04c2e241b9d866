"""rtap_tpu_torch command line: ``python -m rtap_tpu_torch <command>``.

    serve    live scoring loop at a fixed cadence, fed by a TCP JSONL push
             listener or an HTTP poll endpoint; prints one JSON stats line.
    replay   synthetic cluster replay through stream groups at full speed;
             prints one JSON line of stats.

Both run on cuda unless --device cpu. The flags mirror the JAX package's
subcommands where they apply (``--device`` takes the place of
``--backend``); every JAX serve flag this package does not port yet exits 2
naming it, so nothing is silently ignored.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

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
    **dict.fromkeys(("--health-occupancy-threshold", "--health-sparsity-min-frac",
                     "--health-drift-threshold", "--health-drift-min-ticks",
                     "--predict-horizon", "--predict-threshold", "--predict-min-ticks",
                     "--topology", "--correlate-window", "--correlate-min-streams"),
                    (True, "A.8")),
    **dict.fromkeys(("--health", "--predict"), (False, "A.8")),
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


def _refused_serve_flag(args: argparse.Namespace) -> str | None:
    """The first given serve flag this package does not port, with why."""
    for flag, (_takes_value, where) in UNPORTED_SERVE_FLAGS.items():
        v = getattr(args, "unported_" + flag[2:].replace("-", "_"))
        if v is None or v is False:
            continue
        if where == "--device":
            return f"{flag} is not ported to rtap_tpu_torch: it takes --device cuda|cpu"
        return f"{flag} is not ported to rtap_tpu_torch yet ({where}; ROADMAP.md queue A)"
    for flag, ok, where in (("--preset", args.preset == "cluster", "A.2, A.9"),
                            ("--shard", args.shard == 0, "A.11"),
                            ("--dispatch-threads", args.dispatch_threads == 1, "scheduling")):
        if not ok:
            return (f"{flag} {getattr(args, flag[2:].replace('-', '_'))} is not ported to "
                    f"rtap_tpu_torch yet ({where}; ROADMAP.md queue A)")
    return None


def _cmd_serve(args: argparse.Namespace) -> int:
    refused = _refused_serve_flag(args)
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
    cfg = _apply_cadence(_sized_cluster(args), args)
    gsize = min(args.group_size, len(ids))
    # --auto-register without reserved capacity can only claim rounding
    # pads: one extra group's worth by default
    reserve = args.reserve if args.reserve is not None else (gsize if args.auto_register else 0)
    # built before any listener: without a card (and without --device cpu)
    # this raises, and nothing is left to clean up
    reg = StreamGroupRegistry(cfg, group_size=gsize, device=args.device,
                              threshold=args.threshold, debounce=args.debounce)
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
                          alert_flush_every=args.alert_flush_every, journal=journal)
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
                   help="model family (only cluster is ported)")
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
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
