"""rtap_tpu_torch command line: ``python -m rtap_tpu_torch replay ...``.

    replay   synthetic cluster replay through stream groups at full speed,
             on cuda unless --device cpu; prints one JSON line of stats.

The flags mirror the JAX package's ``replay`` subcommand where they apply.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_replay(args: argparse.Namespace) -> int:
    from rtap_tpu_torch.config import cluster_preset, scaled_cluster_preset
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.service.replay import replay_streams

    min_len = 80  # the generator needs room for post-probation injections
    if args.length < min_len:
        print(f"replay: --length must be >= {min_len} (fault injections land "
              "past the probation region)", file=sys.stderr)
        return 2
    cfg = cluster_preset() if args.columns is None else scaled_cluster_preset(args.columns)
    cfg = cfg.with_learn_every(args.learn_every, burst=args.learn_burst)
    streams = cluster_streams(3 * args.nodes, args.length, args.seed,
                              anomaly_magnitude=args.magnitude)
    res = replay_streams(streams, cfg, device=args.device, group_size=args.group_size,
                         chunk_ticks=args.chunk_ticks, threshold=args.threshold,
                         debounce=args.debounce, learn=not args.freeze)
    print(json.dumps({"streams": len(res.stream_ids), "ticks": len(res.timestamps),
                      "device": args.device or "cuda", **res.throughput}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("replay", help="synthetic cluster replay at full speed")
    p.add_argument("--nodes", type=int, default=32, help="nodes x 3 metrics = streams")
    p.add_argument("--length", type=int, default=1500)
    p.add_argument("--magnitude", type=float, default=6.0)
    p.add_argument("--group-size", type=int, default=None)
    p.add_argument("--chunk-ticks", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debounce", type=int, default=2,
                   help="alert only after this many consecutive ticks at/above threshold")
    p.add_argument("--learn-every", type=int, default=1,
                   help="learning cadence: learn every k-th tick once the "
                        "likelihood learning_period has passed (k=1 = full rate)")
    p.add_argument("--learn-burst", type=int, default=1,
                   help="burst shape of the thinned cadence: B consecutive "
                        "learn ticks per k*B cycle")
    p.add_argument("--freeze", action="store_true",
                   help="inference-only replay: no SP/TM updates; likelihood still adapts")
    p.add_argument("--columns", type=int, default=None,
                   help="width-scale the cluster preset")
    p.set_defaults(fn=_cmd_replay)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
