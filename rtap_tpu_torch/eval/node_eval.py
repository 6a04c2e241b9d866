"""Multivariate node-model evaluation (benchmark config 4).

The port's copy of the JAX package's ``scripts/node_eval.py`` (SURVEY.md
§6: 'multivariate per-node cpu/mem/net fused RDSE'): N nodes, each a fused
3-field model, node-level faults either coupled (all metrics degrade
together) or single-metric. Reports per-shape detection rate at a fixed
alert threshold plus the response distribution — the documented trade-off
(coupled faults alert; single-field responses dilute ~1/F). All nodes run
through ONE stream group of ``node_preset(3)`` on ``cuda`` unless
``--device`` says otherwise:

    python -m rtap_tpu_torch.eval.node_eval --nodes 12 --out node_eval.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from rtap_tpu_torch.config import ModelConfig, node_preset
from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_node

CHUNK_TICKS = 128


def run_node_eval(nodes: int = 12, length: int = 1400, magnitude: float = 6.0,
                  threshold: float = 0.15, latency_ticks: int = 15, device=None,
                  cfg: ModelConfig | None = None) -> dict:
    """Generate `nodes` fused node streams, replay them through one group
    (values [T, G, 3] in chunks of 128) and score each fault's strongest
    log-likelihood response inside its window (plus `latency_ticks` of
    cadence) against `threshold`, by shape -> the report dict, with the
    group's raw scores and log-likelihood [T, G] under ``"raw"`` and
    ``"loglik"`` (not JSON)."""
    from rtap_tpu_torch.service.registry import StreamGroup

    cfg = cfg or node_preset(3)
    scfg = SyntheticStreamConfig(
        length=length, cadence_s=1.0, n_anomalies=3,
        kinds=("spike", "level_shift", "dropout"), anomaly_magnitude=magnitude,
        noise_phi=0.97, noise_scale=0.5, inject_after_frac=0.5,
    )
    node_streams = [generate_node(f"node{i:05d}", scfg, seed=100 + i) for i in range(nodes)]

    # all nodes through ONE group: values [T, G, 3]
    G, T = len(node_streams), length
    vals = np.stack([n.values for n in node_streams], axis=1)  # [T, G, 3]
    ts = np.stack([n.timestamps for n in node_streams], axis=1).astype(np.int64)
    grp = StreamGroup(cfg, [n.node_id for n in node_streams], device=device)
    t0 = time.time()
    raw = np.empty((T, G), np.float32)
    loglik = np.empty((T, G))
    for lo in range(0, T, CHUNK_TICKS):
        hi = min(lo + CHUNK_TICKS, T)
        raw[lo:hi], loglik[lo:hi], _ = grp.run_chunk(vals[lo:hi], ts[lo:hi])
    wall = time.time() - t0

    shapes = {"coupled": {"events": 0, "detected": 0, "responses": []},
              "single": {"events": 0, "detected": 0, "responses": []}}
    for g, node in enumerate(node_streams):
        for (a, b), touched in zip(node.windows, node.event_metrics):
            kind = "coupled" if len(touched) == len(node.metrics) else "single"
            # window bounds are unix seconds: convert the tick allowance via
            # the stream cadence (a non-1s cadence would silently
            # shrink/shift the detection window otherwise)
            w = (node.timestamps >= a) & (
                node.timestamps <= b + latency_ticks * scfg.cadence_s
            )
            resp = float(loglik[w, g].max())
            shapes[kind]["events"] += 1
            shapes[kind]["responses"].append(round(resp, 3))
            shapes[kind]["detected"] += int(resp >= threshold)

    for v in shapes.values():
        v["recall_at_threshold"] = round(v["detected"] / v["events"], 3) if v["events"] else None
        v["median_response"] = round(float(np.median(v["responses"])), 3) if v["responses"] else None

    return {
        "config": "node_preset(3) — fused cpu/mem/net per node (benchmark config 4)",
        "nodes": nodes, "length": length, "magnitude": magnitude,
        "threshold": threshold, "latency_ticks": latency_ticks,
        "device": str(grp.device),
        "wall_s": round(wall, 1),
        "shapes": {k: {kk: vv for kk, vv in v.items() if kk != "responses"}
                   for k, v in shapes.items()},
        "note": ("Coupled node faults perturb all F fields and alert strongly; "
                 "single-field faults show the ~1/F-diluted response (full "
                 "per-metric sensitivity = per-metric streams, generate_cluster)."),
        "raw": raw,
        "loglik": loglik,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch.eval.node_eval",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=12)
    ap.add_argument("--length", type=int, default=1400)
    ap.add_argument("--magnitude", type=float, default=6.0)
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="alert threshold on log-likelihood (the fault "
                         "eval's F1-optimal range starts ~0.2; fused "
                         "single-field responses sit slightly below)")
    ap.add_argument("--latency-ticks", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    args = ap.parse_args(argv)

    report = run_node_eval(args.nodes, args.length, args.magnitude, args.threshold,
                           args.latency_ticks, args.device)
    del report["raw"], report["loglik"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report["shapes"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
