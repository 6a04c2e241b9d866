"""Held-out external validation of the model-width quality claims.

The port's copy of the JAX package's ``scripts/heldout_eval.py``. The
width ladder's quality figures were measured inside the world the configs
were tuned in: one generator family (diurnal sine + AR(1)), seed 11,
magnitude 6-sigma, 3 detectable kinds. This study evaluates the ladder on
the HELD-OUT family (data/synthetic.py ``family="heldout"``: Student-t
bursty noise, per-stream trend, unlabeled benign regime switches) across
multiple seeds, a 2-6-sigma magnitude sweep, and ALL FIVE fault kinds —
a world no config was tuned on.

Protocol per cell: run_fault_eval's 120 x 1500 sweep (threshold x
debounce, episode precision), production streaming likelihood. Aggregation:
mean best-f1 over seeds per (variant, magnitude), then the verdict table
preset-vs-32col. With ``--out`` every finished cell is merged into that
file at once, and a re-run measures only the cells it lacks:

    python -m rtap_tpu_torch.eval.heldout_eval --streams 40 --seeds 11 \\
        --magnitudes 6 --variants preset_256col --out heldout.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

VARIANTS = {
    "preset_256col": (256, 1),
    "preset_256col_k2": (256, 2),
    "half_128col": (128, 1),
    "quarter_64col": (64, 1),
    "eighth_32col": (32, 1),
    "eighth_32col_k2": (32, 2),  # the throughput-headline config
    "eighth_32col_k4": (32, 4),  # the 100k-live cadence candidate
    "eighth_32col_k3": (32, 3),  # the better-quality 100k operating point
}


def _cfg(columns: int, learn_every: int):
    from rtap_tpu_torch.config import cluster_preset, scaled_cluster_preset

    cfg = cluster_preset() if columns == 256 else scaled_cluster_preset(columns)
    if learn_every > 1:
        cfg = cfg.with_learn_every(learn_every)
    return cfg


def log(msg: str) -> None:
    print(f"[heldout] {msg}", file=sys.stderr, flush=True)


def run_cell(name: str, magnitude: float, seed: int, streams: int = 120,
             length: int = 1500, device=None) -> dict:
    """One (variant, magnitude, seed) cell of the study -> its summary."""
    from rtap_tpu_torch.data.synthetic import ANOMALY_KINDS
    from rtap_tpu_torch.eval.fault_eval import run_fault_eval

    cols, k = VARIANTS[name]
    rep = run_fault_eval(
        n_streams=streams, length=length, kinds=ANOMALY_KINDS, magnitude=magnitude,
        cfg=_cfg(cols, k), device=device, seed=seed, family="heldout",
    )
    return cell_summary(dataclasses.asdict(rep))


def cell_summary(d: dict) -> dict:
    """A cell's entry from its fault-eval report (as a dict)."""
    return {
        "f1": d["at_best"]["f1"],
        "recall": d["at_best"]["recall"],
        "precision": d["at_best"]["precision"],
        "best_threshold": d["best_threshold"],
        "best_debounce": d["best_debounce"],
        "per_kind_recall": {kk: v["recall"] for kk, v in d["per_kind"].items()},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch.eval.heldout_eval",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=120)
    ap.add_argument("--length", type=int, default=1500)
    ap.add_argument("--seeds", default="11,23,47")
    ap.add_argument("--magnitudes", default="2,4,6")
    ap.add_argument("--variants", default=None,
                    help=f"subset of {sorted(VARIANTS)} (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--out", default=None,
                    help="merge each finished cell into this JSON file")
    args = ap.parse_args(argv)

    seeds = [int(x) for x in args.seeds.split(",")]
    mags = [float(x) for x in args.magnitudes.split(",")]
    picked = args.variants.split(",") if args.variants else list(VARIANTS)
    bad = set(picked) - set(VARIANTS)
    if bad:
        raise SystemExit(f"unknown variants {sorted(bad)}; have {sorted(VARIANTS)}")

    cells: dict[str, dict] = {}
    if args.out and os.path.exists(args.out):  # merge: a re-run measures only what's missing
        with open(args.out) as f:
            cells = json.load(f).get("cells", {})

    t_start = time.time()
    for name in picked:
        for mag in mags:
            for seed in seeds:
                key = f"{name}|mag{mag:g}|seed{seed}"
                if key in cells:
                    continue
                t0 = time.time()
                cells[key] = run_cell(name, mag, seed, args.streams, args.length, args.device)
                log(f"{key}: f1={cells[key]['f1']:.3f} "
                    f"({time.time() - t0:.0f}s)")
                _write(args, cells, t_start)  # incremental: survive kills
    _write(args, cells, t_start, final=True)
    return 0


def _summarize(cells: dict) -> dict:
    """Aggregate mean f1 over seeds per (variant, magnitude) + the verdict."""
    agg: dict[str, dict[str, list[float]]] = {}
    for key, cell in cells.items():
        name, mag, _ = key.split("|")
        agg.setdefault(name, {}).setdefault(mag, []).append(cell["f1"])
    table = {
        name: {mag: round(sum(v) / len(v), 4) for mag, v in mags.items()}
        for name, mags in agg.items()
    }
    means = {
        name: round(sum(sum(v) / len(v) for v in mags.values()) / len(mags), 4)
        for name, mags in agg.items()
    }
    verdict = None
    if "preset_256col" in means and "eighth_32col" in means:
        verdict = {
            "preset_mean_f1": means["preset_256col"],
            "col32_mean_f1": means["eighth_32col"],
            "col32_holds": means["eighth_32col"] >= means["preset_256col"] - 0.01,
        }
    return {"mean_f1_by_magnitude": table, "mean_f1": means, "verdict": verdict}


def _write(args, cells: dict, t_start: float, final: bool = False) -> None:
    out = {
        "protocol": (f"{args.streams} x {args.length}, family=heldout, all 5 "
                     f"kinds, seeds={args.seeds}, magnitudes={args.magnitudes}, "
                     "streaming likelihood, threshold x debounce sweep"),
        "device": args.device or "cuda",
        "cells": cells,
        **_summarize(cells),
        "wall_s": round(time.time() - t_start, 1),
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f, indent=2)
        os.replace(tmp, args.out)
    if final:
        print(json.dumps({"mean_f1": out["mean_f1"], "verdict": out["verdict"]}))


if __name__ == "__main__":
    sys.exit(main())
