"""Visualization report (SURVEY.md C22): replay + eval -> PNG overlays.

The port's copy of the JAX package's ``scripts/report.py``. Two artifacts:

- ``overlay.png`` — per-stream small multiples: metric value with injected
  fault windows shaded and alert marks, and (own axis, stacked — never a
  dual axis) the anomaly log-likelihood with the alert threshold. Data comes
  from an in-process replay of the synthetic cluster (deterministic seed),
  :func:`report_data`, on ``cuda`` unless ``--device`` says otherwise.
- ``fault_eval.png`` — per-kind recall bars + headline metrics from a
  fault-eval report JSON (``python -m rtap_tpu_torch eval --out ...``).

Usage (``python -m rtap_tpu_torch report`` takes the same flags but
``--threshold`` and ``--seed``):

    python -m rtap_tpu_torch.eval.report --out-dir torch_report \\
        [--eval-report fault_eval.json] [--streams 6] [--length 900]

The replay needs only the port; the rendering imports matplotlib (with the
``Agg`` backend) when it runs, so importing this module does not.

Design notes: colorblind-safe Okabe-Ito hues in fixed roles (value = blue,
likelihood = orange); the status color (vermillion) is reserved for alert
marks; fault windows are neutral gray bands; thin marks, recessive grid,
no top/right spines.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

# Okabe-Ito (CVD-safe): fixed roles, never cycled
C_VALUE = "#0072B2"  # blue — the metric
C_LIK = "#E69F00"  # orange — the likelihood
C_ALERT = "#D55E00"  # vermillion — STATUS: alert marks only
C_WINDOW = "#999999"  # neutral — labeled fault windows
INK = "#333333"
MUTED = "#767676"

THRESHOLD = 0.39  # the overlay's alert threshold
SEED = 11
OUT_DIR = "torch_report"  # never the JAX package's reports/


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported when a figure is
    drawn."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("the report's figures need matplotlib, which is not "
                           "installed; report_data() runs the replay without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax):
    ax.spines[["top", "right"]].set_visible(False)
    ax.spines[["left", "bottom"]].set_color(MUTED)
    ax.tick_params(colors=MUTED, labelsize=8)
    ax.grid(True, axis="y", color="#DDDDDD", linewidth=0.6, alpha=0.7)
    ax.set_axisbelow(True)


def report_data(n_streams: int = 6, length: int = 900, threshold: float = THRESHOLD,
                seed: int = SEED, device=None):
    """The overlay's data: `n_streams` synthetic cluster streams with two
    injected faults each, replayed through the window-likelihood cluster
    preset in chunks of 128 -> (streams, ReplayResult)."""
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_stream
    from rtap_tpu_torch.service.replay import replay_streams

    base = cluster_preset()
    cfg = dataclasses.replace(
        base, likelihood=dataclasses.replace(base.likelihood, mode="window")
    )
    frac = cfg.likelihood.safe_inject_frac(length)
    metrics = ("cpu", "mem", "net")
    streams = [
        generate_stream(
            f"node{i:03d}.{metrics[i % 3]}",
            SyntheticStreamConfig(
                length=length, metric=metrics[i % 3], n_anomalies=2,
                kinds=("spike", "level_shift", "dropout"), anomaly_magnitude=6.0,
                noise_phi=0.97, noise_scale=0.5, inject_after_frac=frac,
            ),
            seed=seed,
        )
        for i in range(n_streams)
    ]
    res = replay_streams(streams, cfg, device=device, threshold=threshold, chunk_ticks=128)
    return streams, res


def overlay_figure(streams, res, threshold: float, max_streams: int = 4):
    """Small multiples: per stream, value panel + log-likelihood panel."""
    plt = _pyplot()
    n = min(max_streams, len(streams))
    fig, axes = plt.subplots(
        2 * n, 1, figsize=(10, 2.2 * 2 * n), sharex=True,
        layout="constrained",
    )
    axes = np.atleast_1d(axes)
    t0 = res.timestamps[0]
    tmin = (res.timestamps - t0) / 60.0  # minutes
    for i in range(n):
        s = streams[i]
        ax_v, ax_l = axes[2 * i], axes[2 * i + 1]
        for lo, hi in s.windows:
            for ax in (ax_v, ax_l):
                ax.axvspan((lo - t0) / 60.0, (hi - t0) / 60.0,
                           color=C_WINDOW, alpha=0.25, linewidth=0)
        ax_v.plot(tmin, s.values, color=C_VALUE, linewidth=1.2)
        ax_v.set_ylabel("value", fontsize=8, color=INK)
        ax_v.set_title(f"{s.stream_id} — metric, fault windows (gray), alerts",
                       fontsize=9, color=INK, loc="left")
        alerts = res.alerts[:, i]
        if alerts.any():
            ax_v.plot(tmin[alerts], s.values[alerts], linestyle="none",
                      marker="v", markersize=5, color=C_ALERT, label="alert")
            ax_v.legend(frameon=False, fontsize=8, loc="upper right",
                        borderaxespad=0.1)
        ax_l.plot(tmin, res.log_likelihood[:, i], color=C_LIK, linewidth=1.2)
        ax_l.axhline(threshold, color=MUTED, linewidth=0.9, linestyle="--")
        ax_l.text(tmin[-1], threshold, f" thr {threshold}", fontsize=7,
                  color=MUTED, va="bottom", ha="right")
        ax_l.set_ylabel("log-lik", fontsize=8, color=INK)
        ax_l.set_ylim(-0.02, 1.02)
        _style(ax_v)
        _style(ax_l)
    axes[-1].set_xlabel("minutes", fontsize=8, color=INK)
    fig.suptitle("Synthetic cluster replay — anomaly detection overlay",
                 fontsize=11, color=INK, ha="center")
    return fig


def eval_figure(report: dict):
    """Per-kind recall bars (one measure across categories -> one hue) with
    headline metrics in the title."""
    plt = _pyplot()
    kinds = sorted(report["per_kind"])
    recalls = [report["per_kind"][k]["recall"] for k in kinds]
    b = report["at_best"]
    fig, ax = plt.subplots(figsize=(7, 0.6 * len(kinds) + 1.6))
    y = np.arange(len(kinds))
    ax.barh(y, recalls, height=0.55, color=C_VALUE, edgecolor="none")
    for i, r in enumerate(recalls):
        ax.text(min(r + 0.02, 1.02), i, f"{r:.2f}", va="center",
                fontsize=8, color=INK)
    ax.set_yticks(y, kinds, fontsize=9, color=INK)
    ax.set_xlim(0, 1.12)
    ax.set_xlabel("recall at F1-optimal threshold", fontsize=8, color=INK)
    ax.set_title(
        f"Fault-injection eval — f1 {b['f1']:.2f}, recall {b['recall']:.2f}, "
        f"episode precision {b['precision']:.2f}, "
        f"median latency {b['median_latency_s']} s",
        fontsize=9, color=INK, loc="left",
    )
    _style(ax)
    ax.grid(True, axis="x", color="#DDDDDD", linewidth=0.6, alpha=0.7)
    ax.grid(False, axis="y")
    fig.tight_layout()
    return fig


def write_report(out_dir: str, n_streams: int = 6, length: int = 900,
                 eval_report: str | None = None, threshold: float = THRESHOLD,
                 seed: int = SEED, device=None) -> list[str]:
    """Replay, render and write ``overlay.png`` (and ``fault_eval.png`` when
    `eval_report` names an existing report) into `out_dir` -> the paths."""
    plt = _pyplot()  # before the replay: a missing matplotlib fails first
    os.makedirs(out_dir, exist_ok=True)
    streams, res = report_data(n_streams, length, threshold, seed, device)
    fig = overlay_figure(streams, res, threshold)
    paths = [os.path.join(out_dir, "overlay.png")]
    fig.savefig(paths[-1], dpi=110)
    plt.close(fig)
    print(f"wrote {paths[-1]}", file=sys.stderr)

    if eval_report and os.path.exists(eval_report):
        with open(eval_report) as f:
            rep = json.load(f)
        fig = eval_figure(rep)
        paths.append(os.path.join(out_dir, "fault_eval.png"))
        fig.savefig(paths[-1], dpi=110)
        plt.close(fig)
        print(f"wrote {paths[-1]}", file=sys.stderr)
    return paths


def add_report_flags(ap: argparse.ArgumentParser) -> None:
    """The report's flags, shared with ``python -m rtap_tpu_torch report``."""
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--streams", type=int, default=6)
    ap.add_argument("--length", type=int, default=900)
    ap.add_argument("--eval-report", default=None,
                    help="path to a fault_eval JSON report to chart")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch.eval.report",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_report_flags(ap)
    ap.add_argument("--threshold", type=float, default=THRESHOLD)
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)
    write_report(args.out_dir, args.streams, args.length, args.eval_report,
                 args.threshold, args.seed, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
