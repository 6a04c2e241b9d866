"""NAB-style evaluation of the workload modalities beyond scalar metrics.

The scalar path is quality-gated by eval/fault_eval.py; this module asks
the same question of the NEW encoder families so they ship measured, not
assumed:

- **categorical** — event-class streams (skewed steady distribution,
  anomalies = bursts of a NOVEL class) scored through the categorical
  encoder preset. A scalar RDSE sees a novel id as "one bucket further"
  (overlap decays linearly); the categorical encoder sees a disjoint
  representation — the modality this family exists for.
- **log_template** — seeded log-line streams through the drain-style
  template miner (ingest/templates.py) into template-id
  streams, scored the same way: the log-burst workload.
- **composite_vs_scalar** — the regression gate: the composite
  multi-field preset ({value, delta, event-class} + hour-of-day) scored
  on SCALAR faults must reach an F1 no worse than the scalar-only
  baseline on the same faults (threshold/debounce swept per config, NAB
  methodology) — fusing extra fields must not cost the scalar component
  its detection quality.

Scoring reuses fault_eval's machinery verbatim (debounce_mask,
match_alerts, threshold x debounce sweep), so "F1" means the same thing
in every committed artifact. The port's copy of the JAX package's
``eval/workload_eval.py`` (whose artifact is ``reports/workloads_r09.json``),
replayed through ``rtap_tpu_torch`` on ``cuda`` unless ``--device`` says
otherwise; the port has no CPU oracle, ``--device cpu`` runs its plain
PyTorch path:

    python -m rtap_tpu_torch.eval.workload_eval --out workloads.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from rtap_tpu_torch.config import (
    CompositeEncoderConfig,
    FieldSpec,
    ModelConfig,
    categorical_preset,
    cluster_preset,
    composite_preset,
)
from rtap_tpu_torch.data.synthetic import (
    LabeledStream,
    SyntheticStreamConfig,
    generate_categorical_stream,
    generate_log_stream,
    generate_stream,
)
from rtap_tpu_torch.eval.fault_eval import debounce_mask, match_alerts


def _sweep(streams, loglik: np.ndarray, timestamps: np.ndarray,
           default_threshold: float = 0.5,
           default_debounce: int = 2) -> dict:
    """fault_eval's NAB sweep, compacted: joint threshold x debounce grid,
    reporting the F1-optimal and service-default operating points."""
    grid = np.union1d(np.arange(0.05, 0.96, 0.02), [default_threshold])
    best = {"f1": -1.0}
    for d in sorted({1, 2, 3, default_debounce}):
        for thr in grid:
            al = debounce_mask(loglik >= thr, d)
            _pk, ov = match_alerts(streams, al, timestamps)
            if ov["f1"] > best["f1"]:
                best = {"threshold": round(float(thr), 3), "debounce": d,
                        **ov}
    _pk, default_ov = match_alerts(
        streams,
        debounce_mask(loglik >= default_threshold, default_debounce),
        timestamps)
    return {"at_best": best,
            "at_default": {"threshold": default_threshold,
                           "debounce": default_debounce, **default_ov}}


def _short_probation(cfg: ModelConfig, learning_period: int,
                     estimation: int = 60) -> ModelConfig:
    return dataclasses.replace(cfg, likelihood=dataclasses.replace(
        cfg.likelihood, learning_period=learning_period,
        estimation_samples=estimation))


def run_categorical_eval(n_streams: int = 12, length: int = 900,
                         cfg: ModelConfig | None = None,
                         device=None, seed: int = 11,
                         chunk_ticks: int = 128) -> dict:
    """Categorical modality: novel-class bursts vs the categorical preset."""
    from rtap_tpu_torch.service.replay import replay_streams

    cfg = cfg or _short_probation(categorical_preset(), 300, 100)
    frac = cfg.likelihood.safe_inject_frac(length)
    scfg = SyntheticStreamConfig(length=length, cadence_s=1.0,
                                 n_anomalies=2, inject_after_frac=frac)
    streams = [
        generate_categorical_stream(f"ev{i:04d}.class", scfg, seed=seed)
        for i in range(n_streams)
    ]
    res = replay_streams(streams, cfg, device=device,
                         chunk_ticks=chunk_ticks)
    return {"modality": "categorical", "n_streams": n_streams,
            "n_ticks": length,
            **_sweep(streams, res.log_likelihood, res.timestamps),
            "throughput": res.throughput}


def run_log_template_eval(n_streams: int = 12, length: int = 900,
                          cfg: ModelConfig | None = None,
                          device=None, seed: int = 11,
                          chunk_ticks: int = 128) -> dict:
    """Log-template modality: seeded line streams -> drain miner ->
    template-id streams -> the categorical preset. One miner PER STREAM
    (each node's log vocabulary is its own), mirroring the serve-side
    ingest-boundary deployment."""
    from rtap_tpu_torch.ingest.templates import TemplateMiner
    from rtap_tpu_torch.service.replay import replay_streams

    cfg = cfg or _short_probation(categorical_preset(), 300, 100)
    frac = cfg.likelihood.safe_inject_frac(length)
    scfg = SyntheticStreamConfig(length=length, cadence_s=1.0,
                                 n_anomalies=2, inject_after_frac=frac)
    miners = []
    streams = []
    for i in range(n_streams):
        log = generate_log_stream(f"node{i:04d}.log", scfg, seed=seed)
        miner = TemplateMiner()
        vals = np.asarray(miner.encode_values(log.lines), np.float32)
        miners.append(miner)
        streams.append(LabeledStream(log.stream_id, log.timestamps, vals,
                                     log.windows, log.events))
    res = replay_streams(streams, cfg, device=device,
                         chunk_ticks=chunk_ticks)
    return {"modality": "log_template", "n_streams": n_streams,
            "n_ticks": length,
            "miner": {
                "templates_max": max(m.n_templates() for m in miners),
                "overflow": sum(m.overflow for m in miners),
            },
            **_sweep(streams, res.log_likelihood, res.timestamps),
            "throughput": res.throughput}


def run_composite_vs_scalar(n_streams: int = 8, length: int = 900,
                            device=None, seed: int = 11,
                            chunk_ticks: int = 128,
                            scalar_cfg: ModelConfig | None = None,
                            composite_cfg: ModelConfig | None = None) -> dict:
    """The regression gate: identical scalar faults scored by (a) the
    scalar-only cluster family and (b) the composite preset with the
    value routed to its value+delta fields and a quiet event-class
    column — composite F1 on the scalar component must be no worse.

    Wire convention for delta fields (docs/WORKLOADS.md): the field
    carries the SAME wire value as its source field; the encoder
    differentiates internally against its per-stream ``enc_prev`` state.
    """
    from rtap_tpu_torch.service.replay import replay_streams

    scalar_cfg = scalar_cfg or _short_probation(cluster_preset(), 300, 100)
    composite_cfg = composite_cfg or _short_probation(
        composite_preset(), 300, 100)
    frac = max(scalar_cfg.likelihood.safe_inject_frac(length),
               composite_cfg.likelihood.safe_inject_frac(length))
    scfg = SyntheticStreamConfig(
        length=length, cadence_s=1.0, n_anomalies=2,
        kinds=("spike", "level_shift", "dropout"),
        anomaly_magnitude=6.0, noise_phi=0.97, noise_scale=0.5,
        inject_after_frac=frac)
    scalar_streams = [
        generate_stream(f"node{i:04d}.cpu", scfg, seed=seed)
        for i in range(n_streams)
    ]
    res_scalar = replay_streams(scalar_streams, scalar_cfg, device=device,
                                chunk_ticks=chunk_ticks)
    scalar = _sweep(scalar_streams, res_scalar.log_likelihood,
                    res_scalar.timestamps)

    # the composite run scores the SAME faults: value + delta fields both
    # carry the scalar wire value; the event-class column is quiet
    # (steady class 0 with a rare benign class 1 — a status field's
    # realistic shape, and a precision hazard the gate must absorb)
    rng = np.random.default_rng(seed)
    comp_streams = []
    for s in scalar_streams:
        ev = (rng.random(length) < 0.02).astype(np.float32)
        comp_streams.append(LabeledStream(
            s.stream_id, s.timestamps,
            np.stack([s.values, s.values, ev], axis=1),
            s.windows, s.events))
    res_comp = replay_streams(comp_streams, composite_cfg, device=device,
                              chunk_ticks=chunk_ticks)
    comp = _sweep(comp_streams, res_comp.log_likelihood, res_comp.timestamps)
    gate = comp["at_best"]["f1"] >= scalar["at_best"]["f1"] - 1e-9
    return {"modality": "composite_vs_scalar", "n_streams": n_streams,
            "n_ticks": length,
            "scalar": scalar, "composite": comp,
            "scalar_f1": scalar["at_best"]["f1"],
            "composite_f1": comp["at_best"]["f1"],
            "gate_composite_no_worse": bool(gate)}


def tiny_eval_configs() -> tuple[ModelConfig, ModelConfig, ModelConfig]:
    """Miniature (categorical, scalar, composite) configs for the tier-1
    tests: same families, 32-column widths, short probation — seconds,
    not minutes, on the 1-core CI host."""
    from rtap_tpu_torch.config import scaled_cluster_preset

    tiny = _short_probation(scaled_cluster_preset(32), 40, 20)
    cat = dataclasses.replace(
        tiny, composite=CompositeEncoderConfig(fields=(
            FieldSpec(name="event_class", kind="categorical", size=64,
                      active_bits=7),)))
    comp = dataclasses.replace(
        tiny, n_fields=3,
        composite=CompositeEncoderConfig(fields=(
            FieldSpec(name="value", kind="rdse", size=64, active_bits=7,
                      resolution=0.5),
            FieldSpec(name="delta", kind="delta", size=64, active_bits=7,
                      resolution=0.5),
            FieldSpec(name="event_class", kind="categorical", size=64,
                      active_bits=7),
        )))
    return cat, tiny, comp


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch.eval.workload_eval",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=12)
    ap.add_argument("--length", type=int, default=900)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--out", default=None, help="report JSON path")
    args = ap.parse_args(argv)

    report = {
        "round": "r09",
        "seed": args.seed,
        "device": args.device or "cuda",
        "categorical": run_categorical_eval(
            n_streams=args.streams, length=args.length,
            device=args.device, seed=args.seed),
        "log_template": run_log_template_eval(
            n_streams=args.streams, length=args.length,
            device=args.device, seed=args.seed),
        "composite_vs_scalar": run_composite_vs_scalar(
            n_streams=max(4, args.streams * 2 // 3), length=args.length,
            device=args.device, seed=args.seed),
    }
    ok = report["composite_vs_scalar"]["gate_composite_no_worse"]
    report["verified"] = bool(ok)
    print(json.dumps(report))
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report written to {args.out}", file=sys.stderr)
    if not ok:
        print("FAIL: composite F1 below the scalar-only baseline on the "
              "scalar component", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
