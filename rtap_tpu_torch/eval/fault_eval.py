"""Fault-injection evaluation: lead time, latency, precision, recall.

The reference's experiment loop (SURVEY.md §3.5) injects a fault at t_f and
asks: did the log-likelihood alert fire inside [t_f - lead, t_f + window]?
This module is that measurement for the synthetic cluster: replay N
kind-labeled streams through the detector pipeline, threshold the
log-likelihood into alerts, match alerts to fault events, and report
per-kind and overall

- recall      — fraction of injected faults whose window contains >= 1 alert
- precision   — fraction of alerts that fall inside some labeled window
- latency     — first-alert time minus fault onset (negative = early warning
                from the pre-onset margin; the reference's "lead time" is
                window_end - first_alert, also reported)

Methodology follows NAB: the detection threshold is swept and metrics are
reported both at the F1-optimal threshold (the detector's quality) and at
the fixed service default (the deployed alerting behavior).

The port's copy of the JAX package's ``eval/fault_eval.py``: the same
streams, sweep and scoring, replayed through ``rtap_tpu_torch`` on ``cuda``
unless ``device`` / ``--device`` says otherwise. Run as a script (note the
likelihood mode — the JAX package's headline artifact is the PRODUCTION
streaming config; this module's default window mode is the NuPIC-faithful
comparison config; ``python -m rtap_tpu_torch eval`` defaults to streaming):

    python -m rtap_tpu_torch.eval.fault_eval --streams 120 --likelihood streaming \
        --out fault_eval.json
    python -m rtap_tpu_torch.eval.fault_eval --streams 120 --out fault_eval_window.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from dataclasses import asdict, dataclass, field

import numpy as np

from rtap_tpu_torch.config import ModelConfig, cluster_preset
from rtap_tpu_torch.data.synthetic import (
    ANOMALY_KINDS,
    LabeledStream,
    SyntheticStreamConfig,
    generate_stream,
)


@dataclass
class KindStats:
    events: int = 0
    detected: int = 0
    latencies: list[float] = field(default_factory=list)  # sec, detected only
    leads: list[float] = field(default_factory=list)  # window_end - first alert

    @property
    def recall(self) -> float:
        return self.detected / self.events if self.events else 0.0

    def summary(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        lead = np.asarray(self.leads, np.float64)
        return {
            "events": self.events,
            "detected": self.detected,
            "recall": round(self.recall, 4),
            "median_latency_s": float(np.median(lat)) if lat.size else None,
            "mean_latency_s": float(lat.mean()) if lat.size else None,
            "median_lead_s": float(np.median(lead)) if lead.size else None,
        }


@dataclass
class FaultEvalReport:
    n_streams: int
    n_ticks: int
    default_threshold: float
    best_threshold: float
    at_default: dict  # overall metrics at the service default threshold
    at_best: dict  # overall metrics at the F1-optimal (threshold, debounce)
    per_kind: dict[str, dict]  # per-kind stats at the best operating point
    throughput: dict
    default_debounce: int = 1
    best_debounce: int = 1
    # per-kind optimal operating points (kind f1 vs the global precision) —
    # the spread quantifies what one shared service threshold costs each kind
    kind_thresholds: dict[str, dict] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, sort_keys=True)


def _f1(precision: float, recall: float) -> float:
    return (2 * precision * recall / (precision + recall)) if (precision + recall) else 0.0


def debounce_mask(hits: np.ndarray, d: int) -> np.ndarray:
    """Apply the service's consecutive-tick debounce (StreamGroup._debounced)
    to a [T, N] hit mask: a stream alerts at t iff hits held for the last
    `d` ticks. Equivalent to the service's running counter, vectorized as an
    AND of d shifted slices (the sweep calls this ~190x per eval; a per-tick
    Python loop would add millions of interpreter iterations)."""
    if d <= 1:
        return hits
    out = hits.copy()
    for k in range(1, d):
        out[k:] &= hits[:-k]
        out[:k] = False
    return out


def _episodes(alert_ts: np.ndarray, cooldown_s: float) -> list[tuple[int, int]]:
    """Collapse alert ticks into episodes: a new episode starts when the gap
    since the previous alert exceeds `cooldown_s`. Returns (first, last)
    timestamp spans."""
    if len(alert_ts) == 0:
        return []
    splits = np.nonzero(np.diff(alert_ts) > cooldown_s)[0] + 1
    return [
        (int(seg[0]), int(seg[-1]))
        for seg in np.split(alert_ts, splits)
    ]


def match_alerts(
    streams: list[LabeledStream],
    alerts: np.ndarray,  # [T, N] bool
    timestamps: np.ndarray,  # [T] int64 (shared clock)
    cooldown_s: float = 10.0,
) -> tuple[dict[str, KindStats], dict]:
    """Match per-stream alerts to kind-labeled fault events.

    Precision is reported at two granularities:

    - tick level (`precision_ticks`): fraction of alert *ticks* inside some
      labeled window — harsh on persistent faults, where the likelihood tail
      after the window closes counts one false alert per tick;
    - episode level (`precision`, the headline): consecutive alert ticks
      (gaps <= cooldown) collapse into one alert episode, and an episode is
      true iff it intersects a labeled window. This matches the reference's
      event-granularity question (SURVEY.md §3.5: "did the alert fire in
      [t_f - lead, t_f + window]?") — an operator pages once per episode,
      not once per tick.
    """
    per_kind: dict[str, KindStats] = {k: KindStats() for k in ANOMALY_KINDS}
    total_alerts = 0
    true_alerts = 0
    total_episodes = 0
    true_episodes = 0
    for j, s in enumerate(streams):
        alert_ts = timestamps[alerts[:, j]]
        total_alerts += len(alert_ts)
        in_any = np.zeros(len(alert_ts), bool)
        for ev in s.events:
            ks = per_kind.setdefault(ev.kind, KindStats())
            ks.events += 1
            lo, hi = ev.window
            inside = (alert_ts >= lo) & (alert_ts <= hi)
            in_any |= inside
            if inside.any():
                first = int(alert_ts[inside][0])
                ks.detected += 1
                ks.latencies.append(float(first - ev.onset))
                ks.leads.append(float(hi - first))
        true_alerts += int(in_any.sum())
        eps = _episodes(alert_ts, cooldown_s)
        total_episodes += len(eps)
        true_episodes += sum(
            any(e0 <= hi and e1 >= lo for (lo, hi) in (ev.window for ev in s.events))
            for (e0, e1) in eps
        )

    all_events = sum(k.events for k in per_kind.values())
    all_detected = sum(k.detected for k in per_kind.values())
    all_lat = np.asarray(
        [x for k in per_kind.values() for x in k.latencies], np.float64
    )
    recall = all_detected / all_events if all_events else 0.0
    precision_ticks = true_alerts / total_alerts if total_alerts else 1.0
    precision = true_episodes / total_episodes if total_episodes else 1.0
    f1 = _f1(precision, recall)
    overall = {
        "events": all_events,
        "detected": all_detected,
        "recall": round(recall, 4),
        "alerts": total_alerts,
        "true_alerts": true_alerts,
        "precision_ticks": round(precision_ticks, 4),
        "episodes": total_episodes,
        "true_episodes": true_episodes,
        "precision": round(precision, 4),
        "f1": round(f1, 4),
        "median_latency_s": float(np.median(all_lat)) if all_lat.size else None,
    }
    return per_kind, overall


def score_lead_time(
    events: list[dict],
    onsets: dict[str, int],
    cascade_order: list[str],
    node_of=None,
) -> dict:
    """Score predictive-horizon events against cascade ground truth
    (``python -m rtap_tpu_torch.predict_eval`` runs it).

    ``events`` are the predictor's emitted dicts (``precursor`` /
    ``predicted_incident``, the JAX package's schemas) with ticks on the
    eval's replay clock; ``onsets`` maps node -> fault-onset tick;
    ``cascade_order`` lists the faulted nodes origin-first. A *page* is
    the first precursor on any cascade node, or the first
    predicted_incident whose blast radius touches one — a false
    precursor on a healthy service must not count as the win. The
    headline is ``lead_ticks_vs_second``: positive means the operator
    was paged BEFORE the second node fell over, i.e. while the cascade
    was still preventable — the reference's lead-time question asked of
    the prediction stream instead of the score stream."""
    if node_of is None:
        def node_of(s):
            return s.rsplit(".", 1)[0] if "." in s else s
    cascade = set(cascade_order)
    first_by_node: dict[str, int] = {}
    false_precursors = 0
    for ev in events:
        if ev.get("event") != "precursor":
            continue
        node = node_of(str(ev.get("stream")))
        t = int(ev["tick"])
        if node in cascade:
            first_by_node[node] = min(t, first_by_node.get(node, t))
        else:
            false_precursors += 1
    incident = next(
        (ev for ev in events if ev.get("event") == "predicted_incident"
         and cascade & set(ev.get("blast_radius", ()))), None)
    page_ticks = list(first_by_node.values())
    if incident is not None:
        page_ticks.append(int(incident["tick"]))
    page_tick = min(page_ticks) if page_ticks else None
    origin = cascade_order[0]
    second_onset = onsets[cascade_order[1]] if len(cascade_order) > 1 \
        else None
    radius = set(incident.get("blast_radius", ())) \
        if incident is not None else set()
    blast_covered = incident is not None and cascade <= radius
    return {
        "paged": page_tick is not None,
        "page_tick": page_tick,
        "origin_onset": int(onsets[origin]),
        "second_onset": int(second_onset) if second_onset is not None
        else None,
        "lead_ticks_vs_origin": int(onsets[origin] - page_tick)
        if page_tick is not None else None,
        "lead_ticks_vs_second": int(second_onset - page_tick)
        if page_tick is not None and second_onset is not None else None,
        "first_precursor_by_node": {
            n: int(t) for n, t in sorted(first_by_node.items())},
        "false_precursors": false_precursors,
        "predicted_incident": None if incident is None else {
            "incident_id": incident.get("alert_id"),
            "tick": int(incident["tick"]),
            "first_node": incident.get("first_node"),
            "blast_radius": sorted(radius),
        },
        "blast_covered": blast_covered,
        "win": bool(page_tick is not None and second_onset is not None
                    and page_tick < second_onset and blast_covered),
    }


def fault_streams(n_streams: int, length: int, kinds: tuple[str, ...], magnitude: float,
                  cfg: ModelConfig, seed: int, family: str) -> list[LabeledStream]:
    """The eval's kind-labelled streams: ids ``node<i>.<metric>`` over five
    metrics, two injections each, placed past `cfg`'s likelihood probation."""
    metrics = ("cpu", "mem", "net", "disk_io", "latency_ms")
    # injections land after probation + settling margin (raises when the
    # streams are too short to evaluate honestly — see safe_inject_frac)
    frac = cfg.likelihood.safe_inject_frac(length)
    scfg = SyntheticStreamConfig(
        length=length, cadence_s=1.0, n_anomalies=2, kinds=kinds,
        anomaly_magnitude=magnitude, noise_phi=0.97, noise_scale=0.5,
        inject_after_frac=frac, family=family,
    )
    return [
        generate_stream(
            f"node{i:05d}.{metrics[i % len(metrics)]}",
            dataclasses.replace(scfg, metric=metrics[i % len(metrics)]),
            seed=seed,
        )
        for i in range(n_streams)
    ]


def run_fault_eval(
    n_streams: int = 120,
    length: int = 1500,
    kinds: tuple[str, ...] = ("spike", "level_shift", "dropout"),
    magnitude: float = 6.0,
    cfg: ModelConfig | None = None,
    device=None,
    default_threshold: float = 0.5,
    seed: int = 11,
    chunk_ticks: int = 256,
    default_debounce: int = 2,
    family: str = "diurnal",
) -> FaultEvalReport:
    """Generate a kind-labeled cluster, replay it, sweep the detection
    threshold (NAB methodology), and score the alerts.

    Defaults to the detectable point-anomaly kinds; pass
    ``kinds=ANOMALY_KINDS`` to include the hard gradual classes (drift,
    stuck) whose recall is reported per kind. The synthetic noise is AR(1)
    (real node metrics move smoothly tick to tick; white noise at 1s cadence
    would bury any detector of this family in per-tick bucket jitter).
    Replays on `device` (``cuda`` unless given).
    """
    from rtap_tpu_torch.service.replay import replay_streams

    if cfg is None:
        base = cluster_preset()
        # quality runs use the faithful NuPIC window-mode likelihood
        cfg = dataclasses.replace(
            base, likelihood=dataclasses.replace(base.likelihood, mode="window")
        )
    streams = fault_streams(n_streams, length, kinds, magnitude, cfg, seed, family)
    res = replay_streams(streams, cfg, device=device, chunk_ticks=chunk_ticks,
                         threshold=default_threshold)

    # NAB-style sweep, jointly over threshold x debounce. The threshold grid
    # spans the full useful log-likelihood range (probation emits ~0.03;
    # 0.97 is the top of the log scale) — a narrow grid can miss the optimum
    # NAB's sweeper would find. Debounce (alert
    # only after d consecutive hit ticks — the service's StreamGroup
    # semantics) attacks episode precision: false episodes are dominated by
    # 1-2-tick likelihood flickers while injected faults persist. The
    # service operating point is always included so at_best can never be
    # worse than at_default.
    grid = np.union1d(np.arange(0.05, 0.96, 0.02), [default_threshold])
    debounces = sorted({1, 2, 3, 4, default_debounce})
    best = (None, -1.0, None, None, None)  # (thr, f1, per_kind, overall, d)
    # per-kind threshold study: for each fault kind, the
    # (threshold, debounce) maximizing the kind's f1 (kind recall against the
    # GLOBAL episode precision — false episodes carry no kind label). A
    # spread of per-kind optima quantifies what a single service threshold
    # costs each kind; the study is analysis-only (runtime can't know kinds).
    kind_best: dict[str, dict] = {}
    for d in debounces:
        for thr in grid:
            al = debounce_mask(res.log_likelihood >= thr, d)
            pk, ov = match_alerts(streams, al, res.timestamps)
            if ov["f1"] > best[1]:
                best = (float(thr), ov["f1"], pk, ov, d)
            for kind, ks in pk.items():
                if not ks.events:
                    continue
                p = ov["precision"]
                kf1 = _f1(p, ks.recall)
                cur = kind_best.get(kind)
                if cur is None or kf1 > cur["f1"]:
                    kind_best[kind] = {
                        "threshold": round(float(thr), 3), "debounce": d,
                        "f1": round(kf1, 4), "recall": round(ks.recall, 4),
                        "precision_global": round(p, 4),
                    }
    _, _, best_pk, best_overall, best_d = best
    _, default_overall = match_alerts(
        streams,
        debounce_mask(res.log_likelihood >= default_threshold, default_debounce),
        res.timestamps,
    )
    return FaultEvalReport(
        n_streams=n_streams,
        n_ticks=length,
        default_threshold=default_threshold,
        best_threshold=best[0],
        at_default=default_overall,
        at_best=best_overall,
        per_kind={k: v.summary() for k, v in best_pk.items() if v.events},
        throughput=res.throughput,
        default_debounce=default_debounce,
        best_debounce=best_d,
        kind_thresholds=kind_best,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rtap_tpu_torch.eval.fault_eval",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=120)
    ap.add_argument("--length", type=int, default=1500)
    ap.add_argument("--magnitude", type=float, default=6.0)
    ap.add_argument("--family", choices=("diurnal", "heldout"),
                    default="diurnal",
                    help="signal family: 'heldout' is the external-"
                         "validation world (heavy-tailed bursty noise, "
                         "trend, unlabeled regime switches) no config was "
                         "tuned on")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--all-kinds", action="store_true",
                    help="include the hard gradual kinds (drift, stuck)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--debounce", type=int, default=2,
                    help="service debounce (consecutive hit ticks) for the "
                         "at_default operating point")
    ap.add_argument("--perm-bits", type=int, default=None, choices=(0, 8, 16),
                    help="override the cluster preset's permanence domain "
                         "(compression quality comparison, models/perm.py)")
    ap.add_argument("--likelihood", choices=("window", "streaming"), default="window",
                    help="likelihood mode for the evaluated config: 'window' "
                         "= the faithful NuPIC rolling window (the default "
                         "quality-comparison config), 'streaming' = the "
                         "preset's at-scale EMA mode — measured BETTER on "
                         "episode precision (reports/quality_study.json)")
    ap.add_argument("--learning-period", type=int, default=None,
                    help="override likelihood probation length (the measured "
                         "precision lever: false episodes cluster in the "
                         "post-probation maturity window)")
    ap.add_argument("--learn-every", type=int, default=1,
                    help="learning cadence (ModelConfig.learn_every): learn "
                         "on every k-th tick after --learn-full-until. The "
                         "throughput lever (learning is most of the step); "
                         "this flag measures its detection-quality price")
    ap.add_argument("--learn-full-until", type=int, default=None,
                    help="ticks of full-rate learning before the cadence "
                         "kicks in (default: the likelihood "
                         "learning_period, the Gaussian-fit window)")
    ap.add_argument("--learn-burst", type=int, default=1,
                    help="burst shape of the thinned cadence: learn B "
                         "CONSECUTIVE ticks of every k*B (same average "
                         "cost as --learn-every alone; preserves the "
                         "temporal adjacency TM sequence learning needs)")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    return ap


def eval_config(perm_bits: int | None = None, likelihood: str = "window",
                learning_period: int | None = None, learn_every: int = 1,
                learn_full_until: int | None = None, learn_burst: int = 1) -> ModelConfig:
    """The evaluated config from the script's flags: the cluster preset in
    the given likelihood mode, probation and learning cadence."""
    base = cluster_preset(**({"perm_bits": perm_bits} if perm_bits is not None else {}))
    cfg = dataclasses.replace(base, likelihood=dataclasses.replace(
        base.likelihood, mode=likelihood))
    if learning_period is not None:
        # shared helper: keeps the cadence's full-rate window aligned and
        # enforces the replace-before-with_learn_every ordering
        cfg = cfg.with_learning_period(learning_period)
    if learn_every != 1 or learn_full_until is not None or learn_burst != 1:
        # shared policy with the operator CLI (ModelConfig.with_learn_every):
        # invalid k fails loudly; default full-rate window = learning_period
        cfg = cfg.with_learn_every(learn_every, learn_full_until, burst=learn_burst)
    return cfg


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = eval_config(args.perm_bits, args.likelihood, args.learning_period,
                      args.learn_every, args.learn_full_until, args.learn_burst)
    kinds = ANOMALY_KINDS if args.all_kinds else ("spike", "level_shift", "dropout")
    report = run_fault_eval(
        n_streams=args.streams, length=args.length, kinds=kinds,
        magnitude=args.magnitude, cfg=cfg, device=args.device,
        default_threshold=args.threshold, default_debounce=args.debounce,
        seed=args.seed, family=args.family,
    )
    print(report.to_json())
    if args.out:
        with open(args.out, "w") as f:
            f.write(report.to_json())
        print(f"report written to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
