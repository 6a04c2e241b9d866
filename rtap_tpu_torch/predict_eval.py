"""Predictive-horizon cascade eval: page BEFORE the second node falls over.

    python -m rtap_tpu_torch.predict_eval [--device cuda|cpu] [--ticks 400]
        [--seed 0] [--horizon 8] [--threshold 0.35] [--min-ticks 12]
        [--out report.json] [--workdir W [--cadence S]]

The port of the JAX package's ``scripts/predict_eval.py``, at its defaults.
A seeded two-service cluster (3 nodes each, cpu + mem: 12 streams) takes
ONE cascading fault whose origin node first drifts slowly (a linear ramp
over ``--precursor-ticks`` ticks before its step fault), the downstream
nodes stepping ``--cascade-lag`` ticks apart
(data/synthetic.generate_topology_workload). The predict stack runs
through ``live_loop``: the groups carry the predictive-horizon reducer
(``predict=k``), a PredictTracker turns sustained divergence into
``precursor`` events, and a BlastFuser over the declared topology folds
them into one ``predicted_incident`` at the first node with the predicted
blast radius.

The run exits 5 unless eval/fault_eval.score_lead_time says ``win`` (the
first page lands before the second node's onset), ``blast_covered`` (the
predicted radius covers every faulted node) and 0 false precursors on the
healthy service. It prints the result as one JSON line.

``--workdir W`` runs the same scenario as a restartable serve: alerts in
``W/alerts.jsonl`` (the predictor's events and the topology correlator's
``incident`` lines go there), checkpoints in ``W/ck`` every
:data:`CHECKPOINT_EVERY` ticks, the write-ahead journal in ``W/journal``,
and the feed keyed by the global tick. A rerun after a kill resumes from
the checkpoints and replays the journal; the score is then read from the
alert file, which holds every event exactly once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

VERIFY_FAILED_EXIT = 5

#: short probation so a few-hundred-tick run has a mature window long
#: before the ramp begins (the JAX eval's values)
EVAL_LEARNING_PERIOD = 60
EVAL_ESTIMATION = 30

#: the checkpoint cadence of ``--workdir`` runs, in ticks
CHECKPOINT_EVERY = 16


def _events_on_disk(path: str) -> list[dict]:
    from rtap_tpu_torch.service.alerts import iter_alert_records

    return [d for kind, d in iter_alert_records(path)
            if kind == "event" and d.get("event") in ("precursor", "predicted_incident")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--nodes-per-service", type=int, default=3)
    ap.add_argument("--burst-at-frac", type=float, default=0.75)
    ap.add_argument("--cascade-lag", type=int, default=8)
    ap.add_argument("--burst-dur", type=int, default=12)
    ap.add_argument("--precursor-ramp", type=float, default=8.0,
                    help="origin-node drift magnitude in noise sigmas at the tick "
                         "before its step fault")
    ap.add_argument("--precursor-ticks", type=int, default=80,
                    help="length of the origin node's pre-fault drift")
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.35)
    ap.add_argument("--min-ticks", type=int, default=12)
    ap.add_argument("--out", default=None, help="also write the result here")
    ap.add_argument("--workdir", default=None,
                    help="run as a restartable serve with alerts, checkpoints and "
                         "the journal under this directory")
    ap.add_argument("--cadence", type=float, default=0.0)
    args = ap.parse_args(argv)

    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.correlate import IncidentCorrelator, TopologyMap
    from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, generate_topology_workload
    from rtap_tpu_torch.eval.fault_eval import score_lead_time
    from rtap_tpu_torch.predict import BlastFuser, PredictTracker
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    scfg = SyntheticStreamConfig(length=args.ticks, n_anomalies=0, noise_phi=0.9,
                                 noise_scale=0.3)
    wl = generate_topology_workload(
        n_services=args.services, nodes_per_service=args.nodes_per_service, cfg=scfg,
        seed=args.seed, burst_at_frac=args.burst_at_frac, cascade_lag=args.cascade_lag,
        burst_dur=args.burst_dur, precursor_ramp=args.precursor_ramp,
        precursor_ticks=args.precursor_ticks)
    print(f"[predict] cascade: origin {wl.precursor_node} ramps from tick "
          f"{wl.precursor_start}; onsets {wl.burst_onsets}", file=sys.stderr, flush=True)

    ids = [s.stream_id for s in wl.streams]
    values = np.stack([s.values for s in wl.streams], axis=1)  # [T, N]
    ts = wl.streams[0].timestamps
    base_cfg = cluster_preset()
    cfg = dataclasses.replace(base_cfg, likelihood=dataclasses.replace(
        base_cfg.likelihood, learning_period=EVAL_LEARNING_PERIOD,
        estimation_samples=EVAL_ESTIMATION))
    reg = StreamGroupRegistry(cfg, group_size=len(ids), device=args.device, threshold=0.0,
                              debounce=1, predict=args.horizon)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()

    events: list[dict] = []
    topology = TopologyMap.from_spec(wl.spec)
    predictor = PredictTracker(horizon=args.horizon, threshold=args.threshold,
                               min_ticks=args.min_ticks,
                               blast=BlastFuser(topology, seed_streams=ids))
    run = {}
    journal = None
    start = 0
    if args.workdir is None:
        predictor.sink = events.append
    else:
        from rtap_tpu_torch.resilience.journal import TickJournal
        from rtap_tpu_torch.service.checkpoint import peek_resume_ticks

        ck = os.path.join(args.workdir, "ck")
        journal = TickJournal(os.path.join(args.workdir, "journal"))
        start = max(journal.next_tick, peek_resume_ticks(ck))
        run = dict(alert_path=os.path.join(args.workdir, "alerts.jsonl"), checkpoint_dir=ck,
                   checkpoint_every=CHECKPOINT_EVERY, journal=journal,
                   correlator=IncidentCorrelator(topology))

    def feed(k: int):
        g = start + k  # the feed depends only on the global tick
        return values[g], int(ts[g])

    t0 = time.perf_counter()
    try:
        stats = live_loop(feed, reg, n_ticks=max(0, args.ticks - start),
                          cadence_s=args.cadence, predictor=predictor, **run)
    finally:
        if journal is not None:
            journal.close()
    elapsed = time.perf_counter() - t0
    if args.workdir is not None:
        events = _events_on_disk(run["alert_path"])
    score = score_lead_time(events, wl.burst_onsets, wl.burst_nodes)

    failures: list[str] = []
    if not score["paged"]:
        failures.append("no precursor/predicted_incident fired on the cascade service")
    elif score["lead_ticks_vs_second"] is None or score["lead_ticks_vs_second"] <= 0:
        failures.append(f"paged at tick {score['page_tick']}, AFTER the second node's "
                        f"onset {score['second_onset']} — no lead")
    if not score["blast_covered"]:
        failures.append("predicted blast radius does not cover the faulted nodes: "
                        f"{score['predicted_incident']} vs {wl.burst_nodes}")
    if score["false_precursors"]:
        failures.append(f"{score['false_precursors']} false precursor(s) on the healthy "
                        "control service")
    result = {
        "verified": not failures,
        "failures": failures,
        "scenario": {
            "ticks": args.ticks, "seed": args.seed, "services": args.services,
            "nodes_per_service": args.nodes_per_service, "cascade_lag": args.cascade_lag,
            "burst_dur": args.burst_dur, "precursor_ramp": args.precursor_ramp,
            "precursor_ticks": args.precursor_ticks, "precursor_node": wl.precursor_node,
            "precursor_start": wl.precursor_start, "burst_onsets": wl.burst_onsets,
            "n_streams": len(ids),
        },
        "predictor": {"horizon_ticks": args.horizon, "threshold": args.threshold,
                      "min_ticks": args.min_ticks},
        "score": score,
        "predict_stats": stats.get("predict"),
        "device": str(reg.device),
        "resumed_at_tick": start,
        "ticks_run": stats["ticks"],
        "elapsed_s": round(elapsed, 3),
    }
    if "incidents" in stats:
        result["incidents"] = stats["incidents"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(result), flush=True)
    for msg in failures:
        print(f"[predict] FAIL: {msg}", file=sys.stderr)
    return VERIFY_FAILED_EXIT if failures else 0


if __name__ == "__main__":
    sys.exit(main())
