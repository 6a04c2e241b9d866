"""Replay equal-length streams through stream groups at full speed.

Port of the JAX package's ``service/loop.py::replay_streams``: each chunk
of `chunk_ticks` ticks is one dispatch per group, with a depth-2 pipeline
(the device steps chunk t+1 while the host post-processes chunk t). Alerts
go to a JSONL sink; with a checkpoint dir
each group saves every `checkpoint_every` collected chunks and a later call
resumes each group from its own recorded tick, suppressing the alert ids
the earlier run already delivered. With a ``trace`` recorder every chunk's
dispatch and collect become host spans (``replay_dispatch``,
``replay_collect``) on the group's track, keyed by the chunk's first tick.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.data.synthetic import LabeledStream
from rtap_tpu_torch.service.alerts import AlertWriter, ThroughputCounter, scan_alert_ids
from rtap_tpu_torch.service.checkpoint import (
    checkpoint_exists,
    load_group,
    save_group,
    validate_resume,
)
from rtap_tpu_torch.service.registry import StreamGroupRegistry, alert_gid
from rtap_tpu_torch.service.shardpath import group_checkpoint_path


@dataclass
class ReplayResult:
    stream_ids: list[str]
    timestamps: np.ndarray  # [T] int64 (shared clock)
    raw: np.ndarray  # [T, N] f32
    log_likelihood: np.ndarray  # [T, N] f64
    alerts: np.ndarray  # [T, N] bool
    predictions: np.ndarray | None = None  # [T, N] f32 when the classifier is on
    throughput: dict = field(default_factory=dict)
    registry: StreamGroupRegistry | None = None  # the groups, with their final state


def replay_streams(
    streams: Sequence[LabeledStream],
    cfg: ModelConfig,
    device=None,
    group_size: int | None = None,
    chunk_ticks: int = 64,
    threshold: float = 0.5,
    alert_path: str | None = None,
    learn: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    debounce: int = 1,
    trace=None,
) -> ReplayResult:
    """Replay equal-length streams through grouped models. All streams share
    a clock (stream 0's timestamps are the result's); groups hold
    `group_size` streams (default: all in one group). Runs on `device`
    (``cuda`` unless given).

    With `checkpoint_dir` + `checkpoint_every=k`, each group's resume state
    is saved atomically every k collected chunks (the pipeline drained
    first) and at its end; a later call with the same dir resumes every
    checkpointed group from its recorded tick. Ticks before the resume point
    stay NaN in the result and ``throughput["resumed_from"]`` records the
    boundary."""
    n = len(streams)
    T = len(streams[0].values)
    for s in streams:
        if len(s.values) != T:
            raise ValueError("replay_streams requires equal-length streams")
    group_size = group_size or n
    ids = [s.stream_id for s in streams]

    reg = StreamGroupRegistry(cfg, group_size=group_size, device=device,
                              threshold=threshold, debounce=debounce)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()

    values = np.stack([s.values for s in streams], axis=1)  # [T, N]
    ts = np.stack([s.timestamps for s in streams], axis=1).astype(np.int64)  # [T, N]

    raw = np.full((T, n), np.nan, np.float32)
    loglik = np.full((T, n), np.nan, np.float64)
    alerts = np.zeros((T, n), bool)
    # NaN-filled like raw: on a resumed run the rows before the resume
    # point were scored by the earlier run
    preds = np.full((T, n), np.nan, np.float32) if cfg.classifier.enabled else None
    writer = AlertWriter(alert_path)
    counter = ThroughputCounter()
    resumed_from: dict[str, int] = {}
    suppression_scanned_from: int | None = None  # lowest alert cursor scanned

    groups_with_work = 0
    for gi, grp in enumerate(reg.groups):
        ck_path = None
        if checkpoint_dir is not None:
            ck_path = group_checkpoint_path(checkpoint_dir, gi)
            if checkpoint_exists(ck_path):
                resumed = load_group(ck_path, device=reg.device)
                validate_resume(resumed, ck_path, grp)
                if resumed.ticks % chunk_ticks and resumed.ticks < T:
                    raise ValueError(
                        f"checkpoint {ck_path} at tick {resumed.ticks} is not "
                        f"on the chunk grid ({chunk_ticks}); replay it with "
                        "the chunk size it was saved under")
                grp = reg.groups[gi] = resumed
                resumed_from[f"group{gi}"] = grp.ticks
                ck_off = grp.resume_alerts_offset
                if alert_path is not None and ck_off is not None and (
                        suppression_scanned_from is None or ck_off < suppression_scanned_from):
                    # exactly-once across the crash: ids the dead run
                    # delivered past the cursor are suppressed, not
                    # duplicated; one tail scan covers every group
                    writer.arm_suppression(scan_alert_ids(alert_path, ck_off))
                    suppression_scanned_from = ck_off
        if grp.ticks < T:
            groups_with_work += 1
        lo = gi * group_size
        live = grp.n_live
        sids = ids[lo:lo + live]
        # pad slots replay the first live stream's data; their scores are dropped
        gv = np.repeat(values[:, lo:lo + 1], grp.G, axis=1)
        gt = np.repeat(ts[:, lo:lo + 1], grp.G, axis=1)
        gv[:, :live] = values[:, lo:lo + live]
        gt[:, :live] = ts[:, lo:lo + live]

        def collect(span, handle):
            t0, t1 = span
            tc0 = time.perf_counter() if trace is not None else 0.0
            r, ll, al = grp.collect_chunk(handle)
            if trace is not None:
                trace.add_span("replay_collect", t0, tc0, time.perf_counter() - tc0,
                               group=gi)
            raw[t0:t1, lo:lo + live] = r[:, :live]
            loglik[t0:t1, lo:lo + live] = ll[:, :live]
            alerts[t0:t1, lo:lo + live] = al[:, :live]
            if preds is not None:
                preds[t0:t1, lo:lo + live] = grp.last_predictions[:, :live]
            counter.add((t1 - t0) * live)
            for i in range(t0, t1):
                # alert_id group:stream:tick — the replay tick IS the
                # group's tick counter (epoch-suffixed when the resumed
                # checkpoint carries a quarantine restore's rewound timeline)
                writer.emit_batch(sids, gt[i, :live], gv[i, :live], r[i - t0, :live],
                                  ll[i - t0, :live], al[i - t0, :live],
                                  group=alert_gid(gi, grp), tick=i)

        pending: deque = deque()
        chunks_done = 0
        for t0 in range(grp.ticks, T, chunk_ticks):
            t1 = min(t0 + chunk_ticks, T)
            td0 = time.perf_counter() if trace is not None else 0.0
            pending.append(((t0, t1), grp.dispatch_chunk(gv[t0:t1], gt[t0:t1], learn=learn)))
            if trace is not None:
                # enqueue time on cuda: the span never waits for the device
                trace.add_span("replay_dispatch", t0, td0, time.perf_counter() - td0,
                               group=gi)
            if len(pending) >= 2:
                collect(*pending.popleft())
                chunks_done += 1
            if learn and ck_path is not None and checkpoint_every and \
                    chunks_done and chunks_done % checkpoint_every == 0 and pending:
                # drain before saving: the state must correspond exactly to
                # the last COLLECTED tick or resume would double-step
                while pending:
                    collect(*pending.popleft())
                    chunks_done += 1
                writer.flush_sink()
                save_group(grp, ck_path, alerts_offset=writer.sink_offset())
        while pending:
            collect(*pending.popleft())
            chunks_done += 1
        if learn and ck_path is not None and checkpoint_every and grp.ticks >= T:
            writer.flush_sink()
            save_group(grp, ck_path, alerts_offset=writer.sink_offset())
    writer.close()
    if resumed_from and not groups_with_work:
        raise ValueError(
            f"checkpoint dir {checkpoint_dir} resumes every group at tick >= "
            f"replay length {T}: nothing left to replay. To re-score this "
            "corpus through the trained model, serve it with --freeze; to "
            "keep learning, replay a longer stream or a fresh checkpoint dir.")

    stats = {
        **counter.stats(),
        "alerts": writer.count,
        # kernel capacity overflow (col_cap / learn_cap): nonzero means some
        # stream exceeded a static bound and deviates from the reference
        "tm_overflow_total": sum(g.overflow_total() for g in reg.groups),
    }
    if resumed_from:
        stats["resumed_from"] = resumed_from
    return ReplayResult(stream_ids=ids, timestamps=streams[0].timestamps, raw=raw,
                        log_likelihood=loglik, alerts=alerts, predictions=preds,
                        throughput=stats, registry=reg)
