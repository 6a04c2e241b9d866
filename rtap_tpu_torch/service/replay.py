"""Replay equal-length streams through stream groups at full speed.

Port of the JAX package's ``service/loop.py::replay_streams`` without the
checkpoint, alert-file and trace options: each chunk of `chunk_ticks`
ticks is one dispatch per group, with a depth-2 pipeline (the device steps
chunk t+1 while the host post-processes chunk t).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.data.synthetic import LabeledStream
from rtap_tpu_torch.service.registry import StreamGroupRegistry


@dataclass
class ReplayResult:
    stream_ids: list[str]
    timestamps: np.ndarray  # [T] int64 (shared clock)
    raw: np.ndarray  # [T, N] f32
    log_likelihood: np.ndarray  # [T, N] f64
    alerts: np.ndarray  # [T, N] bool
    throughput: dict = field(default_factory=dict)
    registry: StreamGroupRegistry | None = None  # the groups, with their final state


def replay_streams(
    streams: Sequence[LabeledStream],
    cfg: ModelConfig,
    device=None,
    group_size: int | None = None,
    chunk_ticks: int = 64,
    threshold: float = 0.5,
    learn: bool = True,
    debounce: int = 1,
) -> ReplayResult:
    """Replay equal-length streams through grouped models. All streams share
    a clock (stream 0's timestamps are the result's); groups hold
    `group_size` streams (default: all in one group). Runs on `device`
    (``cuda`` unless given)."""
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
    start = time.perf_counter()
    scored = 0

    for gi, grp in enumerate(reg.groups):
        lo = gi * group_size
        live = grp.n_live
        # pad slots replay the first live stream's data; their scores are dropped
        gv = np.repeat(values[:, lo:lo + 1], grp.G, axis=1)
        gt = np.repeat(ts[:, lo:lo + 1], grp.G, axis=1)
        gv[:, :live] = values[:, lo:lo + live]
        gt[:, :live] = ts[:, lo:lo + live]

        def collect(span, handle):
            nonlocal scored
            t0, t1 = span
            r, ll, al = grp.collect_chunk(handle)
            raw[t0:t1, lo:lo + live] = r[:, :live]
            loglik[t0:t1, lo:lo + live] = ll[:, :live]
            alerts[t0:t1, lo:lo + live] = al[:, :live]
            scored += (t1 - t0) * live

        pending: deque = deque()
        for t0 in range(0, T, chunk_ticks):
            t1 = min(t0 + chunk_ticks, T)
            pending.append(((t0, t1), grp.dispatch_chunk(gv[t0:t1], gt[t0:t1], learn=learn)))
            if len(pending) >= 2:
                collect(*pending.popleft())
        while pending:
            collect(*pending.popleft())

    elapsed = max(time.perf_counter() - start, 1e-9)
    stats = {
        "scored": scored,
        "elapsed_s": elapsed,
        "metrics_per_sec": scored / elapsed,
        "alerts": int(alerts.sum()),
        # kernel capacity overflow (col_cap / learn_cap): nonzero means some
        # stream exceeded a static bound and deviates from the reference
        "tm_overflow_total": sum(g.overflow_total() for g in reg.groups),
    }
    return ReplayResult(stream_ids=ids, timestamps=streams[0].timestamps, raw=raw,
                        log_likelihood=loglik, alerts=alerts, throughput=stats, registry=reg)
