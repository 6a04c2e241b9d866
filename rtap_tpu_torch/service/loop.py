"""The live serve loop: paced ticks from a source through stream groups.

Port of the JAX package's ``service/loop.py::live_loop`` core. Each tick
polls ``source(tick) -> (values [N], ts)``, journals the row (write-ahead),
dispatches every group's chunk, collects and emits alerts, checkpoints on
its cadence, and sleeps off the rest of the cadence budget. The same feed
and seed give the JAX package's alert lines byte for byte and its state
leaves bit for bit.

Not ported (ROADMAP.md queue A): quarantine and auto-restore, degradation,
chaos, leases and replication, dispatch threads, chunk stagger, AOT
warm-up, tracing, flight recorder, health/predict reducers, incident
correlation, latency/SLO tracking, fleet publishing, binary ingest. Here a
group whose dispatch or collect raises stops the loop: the exception
propagates to the caller.
"""

from __future__ import annotations

import logging
import os
import re
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

import rtap_tpu_torch.ops.tm_learn as tm_learn
from rtap_tpu_torch.obs import TickWatchdog, get_registry
from rtap_tpu_torch.resilience.journal import JournaledFrames
from rtap_tpu_torch.resilience.policies import CircuitBreaker
from rtap_tpu_torch.service.alerts import AlertWriter, ThroughputCounter, scan_alert_ids
from rtap_tpu_torch.service.checkpoint import (
    checkpoint_exists,
    load_group,
    save_group,
    validate_resume,
)
from rtap_tpu_torch.service.registry import (
    PAD_PREFIX,
    StreamGroup,
    StreamGroupRegistry,
    _Slot,
)
from rtap_tpu_torch.service.shardpath import group_checkpoint_path

#: bound on remembered rejected-id names under auto_register (an
#: id-spraying producer must not grow a long-lived server's memory)
_MAX_REJECTED_TRACKED = 4096

#: the tick phases the loop accounts wall seconds to (one
#: rtap_obs_phase_seconds histogram per phase; stats["phase_ms_per_tick"])
_PHASES = ("source", "membership", "dispatch", "collect", "emit", "checkpoint")


def _sync_source_membership(source, reg: StreamGroupRegistry) -> None:
    """Push the registry's dispatch-order ids to a source that keeps its
    own id table (TcpJsonlSource, HttpPollSource) after a membership
    change. Other sources size their vector to ``reg.dispatch_ids()``
    themselves (the length check is the guard)."""
    if hasattr(source, "set_ids"):
        source.set_ids(reg.dispatch_ids())


def live_loop(
    source: Callable[[int], tuple[np.ndarray, int]],
    group: StreamGroup | StreamGroupRegistry,
    n_ticks: int,
    cadence_s: float = 1.0,
    alert_path: str | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    stop_event=None,
    pipeline_depth: int = 1,
    learn: bool = True,
    auto_register: bool = False,
    auto_release_after: int = 0,
    micro_chunk: int = 1,
    alert_flush_every: int = 1,
    journal=None,
) -> dict:
    """Paced live scoring: each tick, poll `source(tick) -> (values, ts)`,
    score the group(s), emit alerts, sleep off the rest of the cadence
    budget. Returns stats including the missed-deadline count and
    ``missing_values``, the (stream, tick) samples the source gave as
    missing (scored all the same).

    `group` is a :class:`StreamGroup` or a finalized
    :class:`StreamGroupRegistry`; the source's values follow the
    registry's dispatch order (``dispatch_ids()``). Every tick dispatches
    every group before collecting any.

    `pipeline_depth=2` collects tick k after dispatching tick k+1, so the
    device steps while the host waits out the cadence; alerts lag one
    tick. `micro_chunk=M` batches M ticks into one dispatch per group
    (alerts lag up to depth*M - 1 ticks). Membership changes and
    checkpoints force a chunk boundary and drain the pipeline.

    `learn=False` freezes the models (state bit-identical after any number
    of ticks; the likelihood keeps adapting) and never writes checkpoints.

    `auto_register=True` (registry + a source with ``drain_unknown`` and
    ``set_ids``): unknown ids seen on the wire claim free pad slots; ids
    beyond capacity are counted in ``auto_rejected``.
    `auto_release_after=N`: a stream silent (all-NaN) for N consecutive
    ticks releases its slot at the next tick.

    `checkpoint_dir` + `checkpoint_every=k`: every group's resume state is
    saved atomically every k ticks (pipeline drained, sink flushed) and on
    exit; a later call with the same dir resumes every group from its
    checkpoint, validated against what this run built.

    `journal` (a resilience.journal.TickJournal): every tick row is
    appended before it is scored; on entry, recovered rows past each
    group's checkpoint are replayed through the normal scoring path
    (matched by the global journal tick), with the alert ids already on
    disk past the checkpoints' alert cursor suppressed — exactly-once
    across a crash. After each emitted chunk the journal records the alert
    cursor; after each save round it is compacted.
    """
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1; got {pipeline_depth}")
    if micro_chunk < 1:
        raise ValueError(f"micro_chunk must be >= 1; got {micro_chunk}")
    if auto_release_after < 0:
        raise ValueError(f"auto_release_after must be >= 0; got {auto_release_after}")
    if isinstance(group, StreamGroupRegistry):
        if group._pending or not group._finalized:
            raise ValueError(
                "live_loop needs a finalized registry (finalize() seals the "
                f"last group; {len(group._pending)} streams pending, "
                f"finalized={group._finalized})")
        reg = group
        groups = reg.groups  # the live list: resume replaces entries in place
    else:
        if checkpoint_dir is not None:
            raise ValueError(
                "live_loop checkpointing needs a StreamGroupRegistry (a bare "
                "StreamGroup caller could not observe the resumed instances)")
        reg = None
        groups = [group]
    if auto_release_after and reg is None:
        raise ValueError("auto_release_after needs a StreamGroupRegistry")
    launches0 = tm_learn.launches

    resumed_from: dict[str, int] = {}
    resume_tick_skew = 0
    if checkpoint_dir is not None:
        for gi, grp in enumerate(groups):
            ck_path = group_checkpoint_path(checkpoint_dir, gi)
            if not checkpoint_exists(ck_path):
                continue
            resumed = load_group(ck_path, device=grp.device)
            # claimed extras resume when this run could have claimed them
            # (auto_register) or serves frozen (reading, not claiming)
            validate_resume(resumed, ck_path, grp,
                            allow_claimed_extras=auto_register or not learn)
            groups[gi] = resumed
            for slot in reg._slots.values():
                if slot.group is grp:
                    slot.group = resumed
            # streams the prior run auto-registered rejoin the index
            for si, sid in enumerate(resumed.stream_ids):
                if not sid.startswith(PAD_PREFIX) and sid not in reg:
                    reg._slots[sid] = _Slot(resumed, si)
                    reg.version += 1
            resumed_from[f"group{gi}"] = resumed.ticks
        # a checkpointed group beyond the built topology must not be
        # dropped silently: demand a matching topology instead
        stray = sorted(
            d for d in os.listdir(checkpoint_dir)
            if re.fullmatch(r"group\d{4,}", d) and int(d[5:]) >= len(groups)
            and os.path.isdir(os.path.join(checkpoint_dir, d))
        ) if os.path.isdir(checkpoint_dir) else []
        if stray:
            raise ValueError(
                f"checkpoint dir {checkpoint_dir} holds {stray} beyond this "
                f"run's {len(groups)} group(s): the prior run had more "
                "claimable capacity. Rerun with the same --reserve/"
                "--group-size so every checkpointed stream resumes")
        if resumed_from:
            _sync_source_membership(source, reg)
        # a crash between per-group saves leaves a torn set: live data is
        # not tick-indexed and groups are independent, so resume anyway,
        # loudly (the skew is warned and exposed in stats)
        ticks_seen = {g.ticks for g in groups}
        if len(ticks_seen) > 1:
            logging.getLogger(__name__).warning(
                "live_loop: resuming a torn checkpoint set (group ticks %s "
                "— a crash landed between per-group saves); behind groups "
                "lost that many ticks of learning", sorted(ticks_seen))
        resume_tick_skew = (max(ticks_seen) - min(ticks_seen)) if resumed_from else 0

    # value/emission routing: per group, its live slots, their ids and the
    # group's offset into the source vector; rebuilt when the registry's
    # membership version changes (each in-flight chunk carries its own)
    def _build_routing():
        maps, off = [], 0
        for g in groups:
            slots = g.live_slots()
            maps.append((slots, [g.stream_ids[i] for i in slots], off))
            off += len(slots)
        return maps, off

    routing, n_expected = _build_routing()
    routing_version = reg.version if reg is not None else 0
    obs = get_registry()
    obs_ticks = obs.counter("rtap_obs_ticks_total", "live_loop ticks completed")
    obs_scored = obs.counter(
        "rtap_obs_scored_total",
        "anomaly-scored (stream, tick) samples emitted — the north-star "
        "metrics counter")
    obs_tick_seconds = obs.histogram(
        "rtap_obs_tick_seconds", "per-tick host wall seconds (poll -> emit, excl. cadence sleep)")
    obs_phase = {p: obs.histogram("rtap_obs_phase_seconds",
                                  "per-tick wall seconds by loop phase", phase=p)
                 for p in _PHASES}
    obs_streams = obs.gauge("rtap_obs_streams_active",
                            "live (non-pad) stream slots currently routed")
    obs_streams.set(n_expected)
    obs_rebuilds = obs.counter("rtap_obs_routing_rebuilds_total",
                               "emission-routing rebuilds after membership version bumps")
    obs_last_tick_wall = obs.gauge("rtap_obs_last_tick_unixtime",
                                   "wall-clock unix time the last tick completed")
    obs_source_errors = obs.counter(
        "rtap_obs_source_errors_total",
        "source callables that RAISED (vs. returning NaN); the tick "
        "scored a whole-vector missing sample instead of dying")
    obs_ts_regressions = obs.counter(
        "rtap_obs_source_time_regressions_total",
        "ticks whose source timestamp went backwards (clamped monotonic)")
    auto_registered = 0
    auto_rejected_total = 0
    auto_rejected: set = set()  # bounded de-dup memory, not the count
    auto_released = 0
    silent_ticks: dict = {}  # sid -> consecutive all-NaN ticks
    release_pending: set = set()
    writer = AlertWriter(alert_path, flush_every=alert_flush_every)
    counter = ThroughputCounter()
    group_scored = [0] * len(groups)

    def _res_event(kind: str, tick: int, **fields) -> None:
        """Structured resilience event: a registry counter bump per kind
        and one JSONL line on the alert stream."""
        obs.counter("rtap_obs_resilience_events_total",
                    "structured resilience events by kind", event=kind).inc()
        writer.emit_event({"event": kind, "tick": int(tick), **fields})

    source_error_run = 0  # consecutive source raises (event on the first)
    last_ts_seen = None  # monotonic clamp floor for source timestamps
    ts_regress_run = 0  # consecutive clamped ticks (event on the first)
    # trailing value dims of the NaN substitute when the source raises,
    # seeded from the model config
    _nf = groups[0].cfg.n_fields if groups else 1
    fallback_trailing: tuple = (_nf,) if _nf > 1 else ()
    ck_breaker = None
    ck_quarantine_announced = False
    checkpoint_save_failures = 0
    group_saves: list[float] = []  # wall seconds of each landed group save
    if checkpoint_dir is not None:
        # 3 consecutive failed save rounds quarantine checkpointing (a full
        # disk): the cooldown admits a probe round later; scoring goes on
        ck_breaker = CircuitBreaker(fail_threshold=3, cooldown_s=max(30.0, 10 * cadence_s),
                                    name="checkpoint")

    def _save_round(tick: int) -> bool:
        """One atomic save per group at a drained instant -> True iff every
        group's save landed. A failed group save is evented and counted,
        never raised: its previous checkpoint is intact by atomicity."""
        nonlocal checkpoint_save_failures
        writer.flush_sink()
        alerts_offset = writer.sink_offset()
        journal_tick = journal_base + ticks_run if journal is not None else None
        failed = 0
        for gi, grp in enumerate(groups):
            try:
                t_save = time.perf_counter()
                save_group(grp, group_checkpoint_path(checkpoint_dir, gi),
                           alerts_offset=alerts_offset, journal_tick=journal_tick)
                group_saves.append(time.perf_counter() - t_save)
            except Exception as e:  # contained per group: the disk, not the loop
                failed += 1
                checkpoint_save_failures += 1
                _res_event("checkpoint_save_failed", tick, group=gi,
                           error=f"{type(e).__name__}: {e}")
        return not failed

    watchdog = TickWatchdog(cadence_s, registry=obs, event_sink=writer.emit_event)
    missed = 0
    checkpoints_saved = 0
    ticks_run = 0
    last_saved = 0
    latencies = np.empty(n_ticks, np.float64)  # per-tick poll->emit seconds
    phase_s = dict.fromkeys(_PHASES, 0.0)
    cur_tick = 0
    journal_base = 0
    journal_append_s = 0.0  # wall seconds in journal.append_tick (write-ahead cost)
    missing_values = 0  # (stream, tick) samples polled as missing

    def _collect_tick(ts_rows, value_rows, handles, rmaps):
        # collects in group order, then emission in group order, so the
        # alert stream is schedule-independent
        t0 = time.perf_counter()
        results = [groups[gi].collect_chunk(h) for gi, h in enumerate(handles)]
        t1 = time.perf_counter()
        phase_s["collect"] += t1 - t0
        scored = 0
        for gi, (raw, loglik, alerts) in enumerate(results):
            slots, ids, off = rmaps[gi]
            n = len(slots)
            # the group's own tick counter names the rows just collected:
            # alert_id = group:stream:group-tick, stable across restarts
            grp_tick0 = groups[gi].ticks - len(ts_rows)
            for i, (ts, values) in enumerate(zip(ts_rows, value_rows)):
                writer.emit_batch(ids, np.full(n, ts), values[off:off + n], raw[i, slots],
                                  loglik[i, slots], alerts[i, slots], group=gi,
                                  tick=grp_tick0 + i)
                counter.add(n)
                scored += n
            group_scored[gi] += len(ts_rows) * n
        obs_scored.inc(scored)
        if journal is not None:
            # the alert-delivery cursor: alerts through this tick sit in the
            # sink below this offset (flushed first so it is on disk)
            writer.flush_sink()
            journal.append_cursor(journal_base + cur_tick, writer.sink_offset())
        phase_s["emit"] += time.perf_counter() - t1

    # ---- journal recovery + replay: recovered rows past each group's
    # checkpoint go through the normal dispatch/collect path (m = 1
    # chunks), emitting under the resume suppression set; no cadence
    journal_replay = {"replayed_ticks": 0, "replay_seconds": 0.0, "skipped_rows": 0}
    gpos: list = []
    if journal is not None:
        t_jr0 = time.perf_counter()
        # per-group GLOBAL journal cursor where each checkpoint stopped
        gpos = [g.resume_journal_tick if g.resume_journal_tick is not None else g.ticks
                for g in groups]
        jrows = [r for r in journal.recovered_ticks if r[0] >= min(gpos, default=0)]
        if journal.truncations or journal.dropped_segments:
            _res_event("journal_tail_truncated", 0,
                       truncations=int(journal.truncations),
                       bytes=int(journal.truncated_bytes),
                       dropped_segments=int(journal.dropped_segments))
        if jrows:
            if alert_path is not None:
                # exactly-once: every alert byte past the checkpoints' alert
                # cursors belongs to the ticks about to be replayed
                known_offs = [g.resume_alerts_offset for g in groups
                              if g.resume_alerts_offset is not None]
                writer.arm_suppression(scan_alert_ids(
                    alert_path, min(known_offs) if known_offs else 0))
            obs_jr = obs.counter(
                "rtap_obs_journal_replayed_ticks_total",
                "journaled ticks replayed through the scoring path on resume")
            for jt, jts, jvals in jrows:
                if isinstance(jvals, JournaledFrames):
                    # a binary-ingest row of the JAX package: its decode
                    # (the dispatch table) is not ported
                    journal_replay["skipped_rows"] += 1
                    continue
                jvals = np.asarray(jvals, np.float32)
                if len(jvals) != n_expected:
                    # membership changed between record and resume without
                    # a checkpoint dir (every in-loop change checkpoints)
                    journal_replay["skipped_rows"] += 1
                    continue
                for gi, grp in enumerate(groups):
                    if gpos[gi] > jt:
                        continue  # this group's checkpoint is already past
                    if jt > gpos[gi]:
                        # scoring row jt as an earlier tick would corrupt
                        # state and alert ids; without quarantine, stop
                        raise RuntimeError(
                            f"journal gap: group {gi} resumes at global tick "
                            f"{gpos[gi]} but the first surviving row is tick "
                            f"{jt} (compacted or evicted)")
                    slots, g_ids, off = routing[gi]
                    v = np.full((1, grp.G) + jvals.shape[1:], np.nan, np.float32)
                    v[0, slots] = jvals[off:off + len(slots)]
                    t = np.full((1, grp.G), int(jts), np.int64)
                    r_raw, r_ll, r_al = grp.collect_chunk(grp.dispatch_chunk(v, t, learn=learn))
                    gpos[gi] += 1
                    n = len(slots)
                    writer.emit_batch(g_ids, np.full(n, int(jts)), jvals[off:off + n],
                                      r_raw[0, slots], r_ll[0, slots], r_al[0, slots],
                                      group=gi, tick=grp.ticks - 1)
                    counter.add(n)
                    obs_scored.inc(n)
                obs_jr.inc()
                last_ts_seen = int(jts) if last_ts_seen is None else max(last_ts_seen, int(jts))
            journal_replay["replayed_ticks"] = len(jrows) - journal_replay["skipped_rows"]
            journal_replay["replay_seconds"] = round(time.perf_counter() - t_jr0, 4)
            _res_event("journal_replayed", 0, ticks=journal_replay["replayed_ticks"],
                       from_tick=int(jrows[0][0]), to_tick=int(jrows[-1][0]),
                       seconds=journal_replay["replay_seconds"])
        del jrows
        journal.release_recovered()
        # the run's global tick base: past every global position reached
        # and every index already on disk (appends never reuse an index)
        journal_base = max(gpos + [journal.next_tick])

    in_flight: deque = deque()
    chunk_buf: list = []

    def _drain():
        while in_flight:
            _collect_tick(*in_flight.popleft())

    def _align_boundaries():
        """A nothing-buffered, nothing-in-flight instant (membership changes
        and checkpoints need one): flush the partial chunk, drain."""
        if chunk_buf:
            _flush()
        _drain()

    def _flush():
        vrows = [b[0] for b in chunk_buf]
        tsrows = [b[1] for b in chunk_buf]
        chunk_buf.clear()
        m = len(vrows)
        now = time.perf_counter()
        handles = []
        for gi, grp in enumerate(groups):
            slots, _ids, off = routing[gi]
            # trailing field axis preserved: values may be [N] or [N, n_fields]
            v = np.full((m, grp.G) + vrows[0].shape[1:], np.nan, np.float32)
            for i, row in enumerate(vrows):
                v[i, slots] = row[off:off + len(slots)]
            t = np.repeat(np.asarray(tsrows, np.int64)[:, None], grp.G, axis=1)
            handles.append(grp.dispatch_chunk(v, t, learn=learn))
        phase_s["dispatch"] += time.perf_counter() - now
        in_flight.append((tsrows, vrows, handles, routing))
        while len(in_flight) >= pipeline_depth:
            _collect_tick(*in_flight.popleft())

    for k in range(n_ticks):
        # orderly shutdown: finish between ticks, save final state, report
        if stop_event is not None and stop_event.is_set():
            break
        cur_tick = k
        t_start = time.perf_counter()
        phase_tick0 = dict(phase_s)
        # membership booking excludes the dispatch/collect/emit seconds its
        # drains accrue (those book into their own phases)
        ce_tick0 = phase_s["collect"] + phase_s["emit"] + phase_s["dispatch"]
        # lazy model creation: unknown ids the source saw claim free pad
        # slots, with nothing buffered or in flight
        if auto_register and reg is not None and not chunk_buf \
                and hasattr(source, "drain_unknown"):
            fresh = [s for s in source.drain_unknown()
                     if s not in auto_rejected and s not in reg
                     and not s.startswith(PAD_PREFIX)]
            claimed = False
            for sid in fresh:
                if reg.free_slots == 0:
                    auto_rejected_total += 1
                    if len(auto_rejected) < _MAX_REJECTED_TRACKED:
                        auto_rejected.add(sid)
                    continue
                if not claimed:
                    _align_boundaries()
                    claimed = True
                reg.add_stream(sid)
                auto_registered += 1
            if claimed:
                _sync_source_membership(source, reg)
        # elastic shrink: streams silent for auto_release_after ticks
        if release_pending and not chunk_buf:
            _align_boundaries()
            for sid in release_pending:
                if sid in reg:
                    reg.remove_stream(sid)
                    silent_ticks.pop(sid, None)
                    auto_released += 1
            release_pending.clear()
            # capacity changed: previously rejected ids deserve a retry
            auto_rejected.clear()
            _sync_source_membership(source, reg)
        if reg is not None and reg.version != routing_version:
            _align_boundaries()
            routing, n_expected = _build_routing()
            routing_version = reg.version
            obs_rebuilds.inc()
            obs_streams.set(n_expected)
            if journal is not None and checkpoint_dir and learn:
                # a membership change resizes the journal's row: checkpoint
                # NOW (drained) so a replay window never spans two widths
                if _save_round(k):
                    checkpoints_saved += 1
                    last_saved = ticks_run
                    journal.compact(min((g.ticks for g in groups), default=0))
        now = time.perf_counter()
        phase_s["membership"] += (now - t_start) - (
            phase_s["collect"] + phase_s["emit"] + phase_s["dispatch"] - ce_tick0)
        try:
            values, ts = source(k)
        except Exception as e:
            # a raising source must not kill scoring: the tick becomes a
            # whole-vector missing sample, counted (evented on the first of
            # a run), on the source's own timeline
            obs_source_errors.inc()
            source_error_run += 1
            if source_error_run == 1:
                _res_event("source_error", k, error=f"{type(e).__name__}: {e}")
            values = np.full((n_expected,) + fallback_trailing, np.nan, np.float32)
            ts = last_ts_seen if last_ts_seen is not None else int(time.time())
        else:
            source_error_run = 0
        phase_s["source"] += time.perf_counter() - now
        values = np.asarray(values, np.float32)
        watchdog.observe_source(k, values)
        if len(values) != n_expected:
            raise ValueError(
                f"source returned {len(values)} values for {n_expected} "
                "live streams (alignment with registration order is load-"
                "bearing — a silent mismatch would misroute streams)")
        fallback_trailing = values.shape[1:]
        # a stream's sample is missing when every field is NaN (scored all
        # the same, as the missing-sample path)
        nan = np.isnan(values)
        nan_mask = nan if nan.ndim == 1 else nan.reshape(len(values), -1).all(axis=1)
        missing_values += int(nan_mask.sum())
        # timestamps must not run backwards into the date encodings: clamp
        # monotonic, count, event the first regression of a run
        ts = int(ts)
        if last_ts_seen is not None and ts < last_ts_seen:
            obs_ts_regressions.inc()
            if ts_regress_run == 0:
                _res_event("source_time_regression", k, ts=ts, clamped_to=last_ts_seen)
            ts_regress_run += 1
            ts = last_ts_seen
        else:
            ts_regress_run = 0
            last_ts_seen = ts
        if journal is not None:
            # the write-ahead moment: the row is flushed to the kernel
            # before any scoring; a death past here replays this tick
            t_append = time.perf_counter()
            journal.append_tick(journal_base + k, ts, values)
            journal_append_s += time.perf_counter() - t_append
        if auto_release_after:
            # consecutive silence over THIS tick's values; releases defer to
            # the next tick's membership block
            for slots, ids, off in routing:
                for j, sid in enumerate(ids):
                    if nan_mask[off + j]:
                        n = silent_ticks.get(sid, 0) + 1
                        silent_ticks[sid] = n
                        if n >= auto_release_after:
                            release_pending.add(sid)
                    else:
                        silent_ticks.pop(sid, None)
        # held across ticks (micro_chunk) and collects (depth >= 2): a
        # source reusing its buffer must not corrupt the emitted values
        chunk_buf.append((values.copy() if pipeline_depth > 1 or micro_chunk > 1 else values, ts))
        if len(chunk_buf) >= micro_chunk or k + 1 == n_ticks:
            _flush()
        ticks_run = k + 1
        if learn and checkpoint_every and checkpoint_dir and not chunk_buf \
                and ticks_run - last_saved >= checkpoint_every:
            # due-since-last-save, not a modulus: with micro_chunk > 1
            # boundaries land only at multiples of M
            if ck_breaker.allow():
                ck_quarantine_announced = False
                now = time.perf_counter()
                ce0 = phase_s["collect"] + phase_s["emit"] + phase_s["dispatch"]
                ck0 = phase_s["checkpoint"]
                _align_boundaries()
                saved = _save_round(k)
                phase_s["checkpoint"] += (time.perf_counter() - now) - (
                    phase_s["collect"] + phase_s["emit"] + phase_s["dispatch"] - ce0)
                watchdog.observe_checkpoint(k, phase_s["checkpoint"] - ck0)
                if saved:
                    ck_breaker.record_success()
                    checkpoints_saved += 1
                    last_saved = ticks_run
                    if journal is not None:
                        # ticks below every checkpoint are never replayed again
                        journal.compact(min((g.ticks for g in groups), default=0))
                else:
                    # the round stays due (retried until the breaker opens)
                    ck_breaker.record_failure()
            elif not ck_quarantine_announced:
                ck_quarantine_announced = True
                _res_event("checkpoint_quarantined", k,
                           consecutive_failures=ck_breaker.consecutive_failures,
                           cooldown_s=ck_breaker.cooldown_s)
        elapsed = time.perf_counter() - t_start
        latencies[k] = elapsed
        obs_ticks.inc()
        obs_last_tick_wall.set(time.time())
        obs_tick_seconds.observe(elapsed)
        for p in _PHASES:
            obs_phase[p].observe(phase_s[p] - phase_tick0[p])
        missed_this = watchdog.observe_tick(k, elapsed)
        if missed_this:
            missed += 1
        budget = max(0.0, cadence_s - (time.perf_counter() - t_start))
        if not missed_this and k + 1 < n_ticks:
            if stop_event is not None:
                stop_event.wait(budget)  # a shutdown signal ends the sleep
            else:
                time.sleep(budget)
    if chunk_buf:
        _flush()  # early stop mid-chunk: score what was ingested
    _drain()
    if learn and checkpoint_dir and (ticks_run > last_saved
                                     or journal_replay["replayed_ticks"] > 0):
        # final state on exit (clean or stopped): a resume must not lose
        # learned ticks; frozen serving never writes its checkpoint dir
        if _save_round(ticks_run):
            checkpoints_saved += 1
            if journal is not None:
                journal.compact(min((g.ticks for g in groups), default=0))
    writer.close()

    stats = {**counter.stats(), "alerts": writer.count, "missed_deadlines": missed,
             "missing_values": missing_values,
             "ticks": ticks_run, "cadence_s": cadence_s, "n_groups": len(groups),
             "pipeline_depth": pipeline_depth, "micro_chunk": micro_chunk, "learn": learn}
    if auto_register:
        stats.update(auto_registered=auto_registered, auto_rejected=auto_rejected_total)
    if auto_release_after:
        stats["auto_released"] = auto_released
    if checkpoint_dir is not None:
        stats["checkpoints_saved"] = checkpoints_saved
        if group_saves:
            stats["group_save_s_mean"] = round(float(np.mean(group_saves)), 4)
        if resumed_from:
            stats["resumed_from"] = resumed_from
            stats["resume_tick_skew"] = resume_tick_skew
    if checkpoint_save_failures:
        stats["checkpoint_save_failures"] = checkpoint_save_failures
    if ticks_run < n_ticks:
        stats["stopped_early"] = True
        stats["ticks_requested"] = n_ticks
    if ticks_run > 0:
        stats["phase_ms_per_tick"] = {p: round(v / ticks_run * 1e3, 2)
                                      for p, v in phase_s.items()}
        used = latencies[:ticks_run]
        for p in (50, 90, 99):
            stats[f"latency_p{p}_ms"] = round(float(np.percentile(used, p)) * 1e3, 3)
        stats["latency_max_ms"] = round(float(used.max()) * 1e3, 3)
    stats["scored_by_group"] = [int(x) for x in group_scored]
    if journal is not None:
        stats["journal"] = {**journal.stats(), **journal_replay,
                            "suppressed_alerts": writer.suppressed,
                            "append_ms_per_tick": round(journal_append_s / max(ticks_run, 1)
                                                        * 1e3, 3)}
    # kernel capacity overflow (col_cap / learn_cap): nonzero means some
    # stream exceeded a static bound and deviates from the reference
    stats["tm_overflow_total"] = sum(g.overflow_total() for g in groups)
    # TM learning-kernel launches in this call (CPU groups run the plain
    # version and launch nothing)
    stats["kernel_launches"] = {"tm_learn": tm_learn.launches - launches0}
    stats.update(_occupancy(groups))
    return stats


def _occupancy(groups) -> dict:
    """Device memory of the groups' card for the stats (empty on the CPU):
    ``hbm_bytes_in_use`` / ``hbm_peak_bytes_in_use``, the JAX package's
    keys, from the caching allocator."""
    devs = {g.device for g in groups if g.device.type == "cuda"}
    if not devs:
        return {}
    return {"hbm_bytes_in_use": sum(torch.cuda.memory_allocated(d) for d in devs),
            "hbm_peak_bytes_in_use": sum(torch.cuda.max_memory_allocated(d) for d in devs)}
