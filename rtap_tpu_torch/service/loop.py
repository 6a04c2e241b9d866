"""The live serve loop: paced ticks from a source through stream groups.

Port of the JAX package's ``service/loop.py::live_loop``. Each tick polls
``source(tick) -> (values [N], ts)``, journals the row (write-ahead),
dispatches every group's chunk, collects and emits alerts, checkpoints on
its cadence, and sleeps off the rest of the cadence budget. The same feed,
seed and fault spec give the JAX package's alert lines byte for byte and
its state leaves bit for bit.

The model-side trackers ride the loop as in the JAX package: the health
tracker and the precursor tracker fold each collected chunk's reducer
leaves, and the incident correlator folds every delivered alert; their
events go onto the alert stream.

Resilience in one process, as in the JAX package: a group whose dispatch
or collect raises (or whose journal replay finds a gap) is QUARANTINED —
its in-flight handles are dropped uncollected, it stops being scored and
saved, and every other group keeps its cadence; with a checkpoint dir and
``quarantine_restore_after`` it is restored from its last checkpoint under
a new alert-id epoch. The degradation ladder sheds learning and widens the
cadence under sustained misses; a chaos engine injects scripted faults at
the source, dispatch/collect, alert-sink and checkpoint seams. The
observability hooks — span trace, flight recorder, latency sketches, SLOs,
alert attribution — observe host wall clocks only and never synchronise
the device.

A binary ingest source (ingest.BinaryBatchSource) gets the registry's slot
map on every membership change, and its tick journals as the raw wire
frames that composed it (a FRAME record), which a resume decodes back into
the row through the registry's dispatch table.

Not ported (ROADMAP.md queue A): leases and replication, dispatch threads,
chunk stagger, AOT warm-up, fleet publishing.
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
from rtap_tpu_torch.ingest.dispatch import DispatchTable, decode_frames_to_row
from rtap_tpu_torch.obs import TickWatchdog, get_registry
from rtap_tpu_torch.resilience.journal import JournaledFrames
from rtap_tpu_torch.resilience.policies import CircuitBreaker
from rtap_tpu_torch.service.alerts import (
    AlertWriter,
    ThroughputCounter,
    scan_alert_ids,
    scan_event_ids,
)
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
    alert_gid,
)
from rtap_tpu_torch.service.shardpath import alert_sidecar_path, group_checkpoint_path

#: bound on remembered rejected-id names under auto_register (an
#: id-spraying producer must not grow a long-lived server's memory)
_MAX_REJECTED_TRACKED = 4096

#: the tick phases the loop accounts wall seconds to (one
#: rtap_obs_phase_seconds histogram per phase; stats["phase_ms_per_tick"])
_PHASES = ("source", "membership", "dispatch", "collect", "emit", "checkpoint")


def _sync_source_membership(source, reg: StreamGroupRegistry) -> None:
    """Push the registry's membership to the source after any change:
    slot-map-addressed sources (ingest.BinaryBatchSource) get the (shard,
    group, slot) map, flat-id sources (TcpJsonlSource, HttpPollSource) the
    dispatch-order id list. Other sources size their vector to
    ``reg.dispatch_ids()`` themselves (the length check is the guard)."""
    if hasattr(source, "set_slot_map"):
        source.set_slot_map(reg.slot_map())
    elif hasattr(source, "set_ids"):
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
    chaos=None,
    degradation=None,
    quarantine_restore_after: int = 0,
    alert_flush_every: int = 1,
    trace=None,
    flight=None,
    attributor=None,
    journal=None,
    health=None,
    correlator=None,
    latency=None,
    slo=None,
    predictor=None,
) -> dict:
    """Paced live scoring: each tick, poll `source(tick) -> (values, ts)`,
    score the group(s), emit alerts, sleep off the rest of the cadence
    budget. Returns stats including the missed-deadline count,
    ``missed_tick_phase_ms`` (at a cadence above 0: each missed tick with
    its ms per phase), ``missing_values`` (the (stream, tick) samples the
    source gave as missing, scored all the same) and
    ``learned_group_ticks`` (group-ticks dispatched with learning on: one
    TM learning-kernel launch each at ``learn_every`` 1 on the card).

    `group` is a :class:`StreamGroup` or a finalized
    :class:`StreamGroupRegistry`; the source's values follow the
    registry's dispatch order (``dispatch_ids()``). Every tick dispatches
    every group before collecting any.

    `pipeline_depth=2` collects tick k after dispatching tick k+1, so the
    device steps while the host waits out the cadence; alerts lag one
    tick. `micro_chunk=M` batches M ticks into one dispatch per group
    (alerts lag up to depth*M - 1 ticks). Membership changes, restores and
    checkpoints force a chunk boundary and drain the pipeline.

    `learn=False` freezes the models (state bit-identical after any number
    of ticks; the likelihood keeps adapting) and never writes checkpoints.

    `auto_register=True` (registry + a source with ``drain_unknown`` and
    ``set_ids``): unknown ids seen on the wire claim free pad slots; ids
    beyond capacity are counted in ``auto_rejected``.
    `auto_release_after=N`: a stream silent (all-NaN) for N consecutive
    ticks releases its slot at the next tick.

    `checkpoint_dir` + `checkpoint_every=k`: every unquarantined group's
    resume state is saved atomically every k ticks (pipeline drained, sink
    flushed) and on exit; a later call with the same dir resumes every
    group from its checkpoint, validated against what this run built.

    Fault containment: a dispatch or collect exception QUARANTINES that
    group (a ``group_quarantined`` event, the ``rtap_obs_groups_quarantined``
    gauge, ``stats["quarantine_log"]``); its in-flight handles are dropped,
    never waited on. With `checkpoint_dir` and
    `quarantine_restore_after=N` it is re-loaded from its last checkpoint N
    ticks later (``group_restored``; a failed restore is
    ``group_restore_failed`` and the group stays quarantined) on the old
    group's device, under a bumped alert epoch (alert ids ``<gi>.e<epoch>``:
    the restore rewinds its tick counter). ``stats["scored_by_group"]``
    counts each group's scored samples (the chaos soak's silent-gap
    oracle). A raising source scores a whole-vector missing sample;
    timestamps going backwards are clamped; checkpoint save failures are
    per-group events and 3 failed rounds open a breaker.

    `degradation` (resilience.DegradationController) sheds load under
    sustained misses: learn_thin -> score_only -> tick_widen, removing
    learning per chunk at dispatch time and widening the effective
    cadence. `chaos` (resilience.ChaosEngine) injects scripted faults at
    the source, per-group dispatch/collect, the alert sink's file and the
    checkpoint saves; a ``proc_exit`` fault kills the process right after
    its tick is journaled.

    `trace` (obs.TraceRecorder): every phase interval becomes a host span
    (plus a whole-tick span and per-group dispatch/collect spans) and every
    watchdog/resilience event an instant. On cuda a dispatch span is the
    enqueue time; no span synchronises the device. `flight`
    (obs.FlightRecorder) keeps the last N ticks and dumps a postmortem
    bundle on a quarantine, a ladder move, a miss burst, a health or
    precursor incident or a fast SLO burn — after the tick's accounting.
    `attributor` (service.attribution.AlertAttributor) adds ``top_fields``
    to alert lines. `latency` (obs.LatencyTracker) folds each tick's stage
    waterfall and every delivered alert's detect latency; `slo`
    (obs.SloTracker, needs `latency`) judges them with burn rates; its
    verdict is ``stats["slo"]``.

    `journal` (a resilience.journal.TickJournal): every tick row is
    appended before it is scored; on entry, recovered rows past each
    group's checkpoint are replayed through the normal scoring path
    (matched by the global journal tick), with the alert ids already on
    disk past the checkpoints' alert cursor suppressed — exactly-once
    across a crash. A group whose replay window has a hole is quarantined.
    After each emitted chunk the journal records the alert cursor; after
    each save round with no group quarantined it is compacted.

    `health` (obs.HealthTracker, serve --health; the groups built with
    ``health=True``), `predictor` (predict.PredictTracker, serve --predict;
    the groups built with ``predict=k``) and `correlator`
    (correlate.IncidentCorrelator, serve --topology) fold each collected
    chunk's reducer leaves and each delivered alert as in the JAX package;
    their events go onto the alert stream and their rollups into
    ``stats["health"]``, ``stats["predict"]`` and ``stats["incidents"]``.
    """
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1; got {pipeline_depth}")
    if micro_chunk < 1:
        raise ValueError(f"micro_chunk must be >= 1; got {micro_chunk}")
    if quarantine_restore_after < 0:
        raise ValueError(
            f"quarantine_restore_after must be >= 0; got {quarantine_restore_after}")
    if quarantine_restore_after and checkpoint_dir is None:
        raise ValueError(
            "quarantine_restore_after needs --checkpoint-dir: restore means "
            "re-loading the group's last checkpoint")
    if auto_release_after < 0:
        raise ValueError(f"auto_release_after must be >= 0; got {auto_release_after}")
    if slo is not None and latency is None:
        raise ValueError(
            "slo needs latency: the SLO tracker judges the latency "
            "tracker's observations (serve --slo requires --latency)")
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

    def _replace_group(gi: int, old: StreamGroup, new: StreamGroup) -> None:
        """Swap a loaded group in for `old`: the registry's index follows."""
        groups[gi] = new
        if reg is not None:
            for slot in reg._slots.values():
                if slot.group is old:
                    slot.group = new

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
            # the health flag is run config, not checkpoint state
            resumed.health = grp.health
            _replace_group(gi, grp, resumed)
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
        if predictor is not None and predictor.blast is not None:
            # claimed streams join their cluster's predicted blast radius
            predictor.blast.observe_streams(sid for _s, ids, _o in maps for sid in ids)
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
                                   "wall-clock unix time the last tick completed — the "
                                   "GET /healthz liveness source")
    obs_trace_records = obs_trace_dropped = None
    if trace is not None:
        obs_trace_records = obs.gauge(
            "rtap_obs_trace_records",
            "span/instant records appended to the trace ring this run")
        obs_trace_dropped = obs.gauge(
            "rtap_obs_trace_dropped",
            "trace records overwritten by ring wrap-around (grow "
            "--trace-ring if postmortems need deeper history)")
    obs_source_errors = obs.counter(
        "rtap_obs_source_errors_total",
        "source callables that RAISED (vs. returning NaN); the tick "
        "scored a whole-vector missing sample instead of dying")
    obs_ts_regressions = obs.counter(
        "rtap_obs_source_time_regressions_total",
        "ticks whose source timestamp went backwards (clamped monotonic)")
    obs_groups_quarantined = obs.gauge(
        "rtap_obs_groups_quarantined",
        "stream groups currently quarantined (dispatch/collect fault isolation)")
    obs_groups_quarantined.set(0)
    auto_registered = 0
    auto_rejected_total = 0
    auto_rejected: set = set()  # bounded de-dup memory, not the count
    auto_released = 0
    silent_ticks: dict = {}  # sid -> consecutive all-NaN ticks
    release_pending: set = set()
    writer = AlertWriter(alert_path, flush_every=alert_flush_every, attributor=attributor,
                         correlator=correlator, latency=latency)
    correlator_resume = None
    if correlator is not None:
        if correlator.sink is None:
            correlator.sink = writer.emit_event
        if correlator.flight is None:
            correlator.flight = flight
        if alert_path is not None:
            # re-fold the sink tail before any replay or live emission, from
            # the sidecar floor (a checkpoint's cursor can sit past an open
            # window's earlier members): delivered alerts re-enter their
            # windows, emitted incident ids seed the dedupe set, incidents
            # that closed without their line landing re-emit
            if correlator.sidecar_path is None:
                correlator.sidecar_path = alert_sidecar_path(alert_path, "corr")
            known = [g.resume_alerts_offset for g in groups
                     if g.resume_alerts_offset is not None]
            correlator_resume = correlator.resume_from(
                alert_path, correlator.resume_scan_offset(min(known) if known else 0))
    counter = ThroughputCounter()
    if chaos is not None:
        # injection outside the loop's own code: the wrapped source and
        # alert file exercise the real recovery paths from below
        source = chaos.wrap_source(source)
        chaos.wrap_alert_writer(writer)

    def _sync_chaos_routing():
        """Tell the engine which source-vector slice each group reads, so
        group-targeted source faults hit exactly that group's streams."""
        if chaos is not None:
            chaos.set_group_streams({
                gi: tuple(range(off, off + len(slots)))
                for gi, (slots, _ids, off) in enumerate(routing)})

    _sync_chaos_routing()
    if degradation is not None and degradation.sink is None:
        degradation.sink = writer.emit_event
    # incidents, precursors and SLO burns ride the alert stream and request
    # flight-recorder dumps; every bundle's summary embeds their snapshots
    for tracker, provider in ((health, "health_provider"), (predictor, "predict_provider")):
        if tracker is None:
            continue
        if tracker.sink is None:
            tracker.sink = writer.emit_event
        if tracker.flight is None:
            tracker.flight = flight
        if flight is not None and getattr(flight, provider) is None:
            setattr(flight, provider, tracker.snapshot)
    if slo is not None:
        if slo.sink is None:
            slo.sink = writer.emit_event
        if slo.flight is None:
            slo.flight = flight
        if latency.slo is None:
            latency.slo = slo
    if latency is not None and flight is not None and flight.latency_provider is None:
        flight.latency_provider = latency.snapshot
    eff_cadence = cadence_s  # widened by the degradation ladder's level 3
    quarantined: dict[int, dict] = {}  # gi -> {tick, phase, error, restore_at}
    # the quarantine/restore history: the chaos soak's oracle must not
    # depend on the alert stream, whose sink may itself be faulted
    quarantine_log: list[dict] = []
    group_scored = [0] * len(groups)
    learned_group_ticks = 0
    restore_s: list[float] = []  # wall seconds of each landed restore (load + swap)
    res_counters: dict = {}

    def _res_event(kind: str, tick: int, **fields) -> None:
        """Structured resilience event: a registry counter bump per kind, a
        trace instant, a flight-recorder event and one JSONL line on the
        alert stream."""
        c = res_counters.get(kind)
        if c is None:
            c = res_counters[kind] = obs.counter(
                "rtap_obs_resilience_events_total",
                "structured resilience events by kind", event=kind)
        c.inc()
        if trace is not None:
            trace.add_instant(kind, int(tick), fields, group=int(fields.get("group", -1)))
        if flight is not None:
            flight.record_event({"event": kind, "tick": int(tick), **fields})
        writer.emit_event({"event": kind, "tick": int(tick), **fields})

    def _quarantine_group(gi: int, tick: int, phase: str, exc: Exception) -> None:
        """Isolate a faulted group: it stops being dispatched, collected,
        emitted and checkpointed while every other group keeps its cadence.
        Its in-flight handles are left uncollected (never waited on)."""
        if gi in quarantined:
            return
        info = {"tick": int(tick), "phase": phase, "error": f"{type(exc).__name__}: {exc}"}
        if quarantine_restore_after and checkpoint_dir is not None:
            info["restore_at"] = int(tick) + int(quarantine_restore_after)
        quarantined[gi] = info
        quarantine_log.append({"event": "group_quarantined", "group": gi,
                               "tick": int(tick), "phase": phase})
        obs_groups_quarantined.set(len(quarantined))
        _res_event("group_quarantined", tick, group=gi, phase=phase, error=info["error"],
                   streams=int(groups[gi].n_live))
        if flight is not None:
            flight.request_dump("group_quarantined", tick)

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
        """One atomic save per unquarantined group at a drained instant ->
        True iff every save landed. A quarantined group is not saved: its
        last good checkpoint is its restore source. A failed group save is
        evented and counted, never raised (its previous checkpoint is
        intact by atomicity)."""
        nonlocal checkpoint_save_failures
        writer.flush_sink()
        alerts_offset = writer.sink_offset()
        journal_tick = journal_base + ticks_run if journal is not None else None
        failed = 0
        for gi, grp in enumerate(groups):
            if gi in quarantined:
                continue
            try:
                if chaos is not None:
                    chaos.on_checkpoint_save(gi, tick)
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

    def _compact() -> None:
        """Ticks below every checkpoint are never replayed again; while a
        group is quarantined compaction pauses (its restore source is an
        older checkpoint whose replay window must stay on disk)."""
        if journal is not None and not quarantined:
            journal.compact(min((g.ticks for g in groups), default=0))

    watchdog = TickWatchdog(cadence_s, registry=obs, event_sink=writer.emit_event,
                            trace=trace, flight=flight)
    missed = 0
    # (tick, ms per phase) of each tick past a real cadence's deadline
    missed_phase_ms: list = []
    checkpoints_saved = 0
    ticks_run = 0
    last_saved = 0
    latencies = np.empty(n_ticks, np.float64)  # per-tick poll->emit seconds
    phase_s = dict.fromkeys(_PHASES, 0.0)
    cur_tick = 0  # the loop's tick clock, read by the fault-capture paths
    journal_base = 0
    journal_append_s = 0.0  # wall seconds in journal.append_tick (write-ahead cost)
    missing_values = 0  # (stream, tick) samples polled as missing

    def _fold_trackers(gi, grp, slots, ids, health_tick):
        """Fold a collected chunk's reducer leaves. The health tick only
        throttles dumps; the predictor keys on the GROUP tick (the chunk's
        last row), which a restart's journal replay reproduces."""
        if health is not None and grp.last_health is not None:
            health.fold(gi, grp.last_health, tick=health_tick)
        if predictor is not None and grp.last_predict is not None:
            id_by_slot = [None] * grp.G
            for s, sid in zip(slots, ids):
                id_by_slot[s] = sid
            predictor.fold(gi, grp.last_predict, tick=grp.ticks - 1, ids=id_by_slot)

    def _collect_tick(ts_rows, value_rows, handles, rmaps):
        # collects in group order, then emission in group order, so the
        # alert stream is schedule-independent. Quarantined groups (and the
        # None handles of failed dispatches) are skipped: their handles are
        # dropped, never waited on; a collect fault quarantines its group
        t0 = time.perf_counter()
        pairs = [(gi, h) for gi, h in enumerate(handles)
                 if gi not in quarantined and h is not None]
        results: dict = {}
        for gi, h in pairs:
            tg0 = time.perf_counter()
            try:
                if chaos is not None:
                    chaos.on_collect(gi, cur_tick)
                results[gi] = groups[gi].collect_chunk(h)
            except Exception as e:  # any fault isolates the group
                _quarantine_group(gi, cur_tick, "collect", e)
            if trace is not None:
                trace.add_span("collect", cur_tick, tg0, time.perf_counter() - tg0, group=gi)
        t1 = time.perf_counter()
        phase_s["collect"] += t1 - t0
        if trace is not None:
            trace.add_span("collect", cur_tick, t0, t1 - t0)
        scored = 0
        for gi, _h in pairs:
            if gi not in results:
                continue
            raw, loglik, alerts = results[gi]
            slots, ids, off = rmaps[gi]
            n = len(slots)
            # the group's own tick counter names the rows just collected:
            # alert_id = group:stream:group-tick, stable across restarts
            # (epoch-suffixed after a restore rewound the counter)
            grp_tick0 = groups[gi].ticks - len(ts_rows)
            gid = alert_gid(gi, groups[gi])
            for i, (ts, values) in enumerate(zip(ts_rows, value_rows)):
                writer.emit_batch(ids, np.full(n, ts), values[off:off + n], raw[i, slots],
                                  loglik[i, slots], alerts[i, slots], group=gid,
                                  tick=grp_tick0 + i)
                counter.add(n)
                scored += n
            group_scored[gi] += len(ts_rows) * n
            _fold_trackers(gi, groups[gi], slots, ids, cur_tick)
        obs_scored.inc(scored)
        if journal is not None and pairs:
            # the alert-delivery cursor: alerts through this tick sit in the
            # sink below this offset (flushed first so it is on disk)
            writer.flush_sink()
            journal.append_cursor(journal_base + cur_tick, writer.sink_offset())
        t2 = time.perf_counter()
        phase_s["emit"] += t2 - t1
        if trace is not None:
            trace.add_span("emit", cur_tick, t1, t2 - t1)

    # ---- journal recovery + replay: recovered rows past each group's
    # checkpoint go through the normal dispatch/collect path (m = 1
    # chunks), emitting under the resume suppression set; no cadence
    journal_replay = {"replayed_ticks": 0, "replay_seconds": 0.0, "skipped_rows": 0}
    gpos: list = []
    if journal is not None:
        t_jr0 = time.perf_counter()
        if chaos is not None:
            # replay is recovery, not live serving: no fault window covers
            # tick -1 (a shifted sink fault at local tick 0 would otherwise
            # drop replayed alerts for good)
            chaos.set_tick(-1)
        # per-group GLOBAL journal cursor where each checkpoint stopped (a
        # restore rewinds the group's own counter, the global clock runs on)
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
                if predictor is not None:
                    # precursor / predicted_incident ids are functions of
                    # (stream, group tick): the replay reproduces them, and
                    # the ones already on disk must not page twice
                    predictor.arm_suppression(scan_event_ids(
                        alert_path, min(known_offs) if known_offs else 0))
            obs_jr = obs.counter(
                "rtap_obs_journal_replayed_ticks_total",
                "journaled ticks replayed through the scoring path on resume")
            # groups whose replay window has a hole (compacted or evicted
            # rows): scoring row jt as an earlier tick would corrupt state
            # and alert ids, so the group is quarantined instead
            gap_groups: set = set()
            jtable = None  # dispatch table for FRAME records, built once
            for jt, jts, jvals in jrows:
                if isinstance(jvals, JournaledFrames):
                    # a binary ingest tick: materialize the row by re-running
                    # the ingest scatter over the raw frames (bit-exact;
                    # membership changes checkpoint + compact at their boundary)
                    if jvals.width != n_expected or reg is None:
                        journal_replay["skipped_rows"] += 1
                        continue
                    if jtable is None:
                        jtable = DispatchTable.from_registry(reg)
                    jvals = decode_frames_to_row([jvals.blob], jvals.width, jtable)
                else:
                    jvals = np.asarray(jvals, np.float32)
                if len(jvals) != n_expected:
                    # membership changed between record and resume without
                    # a checkpoint dir (every in-loop change checkpoints)
                    journal_replay["skipped_rows"] += 1
                    continue
                for gi, grp in enumerate(groups):
                    if gi in quarantined or gi in gap_groups or gpos[gi] > jt:
                        continue  # this group's checkpoint is already past
                    if jt > gpos[gi]:
                        gap_groups.add(gi)
                        _quarantine_group(gi, 0, "journal_replay_gap", RuntimeError(
                            f"journal gap: group resumes at global tick {gpos[gi]} "
                            f"but the first surviving row is tick {jt} "
                            "(compacted/evicted)"))
                        continue
                    slots, g_ids, off = routing[gi]
                    v = np.full((1, grp.G) + jvals.shape[1:], np.nan, np.float32)
                    v[0, slots] = jvals[off:off + len(slots)]
                    t = np.full((1, grp.G), int(jts), np.int64)
                    try:
                        r_raw, r_ll, r_al = grp.collect_chunk(
                            grp.dispatch_chunk(v, t, learn=learn))
                    except Exception as e:  # isolate the group
                        _quarantine_group(gi, jt, "journal_replay", e)
                        continue
                    learned_group_ticks += int(learn)
                    gpos[gi] += 1
                    # catch-up ticks warm the trackers too (health at tick 0,
                    # like every replay-time event), before the row's alerts
                    _fold_trackers(gi, grp, slots, g_ids, 0)
                    n = len(slots)
                    writer.emit_batch(g_ids, np.full(n, int(jts)), jvals[off:off + n],
                                      r_raw[0, slots], r_ll[0, slots], r_al[0, slots],
                                      group=alert_gid(gi, grp), tick=grp.ticks - 1)
                    counter.add(n)
                    obs_scored.inc(n)
                obs_jr.inc()
                if correlator is not None:
                    # the correlation clock advances on the replayed rows'
                    # own timestamps: every close reproduces the live run's
                    correlator.on_tick(int(jts))
                last_ts_seen = int(jts) if last_ts_seen is None else max(last_ts_seen, int(jts))
            journal_replay["replayed_ticks"] = len(jrows) - journal_replay["skipped_rows"]
            if gap_groups:
                journal_replay["gap_groups"] = sorted(gap_groups)
            journal_replay["replay_seconds"] = round(time.perf_counter() - t_jr0, 4)
            _res_event("journal_replayed", 0, ticks=journal_replay["replayed_ticks"],
                       from_tick=int(jrows[0][0]), to_tick=int(jrows[-1][0]),
                       seconds=journal_replay["replay_seconds"])
        del jrows
        journal.release_recovered()
        # the run's global tick base: past every global position reached
        # and every index already on disk (appends never reuse an index)
        journal_base = max(gpos + [journal.next_tick])

    def _dispatch_all(value_rows, ts_rows, rmaps, learn_flag):
        """Dispatch every unquarantined group -> handles aligned with the
        groups (None for quarantined or faulted ones). A dispatch fault
        (a device error, an injected one) quarantines its group."""
        nonlocal learned_group_ticks
        m = len(value_rows)
        handles: list = [None] * len(groups)
        for gi, grp in enumerate(groups):
            if gi in quarantined:
                continue
            slots, _ids, off = rmaps[gi]
            # trailing field axis preserved: values may be [N] or [N, n_fields]
            v = np.full((m, grp.G) + value_rows[0].shape[1:], np.nan, np.float32)
            for i, row in enumerate(value_rows):
                v[i, slots] = row[off:off + len(slots)]
            t = np.repeat(np.asarray(ts_rows, np.int64)[:, None], grp.G, axis=1)
            tg0 = time.perf_counter()
            try:
                if chaos is not None:
                    chaos.on_dispatch(gi, cur_tick)
                handles[gi] = grp.dispatch_chunk(v, t, learn=learn_flag)
                learned_group_ticks += m * int(learn_flag)
            except Exception as e:  # any fault isolates the group
                _quarantine_group(gi, cur_tick, "dispatch", e)
            if trace is not None:
                # host enqueue time on cuda: the span never waits for the device
                trace.add_span("dispatch", cur_tick, tg0, time.perf_counter() - tg0, group=gi)
        return handles

    in_flight: deque = deque()
    chunk_buf: list = []

    def _drain():
        while in_flight:
            _collect_tick(*in_flight.popleft())

    def _align_boundaries():
        """A nothing-buffered, nothing-in-flight instant (membership changes,
        restores and checkpoints need one): flush the partial chunk, drain."""
        if chunk_buf:
            _flush()
        _drain()

    def _flush():
        vrows = [b[0] for b in chunk_buf]
        tsrows = [b[1] for b in chunk_buf]
        chunk_buf.clear()
        # the degradation ladder removes learning per chunk at dispatch time
        # (level 1 thins, level >= 2 freezes); it never adds it
        lrn = learn and (degradation is None or degradation.learn_allowed(cur_tick))
        now = time.perf_counter()
        handles = _dispatch_all(vrows, tsrows, routing, lrn)
        t1 = time.perf_counter()
        phase_s["dispatch"] += t1 - now
        if trace is not None:
            trace.add_span("dispatch", cur_tick, now, t1 - now)
        in_flight.append((tsrows, vrows, handles, routing))
        while len(in_flight) >= pipeline_depth:
            _collect_tick(*in_flight.popleft())

    def _restore_due(k: int) -> bool:
        """Quarantine auto-restore: each group whose cooldown elapsed is
        re-loaded from its last checkpoint on its old device (losing the
        ticks since that save) under a bumped alert epoch. -> True iff a
        group came back (the routing must then be rebuilt)."""
        due = sorted(gi for gi, info in quarantined.items()
                     if info.get("restore_at") is not None and k >= info["restore_at"])
        if not due:
            return False
        _align_boundaries()
        restored_any = False
        for gi in due:
            ck_path = group_checkpoint_path(checkpoint_dir, gi)
            old = groups[gi]
            t_restore = time.perf_counter()
            try:
                if not checkpoint_exists(ck_path):
                    raise FileNotFoundError(
                        f"no checkpoint at {ck_path} (the group was never saved "
                        "before its fault)")
                restored = load_group(ck_path, device=old.device)
                restored.health = old.health
                validate_resume(restored, ck_path, old,
                                allow_claimed_extras=auto_register or not learn)
            except Exception as e:
                # give up loudly and stop retrying: quarantine is the safe state
                quarantined[gi]["restore_at"] = None
                quarantine_log.append({"event": "group_restore_failed", "group": gi,
                                       "tick": int(k)})
                _res_event("group_restore_failed", k, group=gi,
                           error=f"{type(e).__name__}: {e}")
                continue
            # the restore rewinds the group's tick counter: a new alert-id
            # epoch keeps re-used tick indices off delivered ids
            restored.alert_epoch = max(restored.alert_epoch, old.alert_epoch) + 1
            _replace_group(gi, old, restored)
            # the old group's device state goes with its last reference
            del old
            del quarantined[gi]
            restored_any = True
            quarantine_log.append({"event": "group_restored", "group": gi, "tick": int(k),
                                   "resumed_from_tick": int(restored.ticks)})
            restore_s.append(time.perf_counter() - t_restore)
            obs_groups_quarantined.set(len(quarantined))
            _res_event("group_restored", k, group=gi, resumed_from_tick=int(restored.ticks))
        return restored_any

    try:
        for k in range(n_ticks):
            # orderly shutdown: finish between ticks, save final state, report
            if stop_event is not None and stop_event.is_set():
                break
            cur_tick = k
            if chaos is not None:
                chaos.set_tick(k)
            t_start = time.perf_counter()
            scored_tick0 = list(group_scored) if flight is not None else None
            phase_tick0 = dict(phase_s)
            # membership booking excludes the dispatch/collect/emit seconds
            # its drains accrue (those book into their own phases); captured
            # before the restore, whose drain books the same way
            ce_tick0 = phase_s["collect"] + phase_s["emit"] + phase_s["dispatch"]
            if quarantined and quarantine_restore_after and _restore_due(k):
                # the restored instances replace groups[gi]: the routing maps
                # must observe the new objects
                routing, n_expected = _build_routing()
                routing_version = reg.version if reg is not None else 0
                _sync_chaos_routing()
                obs_rebuilds.inc()
                obs_streams.set(n_expected)
                if reg is not None:
                    _sync_source_membership(source, reg)
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
                _sync_chaos_routing()
                obs_rebuilds.inc()
                obs_streams.set(n_expected)
                if journal is not None and checkpoint_dir and learn:
                    # a membership change resizes the journal's row: checkpoint
                    # NOW (drained) so a replay window never spans two widths
                    if _save_round(k):
                        checkpoints_saved += 1
                        last_saved = ticks_run
                        _compact()
            now = time.perf_counter()
            mem_booked = (now - t_start) - (
                phase_s["collect"] + phase_s["emit"] + phase_s["dispatch"] - ce_tick0)
            phase_s["membership"] += mem_booked
            if trace is not None and mem_booked > 1e-6:
                # at the block start with the BOOKED duration (drains inside
                # the block own their spans)
                trace.add_span("membership", k, t_start, max(0.0, mem_booked))
            tick_frames = None  # raw binary ingest frames (the journal's payload)
            try:
                values, ts = source(k)
            except Exception as e:
                # a raising source must not kill scoring: the tick becomes a
                # whole-vector missing sample, counted (evented on the first
                # of a run), on the source's own timeline
                obs_source_errors.inc()
                source_error_run += 1
                if source_error_run == 1:
                    _res_event("source_error", k, error=f"{type(e).__name__}: {e}")
                values = np.full((n_expected,) + fallback_trailing, np.nan, np.float32)
                ts = last_ts_seen if last_ts_seen is not None else int(time.time())
            else:
                source_error_run = 0
                if journal is not None and hasattr(source, "take_tick_frames"):
                    # only a successful poll journals raw frames: the NaN
                    # fallback tick journals as the full-width row it scored
                    tick_frames = source.take_tick_frames()
            src_t1 = time.perf_counter()
            phase_s["source"] += src_t1 - now
            if trace is not None:
                trace.add_span("source", k, now, src_t1 - now)
            # the poll-done wall instant anchors the tick's ingest lag
            lat_poll_wall = time.time() if latency is not None else 0.0
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
                # before any scoring; a death past here replays this tick.
                # A binary ingest tick journals its raw wire frames (10 B
                # per row that arrived) instead of the full-width vector
                t_append = time.perf_counter()
                if tick_frames is not None:
                    journal.append_tick_frames(journal_base + k, ts, len(values), tick_frames)
                else:
                    journal.append_tick(journal_base + k, ts, values)
                journal_append_s += time.perf_counter() - t_append
            if chaos is not None:
                # proc_exit fires here, after the row is journaled, so a
                # restart's resume base is unambiguously past it
                chaos.on_tick_ingested(k)
            if auto_release_after:
                # consecutive silence over THIS tick's values; releases defer
                # to the next tick's membership block
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
            chunk_buf.append((values.copy() if pipeline_depth > 1 or micro_chunk > 1
                              else values, ts))
            if len(chunk_buf) >= micro_chunk or k + 1 == n_ticks:
                _flush()
            if correlator is not None:
                # after this tick's emission: close quiesced windows on the
                # source clock (alerts lagging in the pipeline carry their own
                # older ts; --correlate-window must exceed that staleness)
                correlator.on_tick(ts, tick=k, sink_offset=writer.sink_offset())
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
                    if trace is not None:
                        trace.add_span("checkpoint", k, now,
                                       max(0.0, phase_s["checkpoint"] - ck0))
                    watchdog.observe_checkpoint(k, phase_s["checkpoint"] - ck0)
                    if saved:
                        ck_breaker.record_success()
                        checkpoints_saved += 1
                        last_saved = ticks_run
                        _compact()
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
            deltas = {p: phase_s[p] - phase_tick0[p] for p in _PHASES}
            for p in _PHASES:
                obs_phase[p].observe(deltas[p])
            if trace is not None:
                trace.add_span("tick", k, t_start, elapsed)
                obs_trace_records.set(trace.total)
                obs_trace_dropped.set(trace.dropped)
            missed_this = watchdog.observe_tick(k, elapsed)
            if missed_this:
                missed += 1
                if cadence_s > 0:
                    missed_phase_ms.append((k, {p: round(v * 1e3, 3)
                                                for p, v in deltas.items()}))
            if degradation is not None:
                # the ladder reacts to the verdict the watchdog just judged;
                # its tick_widen step changes the cadence both measure against
                level0 = degradation.level
                degradation.observe(k, missed_this)
                if flight is not None and degradation.level != level0:
                    flight.request_dump("degradation_level_change", k)
                new_cadence = cadence_s * degradation.cadence_scale
                if new_cadence != eff_cadence:
                    eff_cadence = new_cadence
                    watchdog.set_cadence(eff_cadence)
            if latency is not None:
                # the tick's stage waterfall and lag probes; the SLO judges
                # after, so a burn's dump request is flushed below
                latency.record_tick(k, ts, deltas, elapsed, poll_wall=lat_poll_wall,
                                    source=source)
                if slo is not None:
                    slo.on_tick(k)
            if flight is not None:
                flight.record_tick(k, elapsed, deltas,
                                   [a - b for a, b in zip(group_scored, scored_tick0)],
                                   missed_this)
                # queued dumps write HERE, after the deadline accounting and
                # before the sleep: a dump consumes this tick's sleep, never
                # a phase span
                flight.flush_pending()
            # wall-clock based, clamped: post-accounting work shortens the
            # sleep, and a recovery can shrink eff_cadence below elapsed
            budget = max(0.0, eff_cadence - (time.perf_counter() - t_start))
            if not missed_this and k + 1 < n_ticks:
                if stop_event is not None:
                    stop_event.wait(budget)  # a shutdown signal ends the sleep
                else:
                    time.sleep(budget)
        if chunk_buf:
            _flush()  # early stop mid-chunk: score what was ingested
        _drain()
    finally:
        if flight is not None:
            # a quarantine raised by the final drain (or an early stop)
            # queued its dump after the last in-loop flush
            flight.flush_pending()
    if learn and checkpoint_dir and (ticks_run > last_saved
                                     or journal_replay["replayed_ticks"] > 0):
        # final state on exit (clean or stopped): a resume must not lose
        # learned ticks; frozen serving never writes its checkpoint dir.
        # Bypasses the breaker (one last best-effort save)
        if _save_round(ticks_run):
            checkpoints_saved += 1
            _compact()
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
    if cadence_s > 0:
        stats["missed_tick_phase_ms"] = missed_phase_ms
    # resilience accounting: per-group scored counts are the chaos soak's
    # silent-gap oracle (a group's count must equal its unquarantined span)
    stats["scored_by_group"] = [int(x) for x in group_scored]
    stats["learned_group_ticks"] = learned_group_ticks
    if quarantined:
        stats["quarantined"] = {
            f"group{gi}": {kk: vv for kk, vv in info.items() if kk != "restore_at"}
            for gi, info in sorted(quarantined.items())}
    if quarantine_log:
        stats["quarantine_log"] = quarantine_log
    if restore_s:
        stats["restore_s"] = [round(x, 4) for x in restore_s]
    if degradation is not None:
        stats["degradation"] = degradation.stats()
    if chaos is not None:
        stats["chaos_injected"] = len(chaos.injected)
    if journal is not None:
        stats["journal"] = {**journal.stats(), **journal_replay,
                            "suppressed_alerts": writer.suppressed,
                            "append_ms_per_tick": round(journal_append_s / max(ticks_run, 1)
                                                        * 1e3, 3)}
    if flight is not None:
        stats["postmortem"] = flight.stats()
    if health is not None:
        stats["health"] = health.stats()
    if predictor is not None:
        stats["predict"] = predictor.stats()
    if correlator is not None:
        stats["incidents"] = correlator.stats()
        if correlator_resume is not None:
            stats["incidents"]["resume"] = correlator_resume
    if latency is not None:
        stats["latency"] = latency.stats()
    if slo is not None:
        stats["slo"] = slo.verdict()
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
