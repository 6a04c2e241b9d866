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

Hot-standby failover rides the loop as in the JAX package: under a
leadership lease (resilience/replicate.py) the loop probes ``still_mine()``
at the top of every tick and before each save, and a fenced leader stops,
skips its final save and writes nothing more to the alert sink; a promoted
standby hands over the alert ids its dead leader delivered for ticks it
never received. A fleet publisher (fleet/member.py) is told each tick's
number, nothing more: its pushes run on its own thread.

The scheduling options are the JAX package's: ``dispatch_threads`` issues
the per-group dispatches and collects from a thread pool (every group on
the card's one default stream, so threads overlap host work only: value
packing, the eager stages' Python, the collect waits; emission stays in
group order), ``chunk_stagger`` rotates the micro-chunk boundaries across
groups, and ``aot_warmup`` runs every knowable program once before tick 0
(service/aot.py). None of them changes what a group computes.
"""

from __future__ import annotations

import logging
import os
import re
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
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
    dispatch_threads: int = 1,
    learn: bool = True,
    auto_register: bool = False,
    auto_release_after: int = 0,
    micro_chunk: int = 1,
    chunk_stagger: bool = False,
    chaos=None,
    degradation=None,
    quarantine_restore_after: int = 0,
    alert_flush_every: int = 1,
    aot_warmup: bool = False,
    trace=None,
    flight=None,
    attributor=None,
    journal=None,
    health=None,
    correlator=None,
    latency=None,
    slo=None,
    predictor=None,
    lease=None,
    resume_suppression=None,
    fleet=None,
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

    `dispatch_threads=N` issues the per-group dispatch and collect calls
    from a pool of min(N, groups) threads (``stats["dispatch_threads"]``
    is that effective count, 1 without a pool). Each group's calls touch
    that group only, the first dispatch of each (chunk length, config,
    learn) program runs alone, and emission stays serial in group order
    after the collects join: the alert stream and the state are
    bit-identical to the serial schedule. A dispatch or collect that
    raises in a pool thread quarantines its group after the join.

    `chunk_stagger=True` (needs micro_chunk >= 2): group i belongs to phase
    class i mod M; each class keeps its own buffer and pipeline and flushes
    on its own boundary (class c's first chunk is c + 1 rows, then every M),
    so each tick dispatches about 1/M of the groups instead of all of them
    every M-th tick. Checkpoints, claims, releases and restores force a
    one-tick realignment (every class flushes its partial chunk, the
    pipeline drains, the ramp restarts). ``stats["schedule"]`` then gives,
    per tick, the groups dispatched, the groups whose learning pass ran for
    that tick's row, the TM kernel launches and the dispatch ms.

    `aot_warmup=True` runs every knowable (chunk length, config, learn)
    program, and the claim program when capacity is claimable, once on a
    throwaway group before tick 0 (service/aot.py); stats gain
    ``aot_programs_compiled``, ``cold_compiles_after_warmup`` (programs the
    loop dispatched that the warm-up did not know: 0 unless the
    enumeration missed one), ``aot_warmup_s`` and ``aot_kernel_launches``
    (the warm-up's launches, kept out of ``kernel_launches``).

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

    `lease` (resilience.replicate.Lease, or fleet.control.ControlLease):
    the leadership lease this loop serves under. Freshness rides the lease's
    heartbeat thread (started here if the caller has not); the loop probes
    ``still_mine()`` at the top of every tick, and a probe that finds the
    fencing epoch advanced (a standby promoted while this process was
    paused) FENCES the loop: a ``leader_fenced`` event, an orderly break
    (``stats["fenced"]``; serve exits ``replicate.FENCED_RC``), no final
    save, and the AlertWriter's fence refuses any straggler line. A lease
    with ``pop_events`` (the control-plane lease) has its queued events
    (``control_plane_lost``/``_regained``, ``shard_draining``,
    ``control_grace_exhausted``) re-emitted each tick as resilience events;
    one with ``degraded`` has every tick served on its cached grant counted
    (``rtap_obs_control_degraded_ticks_total``,
    ``stats["control_degraded_ticks"]``). `resume_suppression`: alert ids a
    promoted standby's dead leader already delivered (re-scored here, never
    re-written). `fleet` (fleet.FleetPublisher): told each tick's number.
    """
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1; got {pipeline_depth}")
    if micro_chunk < 1:
        raise ValueError(f"micro_chunk must be >= 1; got {micro_chunk}")
    if chunk_stagger and micro_chunk < 2:
        raise ValueError("chunk_stagger needs micro_chunk >= 2")
    if dispatch_threads < 1:
        raise ValueError(f"dispatch_threads must be >= 1; got {dispatch_threads}")
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
    # control-plane degradation accounting: armed only when the lease is
    # control-plane-backed (ControlLease exposes ``degraded``); a file lease
    # never counts here
    obs_control_degraded = None
    control_degraded_ticks = 0
    if lease is not None and hasattr(lease, "degraded"):
        obs_control_degraded = obs.counter(
            "rtap_obs_control_degraded_ticks_total",
            "ticks served on the cached control-plane lease while the "
            "plane was unreachable (bounded by the degraded grace "
            "window; >0 after an outage proves no tick stalled)")
    auto_registered = 0
    auto_rejected_total = 0
    auto_rejected: set = set()  # bounded de-dup memory, not the count
    auto_released = 0
    silent_ticks: dict = {}  # sid -> consecutive all-NaN ticks
    release_pending: set = set()
    writer = AlertWriter(alert_path, flush_every=alert_flush_every, attributor=attributor,
                         fence=lease.still_mine if lease is not None else None,
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
    if lease is not None:
        # freshness lives on the heartbeat thread (idempotent when the
        # caller started it); the loop only DETECTS the fence through the
        # cached still_mine() probe
        lease.start_heartbeat()
    if resume_suppression:
        # a promoted standby hands over the ids its dead leader delivered
        # for ticks the standby never received: re-scored here, they
        # suppress instead of duplicating
        writer.arm_suppression(set(resume_suppression))
    fenced = False
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
            if tracker is predictor:
                tracker.sink_batch = writer.emit_events
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
        """One save round at a drained instant (the sink flushed first, so
        each meta's alert cursor is the on-disk size) -> True iff every
        unquarantined group's save landed. A failed group save is evented
        and counted, never raised."""
        def _failed(gi, e):
            nonlocal checkpoint_save_failures
            checkpoint_save_failures += 1
            _res_event("checkpoint_save_failed", tick, group=gi,
                       error=f"{type(e).__name__}: {e}")

        writer.flush_sink()
        _saved, failed = _save_all(
            groups, checkpoint_dir, skip=quarantined, chaos=chaos, tick=tick,
            on_failure=_failed, alerts_offset=writer.sink_offset(),
            journal_tick=journal_base + ticks_run if journal is not None else None,
            save_seconds=group_saves)
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

    pool = None  # the dispatch/collect thread pool (dispatch_threads > 1)

    def _try_collect(item):
        """Collect one group's chunk, capturing its fault instead of letting
        it escape a pool thread -> (gi, result or None, exception or None);
        the quarantine happens after the join, on the loop's thread."""
        gi, h = item
        tg0 = time.perf_counter()
        try:
            if chaos is not None:
                chaos.on_collect(gi, cur_tick)
            return gi, groups[gi].collect_chunk(h), None
        except Exception as e:  # any fault isolates the group
            return gi, None, e
        finally:
            if trace is not None:
                trace.add_span("collect", cur_tick, tg0, time.perf_counter() - tg0, group=gi)

    def _collect_tick(ts_rows, value_rows, handles, rmaps, last_tick, idx=None):
        # collects (in the pool when there is one), then emission strictly
        # in group order, so the alert stream is schedule-independent.
        # `handles` align with `idx` (the dispatched class's groups; every
        # group when None). Quarantined groups (and the None handles of
        # failed dispatches) are skipped: their handles are dropped, never
        # waited on; a collect fault quarantines its group
        sel = range(len(groups)) if idx is None else idx
        t0 = time.perf_counter()
        pairs = [(gi, h) for gi, h in zip(sel, handles)
                 if gi not in quarantined and h is not None]
        outs = [_try_collect(p) for p in pairs] if pool is None \
            else list(pool.map(_try_collect, pairs))
        results: dict = {}
        for gi, res, exc in outs:
            if exc is not None:
                _quarantine_group(gi, cur_tick, "collect", exc)
            else:
                results[gi] = res
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
        cls = 0 if idx is None else class_of[idx[0]]
        collected_through[cls] = max(collected_through[cls], last_tick)
        live = [collected_through[c] for c in range(n_classes)
                if any(gi not in quarantined for gi in class_idx[c])]
        delivered = min(live, default=-1)
        if journal is not None and pairs and delivered >= 0:
            # the alert-delivery cursor: alerts through the named tick sit in
            # the sink below this offset (flushed first so it is on disk). A
            # hot standby prunes its buffered lines on it, so it names a
            # collected tick, not the loop's (at pipeline depth 2 the loop is
            # a tick ahead, and a leader killed between this record and the
            # next tick's emit would lose that tick's lines), and under
            # chunk_stagger the tick every phase class has collected through
            writer.flush_sink()
            journal.append_cursor(journal_base + delivered, writer.sink_offset())
        t2 = time.perf_counter()
        phase_s["emit"] += t2 - t1
        if trace is not None:
            trace.add_span("emit", cur_tick, t1, t2 - t1)

    # ---- the warm-up: every knowable program runs once on a throwaway
    # group before tick 0 (and before the journal replay), so no first
    # launch, first allocation or first pinned block lands in a scored tick
    aot_programs = 0
    aot_warmup_s = 0.0
    aot_launches = 0
    prewarmed: set = set()
    if aot_warmup:
        from rtap_tpu_torch.service.aot import prewarm

        t_warm = time.perf_counter()
        l_warm = tm_learn.launches
        prewarmed = prewarm(groups, micro_chunk, learn, degradation=degradation,
                            include_claim=auto_register or any(
                                g.free_slot_count() for g in groups))
        aot_programs = len(prewarmed)
        aot_warmup_s = time.perf_counter() - t_warm
        # the warm-up's launches are reported apart from the scored ticks'
        aot_launches = tm_learn.launches - l_warm
        launches0 += aot_launches
    # (chunk length m, group config, learn flag) of every program dispatched
    warmed: set = set(prewarmed)

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
                    warmed.add((1, grp.cfg, learn))
                    try:
                        h = grp.dispatch_chunk(v, t, learn=learn)
                        r_raw, r_ll, r_al = grp.collect_chunk(h)
                    except Exception as e:  # isolate the group
                        _quarantine_group(gi, jt, "journal_replay", e)
                        continue
                    learned_group_ticks += h["learned"]
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

    def _try_dispatch(gi, grp, v, t, learn_flag):
        """Dispatch one group's chunk, capturing its fault: a raising
        dispatch (a device error, an injected one) isolates that group
        after the join, never unwinds the tick -> (handle, exception)."""
        tg0 = time.perf_counter()
        try:
            if chaos is not None:
                chaos.on_dispatch(gi, cur_tick)
            return grp.dispatch_chunk(v, t, learn=learn_flag), None
        except Exception as e:  # any fault isolates the group
            return None, e
        finally:
            if trace is not None:
                # host enqueue time on cuda: the span never waits for the device
                trace.add_span("dispatch", cur_tick, tg0, time.perf_counter() - tg0, group=gi)

    def _dispatch_all(value_rows, ts_rows, rmaps, learn_flag, idx=None, row_ticks=()):
        """Dispatch every unquarantined group of `idx` (every group when
        None) -> handles aligned with `idx` (None for quarantined or faulted
        ones, which _collect_tick skips). The first dispatch of each (m,
        config, learn) program runs alone; the rest overlap in the pool. A
        dispatch fault quarantines its group after the join. The learned
        group-ticks are counted here, on the loop's thread, per row tick
        in `row_ticks` too (the schedule's per-tick learning groups)."""
        nonlocal learned_group_ticks
        sel = list(range(len(groups))) if idx is None else list(idx)
        m = len(value_rows)
        handles: list = [None] * len(sel)
        staged = []  # (handle index j, gi, grp, v, t)
        for j, gi in enumerate(sel):
            if gi in quarantined:
                continue
            grp = groups[gi]
            slots, _ids, off = rmaps[gi]
            # trailing field axis preserved: values may be [N] or [N, n_fields]
            v = np.full((m, grp.G) + value_rows[0].shape[1:], np.nan, np.float32)
            for i, row in enumerate(value_rows):
                v[i, slots] = row[off:off + len(slots)]
            t = np.repeat(np.asarray(ts_rows, np.int64)[:, None], grp.G, axis=1)
            staged.append((j, gi, grp, v, t))
        faults: list = []
        pooled: list = []
        for item in staged:
            j, gi, grp, v, t = item
            key = (m, grp.cfg, learn_flag)
            if pool is None or key not in warmed:
                # a program's first dispatch runs alone (its first launches
                # load the kernels' modules); the rest overlap in the pool
                warmed.add(key)
                handles[j], exc = _try_dispatch(gi, grp, v, t, learn_flag)
                if exc is not None:
                    faults.append((gi, exc))
            else:
                pooled.append(item)
        if pooled:
            outs = list(pool.map(lambda it: _try_dispatch(it[1], it[2], it[3], it[4],
                                                          learn_flag), pooled))
            for (j, gi, _grp, _v, _t), (h, exc) in zip(pooled, outs):
                handles[j] = h
                if exc is not None:
                    faults.append((gi, exc))
        for h in handles:
            if h is not None:
                learned_group_ticks += h["learned"]
                if schedule is not None:
                    for k_row, lrn_row in zip(row_ticks, h["learned_rows"]):
                        schedule["learning_groups"][k_row] += int(lrn_row)
        if schedule is not None:
            schedule["groups_dispatched"][cur_tick] += sum(h is not None for h in handles)
        for gi, exc in faults:
            _quarantine_group(gi, cur_tick, "dispatch", exc)
        return handles

    # chunk_stagger: group i belongs to phase class i mod M; each class keeps
    # its own buffer and pipeline and flushes on its own boundary (class c's
    # first chunk is c + 1 rows, then every M), so each tick dispatches
    # about 1/M of the groups instead of every group every M-th tick. Plain
    # serving is the single class 0
    n_classes = micro_chunk if chunk_stagger else 1
    class_idx = [[gi for gi in range(len(groups)) if gi % n_classes == c]
                 for c in range(n_classes)]
    class_of = [gi % n_classes for gi in range(len(groups))]
    in_flights: list[deque] = [deque() for _ in range(n_classes)]
    chunk_bufs: list[list] = [[] for _ in range(n_classes)]
    first_flush_done = [False] * n_classes
    # the loop tick each class has collected through (the alert cursor's)
    collected_through = [-1] * n_classes
    # per tick: groups dispatched, groups whose pass ran for that tick's
    # row, kernel launches, dispatch ms (chunk_stagger only)
    schedule = {key: [0] * n_ticks for key in ("groups_dispatched", "learning_groups",
                                                "kernel_launches")} if chunk_stagger else None
    if schedule is not None:
        schedule["dispatch_ms"] = [0.0] * n_ticks

    def _drain():
        for c in range(n_classes):
            while in_flights[c]:
                _collect_tick(*in_flights[c].popleft())

    def _align_boundaries():
        """A nothing-buffered, nothing-in-flight instant (membership changes,
        restores and checkpoints need one): flush every class's partial
        chunk and drain; under chunk_stagger the ramp then restarts (its
        partial lengths 1..M are programs the warm-up knows)."""
        for c in range(n_classes):
            if chunk_bufs[c]:
                _flush(c)
        _drain()
        if chunk_stagger:
            for c in range(n_classes):
                first_flush_done[c] = False

    def _flush(c):
        buf = chunk_bufs[c]
        vrows = [b[0] for b in buf]
        tsrows = [b[1] for b in buf]
        row_ticks = [b[2] for b in buf]
        last_tick = row_ticks[-1]  # the loop tick of the chunk's last row
        buf.clear()
        first_flush_done[c] = True
        if not class_idx[c]:
            return  # more classes than groups: nothing to dispatch
        # the degradation ladder removes learning per chunk at dispatch time
        # (level 1 thins, level >= 2 freezes); it never adds it
        lrn = learn and (degradation is None or degradation.learn_allowed(cur_tick))
        now = time.perf_counter()
        idx = None if n_classes == 1 else class_idx[c]
        handles = _dispatch_all(vrows, tsrows, routing, lrn, idx, row_ticks)
        t1 = time.perf_counter()
        phase_s["dispatch"] += t1 - now
        if trace is not None:
            trace.add_span("dispatch", cur_tick, now, t1 - now)
        in_flights[c].append((tsrows, vrows, handles, routing, last_tick, idx))
        while len(in_flights[c]) >= pipeline_depth:
            _collect_tick(*in_flights[c].popleft())

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

    # one pool for the whole loop; None is the serial schedule (1 group or 1
    # thread), bit-identical to it by test
    eff_threads = 1
    if dispatch_threads > 1 and len(groups) > 1:
        eff_threads = min(dispatch_threads, len(groups))
        pool = ThreadPoolExecutor(max_workers=eff_threads,
                                  thread_name_prefix="rtap-loop-dispatch")
    try:
        for k in range(n_ticks):
            # orderly shutdown: finish between ticks, save final state, report
            if stop_event is not None and stop_event.is_set():
                break
            pop_events = getattr(lease, "pop_events", None)
            if pop_events is not None:
                # lease-lifecycle events queued by the backend (control plane
                # lost/regained, drain marks) ride the same counters, trace
                # and alert stream as every other resilience event
                for ev_kind, ev_fields in pop_events():
                    _res_event(ev_kind, k, **ev_fields)
            if obs_control_degraded is not None and lease.degraded:
                # this tick runs on the cached grant: no reachable plane
                obs_control_degraded.inc()
                control_degraded_ticks += 1
            if lease is not None and not lease.still_mine():
                # fenced: a standby promoted past our epoch while this
                # process was paused (or the control plane stayed away past
                # its grace). Stop scoring and emitting — the new leader
                # owns the stream; our unsaved ticks are its journal's to
                # replay, not ours to deliver twice
                fenced = True
                if pop_events is not None:
                    # the probe that found the fence may have queued its own
                    # story (grace exhausted): flush it first
                    for ev_kind, ev_fields in pop_events():
                        _res_event(ev_kind, k, **ev_fields)
                _res_event("leader_fenced", k, epoch=int(lease.epoch),
                           holder=str(lease.holder() or ""))
                break
            cur_tick = k
            if chaos is not None:
                chaos.set_tick(k)
            t_start = time.perf_counter()
            launches_tick0 = tm_learn.launches
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
            if auto_register and reg is not None \
                    and (not any(chunk_bufs) or chunk_stagger) \
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
            if release_pending and (not any(chunk_bufs) or chunk_stagger):
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
            row = (values.copy() if pipeline_depth > 1 or micro_chunk > 1 else values, ts, k)
            for c in range(n_classes):
                chunk_bufs[c].append(row)
                # a staggered class's first flush comes at c + 1 rows, which
                # tiles the classes' boundaries across ticks; then every M
                target = micro_chunk if first_flush_done[c] or not chunk_stagger else c + 1
                if len(chunk_bufs[c]) >= target or k + 1 == n_ticks:
                    _flush(c)
            if correlator is not None:
                # after this tick's emission: close quiesced windows on the
                # source clock (alerts lagging in the pipeline carry their own
                # older ts; --correlate-window must exceed that staleness)
                correlator.on_tick(ts, tick=k, sink_offset=writer.sink_offset())
            ticks_run = k + 1
            if learn and checkpoint_every and checkpoint_dir \
                    and (not any(chunk_bufs) or chunk_stagger) \
                    and ticks_run - last_saved >= checkpoint_every \
                    and (lease is None or lease.still_mine()):
                # due-since-last-save, not a modulus: with micro_chunk > 1
                # boundaries land only at multiples of M (under chunk_stagger
                # the save realigns every class's boundary). The lease gate
                # keeps a paused old leader that woke mid-tick from
                # clobbering the promoted standby's checkpoints
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
            if schedule is not None:
                schedule["kernel_launches"][k] = tm_learn.launches - launches_tick0
                schedule["dispatch_ms"][k] = round(deltas["dispatch"] * 1e3, 3)
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
            if fleet is not None:
                # one guarded int store; the pushes run on the publisher's
                # own thread, never on the tick path
                fleet.note_tick(k)
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
        for c in range(n_classes):
            if chunk_bufs[c]:
                _flush(c)  # early stop mid-chunk: score what was ingested
        _drain()
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        if flight is not None:
            # a quarantine raised by the final drain (or an early stop)
            # queued its dump after the last in-loop flush
            flight.flush_pending()
    if learn and checkpoint_dir and not fenced \
            and (lease is None or lease.still_mine()) \
            and (ticks_run > last_saved or journal_replay["replayed_ticks"] > 0):
        # final state on exit (clean or stopped): a resume must not lose
        # learned ticks; frozen serving never writes its checkpoint dir, nor
        # does a fenced leader (the shared dir is the promoted standby's).
        # Bypasses the breaker (one last best-effort save)
        if _save_round(ticks_run):
            checkpoints_saved += 1
            _compact()
    writer.close()

    stats = {**counter.stats(), "alerts": writer.count, "missed_deadlines": missed,
             "missing_values": missing_values,
             "ticks": ticks_run, "cadence_s": cadence_s, "n_groups": len(groups),
             "pipeline_depth": pipeline_depth, "micro_chunk": micro_chunk,
             "chunk_stagger": chunk_stagger, "learn": learn,
             # the effective worker count: 1 when no pool was made
             "dispatch_threads": eff_threads}
    if aot_warmup:
        stats["aot_programs_compiled"] = aot_programs
        # programs the loop dispatched that the warm-up did not know: 0
        # unless the knowable-program enumeration missed one
        # (the card's groups only: the warm-up skips CPU groups, which load
        # no device modules)
        dev_cfgs = [g.cfg for g in groups if g.device.type == "cuda"]
        stats["cold_compiles_after_warmup"] = sum(
            1 for key in warmed - prewarmed if key[1] in dev_cfgs)
        stats["aot_warmup_s"] = round(aot_warmup_s, 4)
        stats["aot_kernel_launches"] = aot_launches
    if schedule is not None:
        stats["schedule"] = {key: v[:ticks_run] for key, v in schedule.items()}
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
    if fenced:
        # the fence story lives in stats and counters, never on the sink (a
        # fenced leader appends nothing)
        stats["fenced"] = True
        stats["fenced_line_drops"] = writer.fenced_drops
    if obs_control_degraded is not None:
        stats["control_degraded_ticks"] = control_degraded_ticks
    if ticks_run > 0:
        stats["phase_ms_per_tick"] = {p: round(v / ticks_run * 1e3, 2)
                                      for p, v in phase_s.items()}
        used = latencies[:ticks_run]
        for p in (50, 90, 99):
            stats[f"latency_p{p}_ms"] = round(float(np.percentile(used, p)) * 1e3, 3)
        stats["latency_max_ms"] = round(float(used.max()) * 1e3, 3)
        # the first tick's own ms: what the warm-up exists to bring under
        # the cadence
        stats["tick0_ms"] = round(float(used[0]) * 1e3, 3)
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


def _save_all(groups, checkpoint_dir: str, skip=(), chaos=None, tick: int = 0,
              on_failure=None, alerts_offset: int | None = None,
              journal_tick: int | None = None, save_seconds: list | None = None
              ) -> tuple[int, int]:
    """One atomic save per group into its dir (``group{i:04d}``) -> (saved,
    failed). Quarantined groups (`skip`) are not saved: their state may be
    mid-chunk and their last good checkpoint is the restore source.
    Failures are contained per group — reported through `on_failure`, never
    raised — because a full disk must not kill scoring, and save_group's
    temp-sibling atomicity keeps the previous checkpoint intact. The live
    loop's save rounds and a promoting standby's takeover checkpoint
    (resilience/replicate.py) both save through it; `save_seconds` collects
    each landed group save's wall seconds."""
    saved = failed = 0
    for gi, grp in enumerate(groups):
        if gi in skip:
            continue
        try:
            if chaos is not None:
                chaos.on_checkpoint_save(gi, tick)
            t_save = time.perf_counter()
            save_group(grp, group_checkpoint_path(checkpoint_dir, gi),
                       alerts_offset=alerts_offset, journal_tick=journal_tick)
            if save_seconds is not None:
                save_seconds.append(time.perf_counter() - t_save)
            saved += 1
        except Exception as e:  # contained per group: the disk, not the loop
            failed += 1
            if on_failure is not None:
                on_failure(gi, e)
    return saved, failed


def _occupancy(groups) -> dict:
    """Device memory of the groups' card for the stats (empty on the CPU):
    ``hbm_bytes_in_use`` / ``hbm_peak_bytes_in_use``, the JAX package's
    keys, from the caching allocator."""
    devs = {g.device for g in groups if g.device.type == "cuda"}
    if not devs:
        return {}
    return {"hbm_bytes_in_use": sum(torch.cuda.memory_allocated(d) for d in devs),
            "hbm_peak_bytes_in_use": sum(torch.cuda.max_memory_allocated(d) for d in devs)}
