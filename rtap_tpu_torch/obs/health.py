"""Host-side model-health tracking: scorecards, drift, incidents.

The port's copy of the JAX package's ``obs/health.py`` (its build-info
gauge belongs to the observability slice). The step's on-device reducers
(ops/health.py) hand the loop one small aggregate leaf per (group, tick).
This module folds those into:

- **Per-group scorecards** — segment-pool occupancy (fraction +
  histogram), synapse-pool fill and permanence sketch, active-column /
  predictive-cell sparsity, predicted->active hit rate, and streaming
  anomaly-score quantiles from an EWMA'd score histogram.
- **EWMA drift detection** on the score distribution: a fast and a slow
  exponentially-weighted histogram per group; their total-variation
  distance is the drift metric. A detector whose score distribution
  walks away from its own baseline is degrading even when every tick
  hits its deadline.
- **Health-state events** on the incident stream (same contract as the
  watchdog/resilience events): ``pool_saturated``,
  ``sparsity_collapsed``, ``score_drift`` — edge-triggered with
  hysteresis, each also requesting a flight-recorder postmortem dump
  (a health incident is a black-box moment like a quarantine).
- **Registry gauges** (fleet rollups in the telemetry snapshot) and the
  JSON body the JAX package serves at ``GET /health`` (the port's routes
  and flight recorder come with the observability slice; until then
  ``flight`` stays None and dump requests are dropped).

Thread model: :meth:`fold` is called from the serve loop thread only
(emission is single-threaded by contract); :meth:`snapshot` may be
called concurrently by the obs HTTP server — like ``/trace``, the read
is point-in-time diagnostic data, not a consistent cut.

Also here: :func:`bump_run_epoch`, the restart-continuity counter. A
supervised serve child resets every in-process
counter when it restarts; the run epoch is persisted beside the
incident stream and bumped once per process start, so dashboards can
tell a restart reset from a counter rollover via the
``rtap_obs_run_epoch`` gauge.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from rtap_tpu_torch.obs.metrics import TelemetryRegistry, get_registry
from rtap_tpu_torch.ops.health import OCC_BINS, PERM_BINS, SCORE_BINS

__all__ = ["HealthTracker", "bump_run_epoch"]

#: health-state event vocabulary (docs/TELEMETRY.md, docs/POSTMORTEM.md)
HEALTH_EVENTS = ("pool_saturated", "sparsity_collapsed", "score_drift")


class _GroupHealth:
    """One group's folded health state (bounded: a few fixed vectors)."""

    __slots__ = ("ticks", "ticks_scored", "last", "hit_num", "hit_den",
                 "fast", "slow", "drift_tvd", "drifting", "saturated",
                 "collapsed", "last_tick")

    def __init__(self):
        self.ticks = 0          # health leaves folded
        self.ticks_scored = 0   # leaves with at least one scored stream
        self.last: dict = {}    # latest per-tick scalar/vector values
        self.hit_num = 0.0      # cumulative predicted->active numerator
        self.hit_den = 0.0
        self.fast = np.zeros(SCORE_BINS, np.float64)  # EWMA'd score dist
        self.slow = np.zeros(SCORE_BINS, np.float64)  # the baseline
        self.drift_tvd = 0.0
        self.drifting = False
        self.saturated = False
        self.collapsed = False
        self.last_tick = -1


class HealthTracker:
    """Folds per-(group, tick) health leaves into fleet scorecards.

    Construction registers the fleet gauges once; :meth:`fold` is the
    only hot-path call (one per collected chunk per group — a few
    numpy ops over ~40-element vectors).

    `sink` (callable taking one JSON-able event dict) and `flight`
    (obs.FlightRecorder) may be attached after construction —
    ``live_loop`` wires the alert-stream writer and the flight recorder
    in, exactly like the watchdog and the degradation controller.
    """

    def __init__(self, cfg, registry: TelemetryRegistry | None = None,
                 sink=None, flight=None,
                 occupancy_threshold: float = 0.9,
                 sparsity_min_frac: float = 0.5,
                 drift_threshold: float = 0.25,
                 drift_min_ticks: int = 120,
                 alpha_fast: float = 0.1, alpha_slow: float = 0.01,
                 warmup_ticks: int = 16):
        if not (0.0 < occupancy_threshold <= 1.0):
            raise ValueError(
                f"occupancy_threshold must be in (0, 1]; got "
                f"{occupancy_threshold}")
        if not (0.0 <= sparsity_min_frac < 1.0):
            raise ValueError(
                f"sparsity_min_frac must be in [0, 1); got "
                f"{sparsity_min_frac}")
        if not (0.0 < drift_threshold <= 1.0):
            raise ValueError(
                f"drift_threshold must be in (0, 1]; got {drift_threshold}")
        if drift_min_ticks < 1:
            raise ValueError(
                f"drift_min_ticks must be >= 1; got {drift_min_ticks}")
        if not (0.0 < alpha_slow <= alpha_fast <= 1.0):
            raise ValueError(
                "need 0 < alpha_slow <= alpha_fast <= 1; got "
                f"{alpha_slow}, {alpha_fast}")
        self.cfg = cfg
        # the healthy active-column fraction: inhibition selects exactly
        # k winners whenever input drives any column past the stimulus
        # threshold, so a LIVE stream far below k/C has a starved SP —
        # the sparsity-collapse signal (SDR theory: sparsity carries the
        # representation; a collapsed SDR can't discriminate patterns)
        self.expected_active_frac = (
            cfg.sp.num_active_columns / cfg.sp.columns)
        self.occupancy_threshold = float(occupancy_threshold)
        self.sparsity_min_frac = float(sparsity_min_frac)
        self.drift_threshold = float(drift_threshold)
        self.drift_min_ticks = int(drift_min_ticks)
        self.alpha_fast = float(alpha_fast)
        self.alpha_slow = float(alpha_slow)
        self.warmup_ticks = int(warmup_ticks)
        self.sink = sink
        self.flight = flight
        self._groups: dict[int, _GroupHealth] = {}
        self.events_total = 0
        self._events_by_kind: dict[str, int] = {}
        reg = registry or get_registry()
        self._obs_events = {
            kind: reg.counter(
                "rtap_obs_health_events_total",
                "model-health incidents by kind (pool_saturated / "
                "sparsity_collapsed / score_drift)", event=kind)
            for kind in HEALTH_EVENTS
        }
        self._obs_occ = reg.gauge(
            "rtap_obs_health_pool_occupancy_max",
            "worst per-group mean segment-pool occupancy fraction "
            "(ROADMAP-3 right-sizing signal)")
        self._obs_hit = reg.gauge(
            "rtap_obs_health_hit_rate",
            "fleet predicted->active column hit rate (cumulative "
            "mean; 1 - raw anomaly score weighted by active columns)")
        self._obs_sparsity = reg.gauge(
            "rtap_obs_health_active_col_frac",
            "fleet mean active-column fraction at the latest folded tick")
        self._obs_drift = reg.gauge(
            "rtap_obs_health_score_drift_max",
            "worst per-group score-distribution drift (total-variation "
            "distance between the fast and slow EWMA histograms)")
        self._obs_drifting = reg.gauge(
            "rtap_obs_health_groups_drifting",
            "groups currently past the score-drift threshold")
        self._obs_fold_seconds = reg.histogram(
            "rtap_obs_health_fold_seconds",
            "wall seconds per HealthTracker.fold call (one per collected "
            "chunk per group)")

    # ------------------------------------------------------------ fold --
    def fold(self, group: int, leaves: dict, tick: int = -1) -> None:
        """Fold one collected chunk's health leaves ([T, ...] arrays from
        ``StreamGroup.last_health``) into group `group`'s scorecard and
        evaluate the health-state conditions once per call."""
        t0 = time.perf_counter()
        g = self._groups.get(group)
        if g is None:
            g = self._groups[group] = _GroupHealth()
        scored = np.atleast_1d(np.asarray(leaves["scored"]))
        hists = np.atleast_2d(np.asarray(leaves["score_hist"], np.float64))
        hit_num = np.atleast_1d(np.asarray(leaves["hit_num"], np.float64))
        hit_den = np.atleast_1d(np.asarray(leaves["hit_den"], np.float64))
        af, asl = self.alpha_fast, self.alpha_slow
        for i in range(len(scored)):
            g.ticks += 1
            n = float(scored[i])
            if n > 0:
                p = hists[i] / n
                if g.ticks_scored == 0:
                    g.fast[:] = p
                    g.slow[:] = p
                else:
                    g.fast += af * (p - g.fast)
                    g.slow += asl * (p - g.slow)
                g.ticks_scored += 1
        g.hit_num += float(hit_num.sum())
        g.hit_den += float(hit_den.sum())
        # scorecard state + condition checks track the latest tick that
        # actually SCORED live streams: an all-NaN outage tick reduces
        # every live-masked mean to 0, and adopting those zeros would
        # both report false health (occupancy "dropping" to 0 during a
        # source outage) and reset the saturation edge-trigger so the
        # incident re-fires on every source recovery (flap storm)
        live_idx = np.nonzero(scored > 0)[0]
        g.last_tick = int(tick)
        if live_idx.size:
            i = int(live_idx[-1])
            g.last = {
                "occ_hist": [int(x)
                             for x in np.asarray(leaves["occ_hist"])[i]],
                "seg_occ_frac": float(
                    np.asarray(leaves["seg_occ_frac"])[i]),
                "syn_frac": float(np.asarray(leaves["syn_frac"])[i]),
                "perm_hist": [round(float(x), 6)
                              for x in np.asarray(leaves["perm_hist"])[i]],
                "perm_conn_frac": float(
                    np.asarray(leaves["perm_conn_frac"])[i]),
                "act_col_frac": float(
                    np.asarray(leaves["act_col_frac"])[i]),
                "pred_cell_frac": float(
                    np.asarray(leaves["pred_cell_frac"])[i]),
                "scored": int(scored[i]),
            }
            self._evaluate(group, g, tick)
        self._set_fleet_gauges()
        self._obs_fold_seconds.observe(time.perf_counter() - t0)

    # ------------------------------------------------- incident logic --
    def _event(self, kind: str, tick: int, group: int, **fields) -> None:
        self.events_total += 1
        self._events_by_kind[kind] = self._events_by_kind.get(kind, 0) + 1
        self._obs_events[kind].inc()
        ev = {"event": kind, "tick": int(tick), "group": int(group),
              **fields}
        if self.flight is not None:
            # a health incident is a black-box moment like a quarantine:
            # capture the window that led here (queued; the loop writes
            # it after deadline accounting, throttled per reason)
            self.flight.record_event(ev)
            self.flight.request_dump(kind, tick)
        if self.sink is not None:
            self.sink(ev)

    def _evaluate(self, gi: int, g: _GroupHealth, tick: int) -> None:
        """Edge-triggered conditions with hysteresis: each fires once on
        entry and re-arms only after the metric clears a margin below its
        threshold (a value oscillating at the line must not storm the
        incident stream)."""
        occ = g.last.get("seg_occ_frac", 0.0)
        if not g.saturated and occ >= self.occupancy_threshold:
            g.saturated = True
            self._event("pool_saturated", tick, gi, occupancy=round(occ, 4),
                        threshold=self.occupancy_threshold,
                        occ_hist=g.last.get("occ_hist"))
        elif g.saturated and occ < 0.9 * self.occupancy_threshold:
            g.saturated = False
        act = g.last.get("act_col_frac", 0.0)
        floor = self.sparsity_min_frac * self.expected_active_frac
        # only judged on ticks that scored live streams, past the model's
        # bring-up window (an empty fleet or tick 0 has nothing to say)
        if g.last.get("scored", 0) > 0 and g.ticks >= self.warmup_ticks:
            if not g.collapsed and act < floor:
                g.collapsed = True
                self._event(
                    "sparsity_collapsed", tick, gi,
                    active_col_frac=round(act, 5),
                    expected_frac=round(self.expected_active_frac, 5),
                    floor=round(floor, 5))
            elif g.collapsed and act >= min(
                    1.25 * floor, self.expected_active_frac):
                g.collapsed = False
        tvd = 0.0
        if g.ticks_scored >= self.drift_min_ticks:
            tvd = 0.5 * float(np.abs(g.fast - g.slow).sum())
        g.drift_tvd = tvd
        if not g.drifting and tvd >= self.drift_threshold:
            g.drifting = True
            self._event("score_drift", tick, gi, tvd=round(tvd, 4),
                        threshold=self.drift_threshold,
                        quantiles=self._quantiles(g.fast),
                        baseline_quantiles=self._quantiles(g.slow))
        elif g.drifting and tvd < 0.5 * self.drift_threshold:
            g.drifting = False

    def _set_fleet_gauges(self) -> None:
        gs = list(self._groups.values())
        if not gs:
            return
        self._obs_occ.set(max(
            (g.last.get("seg_occ_frac", 0.0) for g in gs), default=0.0))
        den = sum(g.hit_den for g in gs)
        self._obs_hit.set(sum(g.hit_num for g in gs) / den if den else 0.0)
        self._obs_sparsity.set(
            float(np.mean([g.last.get("act_col_frac", 0.0) for g in gs])))
        self._obs_drift.set(max((g.drift_tvd for g in gs), default=0.0))
        self._obs_drifting.set(sum(1 for g in gs if g.drifting))

    # -------------------------------------------------------- surface --
    @staticmethod
    def _quantiles(hist: np.ndarray) -> dict:
        """p50/p90/p99 of the score distribution from a (possibly
        unnormalized) histogram over [0, 1]: linear interpolation inside
        the crossing bin."""
        total = float(hist.sum())
        if total <= 0:
            return {"p50": None, "p90": None, "p99": None}
        cum = np.cumsum(hist) / total
        out = {}
        for name, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            b = int(np.searchsorted(cum, q))
            b = min(b, SCORE_BINS - 1)
            prev = float(cum[b - 1]) if b else 0.0
            span = float(cum[b]) - prev
            frac = (q - prev) / span if span > 0 else 0.5
            out[name] = round((b + frac) / SCORE_BINS, 4)
        return out

    def scorecard(self, gi: int) -> dict:
        """One group's JSON scorecard (the /health per-group unit)."""
        g = self._groups[gi]
        hit = g.hit_num / g.hit_den if g.hit_den else None
        problems = [k for k, v in (("pool_saturated", g.saturated),
                                   ("sparsity_collapsed", g.collapsed),
                                   ("score_drift", g.drifting)) if v]
        return {
            "group": int(gi),
            "ticks": g.ticks,
            "last_tick": g.last_tick,
            "occupancy": {
                "frac": round(g.last.get("seg_occ_frac", 0.0), 6),
                "hist": g.last.get("occ_hist", [0] * OCC_BINS),
                "bins": OCC_BINS,
            },
            "synapses": {
                "fill_frac": round(g.last.get("syn_frac", 0.0), 6),
                "connected_frac": round(
                    g.last.get("perm_conn_frac", 0.0), 6),
                "perm_hist": g.last.get("perm_hist", [0.0] * PERM_BINS),
                "bins": PERM_BINS,
            },
            "sparsity": {
                "active_col_frac": round(
                    g.last.get("act_col_frac", 0.0), 6),
                "pred_cell_frac": round(
                    g.last.get("pred_cell_frac", 0.0), 6),
                "expected_active_frac": round(
                    self.expected_active_frac, 6),
            },
            "hit_rate": None if hit is None else round(hit, 6),
            "score": {
                "hist": [round(float(x), 6) for x in g.fast],
                "bins": SCORE_BINS,
                "quantiles": self._quantiles(g.fast),
                "drift_tvd": round(g.drift_tvd, 6),
                "drifting": g.drifting,
            },
            "verdict": "ok" if not problems else ",".join(problems),
        }

    def snapshot(self) -> dict:
        """The GET /health body: fleet rollup + per-group scorecards.
        The JAX package's schema."""
        # copy before iterating: the obs-server thread snapshots while
        # the loop thread's fold() may insert a just-claimed group's
        # slot (dict-size-changed RuntimeError otherwise — torn VALUES
        # are the documented contract, exceptions are not)
        gids = sorted(list(self._groups))
        gvals = list(self._groups.values())
        groups = [self.scorecard(gi) for gi in gids]
        den = sum(g.hit_den for g in gvals)
        num = sum(g.hit_num for g in gvals)
        attention = [g["group"] for g in groups if g["verdict"] != "ok"]
        return {
            "fleet": {
                "groups": len(groups),
                "ticks_folded": sum(g["ticks"] for g in groups),
                "pool_occupancy_max": max(
                    (g["occupancy"]["frac"] for g in groups), default=0.0),
                "hit_rate": round(num / den, 6) if den else None,
                "active_col_frac_mean": round(float(np.mean(
                    [g["sparsity"]["active_col_frac"] for g in groups])), 6)
                if groups else 0.0,
                "score_drift_max": max(
                    (g["score"]["drift_tvd"] for g in groups), default=0.0),
                "groups_attention": attention,
                "events_total": self.events_total,
                "events_by_kind": dict(sorted(self._events_by_kind.items())),
                "verdict": "ok" if not attention else "attention",
            },
            "groups": groups,
        }

    def stats(self) -> dict:
        """End-of-run accounting for the loop's stats dict (compact)."""
        snap_fleet = self.snapshot()["fleet"] if self._groups else {}
        return {
            "groups": len(self._groups),
            "ticks_folded": sum(
                g.ticks for g in list(self._groups.values())),
            "events": dict(sorted(self._events_by_kind.items())),
            **({"verdict": snap_fleet.get("verdict"),
                "pool_occupancy_max": snap_fleet.get("pool_occupancy_max"),
                "hit_rate": snap_fleet.get("hit_rate"),
                "score_drift_max": snap_fleet.get("score_drift_max")}
               if snap_fleet else {}),
        }


def bump_run_epoch(beside_path: str | None,
                   registry: TelemetryRegistry | None = None) -> int:
    """Increment and persist the run epoch; set ``rtap_obs_run_epoch``.

    The epoch lives in ``<beside_path>.epoch`` — beside the incident
    stream (the serve ``--alerts`` file), the one artifact a supervised
    restart chain shares. Each serve process start reads, increments,
    and atomically rewrites it, so the gauge is monotonic across
    restarts while every other counter resets with the process —
    dashboards join on it to tell restarts from rollovers. Returns the
    epoch (1-based; 0 when there is no path to persist beside —
    in-process-only serves have nothing to be continuous with).
    Corrupt/unreadable epoch files restart the count at 1, loudly never:
    continuity is best-effort diagnostics, not durability.
    """
    epoch = 0
    if beside_path:
        from rtap_tpu_torch.service.shardpath import alert_sidecar_path

        path = alert_sidecar_path(beside_path, "epoch")
        try:
            with open(path) as f:
                epoch = int(json.load(f).get("epoch", 0))
        except (OSError, ValueError, AttributeError, TypeError):
            epoch = 0
        epoch += 1
        try:
            d = os.path.dirname(os.path.abspath(path))
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"epoch": epoch, "pid": os.getpid(),
                           "wall_time": time.time()}, f)
            os.replace(tmp, path)
        except OSError:
            pass  # the gauge still carries this process's view
    (registry or get_registry()).gauge(
        "rtap_obs_run_epoch",
        "monotonic serve run epoch (persisted beside the incident "
        "stream; bumped once per process start so dashboards can tell "
        "supervisor-restart counter resets from rollovers)").set(epoch)
    return epoch


def config_digest(config) -> str:
    """Stable short digest of a (nested, frozen-dataclass) config.

    Two serves score identically only if their configs match; the digest
    makes that comparable across the fleet without shipping the whole
    config. json with sorted keys over ``dataclasses.asdict`` is the
    canonical form; 12 hex chars is plenty for a label value.
    """
    import dataclasses
    import hashlib

    body = dataclasses.asdict(config) if dataclasses.is_dataclass(config) \
        else config
    canon = json.dumps(body, sort_keys=True, default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:12]


def set_build_info(*, role: str, shard: int, run_epoch: int,
                   config, registry: TelemetryRegistry | None = None) -> str:
    """Set the always-on ``rtap_obs_build_info`` identity gauge (value 1).

    The info-gauge idiom: identity rides the LABELS (role, shard,
    run_epoch, config_hash), the value is constant 1, so every scrape and
    snapshot carries who this process is — dashboards join per-member
    series on it instead of guessing identity from ports. Returns the
    config hash (the JAX package's for an equal config). ``config`` may be
    a config dataclass or an already-computed hash string.
    """
    config_hash = config if isinstance(config, str) else \
        config_digest(config)
    (registry or get_registry()).gauge(
        "rtap_obs_build_info",
        "constant-1 identity gauge; the labels carry who this process "
        "is (role, shard, run_epoch, config_hash) so per-member series "
        "join without port-guessing",
        role=str(role), shard=str(int(shard)),
        run_epoch=str(int(run_epoch)), config_hash=config_hash).set(1)
    return config_hash
