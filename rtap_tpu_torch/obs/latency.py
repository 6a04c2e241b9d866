"""Detection-latency observability: quantile sketches + stage waterfalls.

The port's copy of the JAX package's ``obs/latency.py`` (same sketch
edges, so the same observations give the same quantiles). The product
claim is *real-time* anomaly prediction: the time from a metric row's
SOURCE timestamp to the alert line that names it. This module is the
measurement substrate:

- :class:`QuantileSketch` — a bounded, lock-free, log-bucketed sketch
  with **windowed** p50/p95/p99/p99.9 extraction, in the style of
  obs/metrics.py's Histogram (per-writer-thread shards, bisect over a
  plain-float edge list, in-place numpy int64 increments — O(log n)
  observe, allocation-free after a thread's first observe). Unlike the
  registry Histogram it keeps a rolling window (current + previous) next
  to the lifetime totals, so ``GET /latency`` answers "what is p99 NOW",
  not "since process start".
- :class:`LatencyTracker` — the per-tick stage-waterfall fold: source
  ts → ingest arrival / backfill release → dispatch → collect →
  alert-sink flush, one sketch per stage, plus first-class lag gauges
  (replication-ack lag, incident-close lag) polled from providers the
  CLI wires in. The end-to-end ``detect`` sketch is fed per ALERT by
  AlertWriter at sink-write time — wall clock minus the row's source
  timestamp, so pipeline depth, micro-chunk staleness and backfill hold
  all show up honestly. Zero extra device↔host fetches and no device
  synchronisation: every input is a host-side wall clock or a timestamp
  already riding the rows.

With the flag off nothing here is constructed and the serve path is
byte/bit-identical to a flagless run. Armed, the hot-path cost is gated
<= 1% of the tick budget next to the other obs instruments
(obs/selfbench.measure_latency).

Clock contract: ``detect`` compares the host wall clock against the
row's source timestamp, so it is meaningful when producers stamp rows
with (approximately) synchronized wall clocks — the serve deployment
shape. Seeded soaks on a synthetic epoch (crash/failover) declare
``tick=...`` SLOs instead (docs/SLO.md).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left

import numpy as np

from rtap_tpu_torch.obs.metrics import TelemetryRegistry, get_registry

__all__ = ["QuantileSketch", "LatencyTracker", "STAGES", "DEFAULT_QS"]

#: the per-tick waterfall stages, in pipeline order. ``ingest`` is the
#: source-ts -> loop-poll lag (wire transit + any backfill hold);
#: ``dispatch``/``collect``/``emit`` are the loop's own phase deltas;
#: ``tick`` is the whole host tick; ``detect`` is the per-alert e2e.
STAGES = ("ingest", "dispatch", "collect", "emit", "tick", "detect")

#: the standard extraction points
DEFAULT_QS = (0.5, 0.95, 0.99, 0.999)


def qlabel(q: float) -> str:
    """THE quantile label (0.99 -> "p99", 0.999 -> "p99.9") — one
    formatter shared by the sketch's JSON keys, the detect-quantile
    gauge labels, and SloSpec.label, so the snapshot path and the live
    routes can never disagree on a name."""
    return f"p{round(q * 100, 4):g}"


def _edges(lo: float, hi: float, per_decade: int) -> tuple[float, ...]:
    n = int(round(np.log10(hi / lo) * per_decade))
    e = lo * (10.0 ** (np.arange(n + 1) / per_decade))
    e[-1] = max(e[-1], hi)
    return tuple(float(x) for x in e)


class _SketchShard:
    """One writer thread's private window/total counts (no cross-thread
    writes; readers sum — the obs/metrics.py sharding idiom)."""

    __slots__ = ("cur", "prev", "total", "sum", "max")

    def __init__(self, n: int):
        self.cur = np.zeros(n, np.int64)
        self.prev = np.zeros(n, np.int64)
        self.total = np.zeros(n, np.int64)
        self.sum = 0.0
        self.max = 0.0


class QuantileSketch:
    """Bounded log-bucketed quantile sketch with a rolling window.

    Buckets are geometric (default 0.1 ms .. 100 s at ``per_decade=20``
    — a 12% ratio per bucket, so an interpolated quantile is within one
    bucket ratio of the exact order statistic; the fuzz test pins it
    against ``numpy.percentile``). Values below the range clamp into the
    first bucket, values at/above it into the overflow bucket (whose
    quantiles report the top edge — saturation, never a lie about
    resolution the sketch doesn't have). Negative inputs clamp to 0.

    ``observe`` is lock-free (per-thread shards); ``roll()`` — called by
    the single owner thread at window boundaries — retires the current
    window to ``prev``, so windowed extraction always covers between one
    and two windows of history (never a just-emptied array).
    """

    def __init__(self, lo: float = 1e-4, hi: float = 100.0,
                 per_decade: int = 20):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi; got lo={lo}, hi={hi}")
        if per_decade < 1:
            raise ValueError(f"per_decade must be >= 1; got {per_decade}")
        # geometry kept verbatim so state()/from_state() round-trips
        # rebuild bit-identical edge arrays (merge requires identity)
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        self.edges = _edges(lo, hi, per_decade)
        self._edges_list = list(self.edges)
        self._edges_arr = np.asarray(self.edges)  # searchsorted target
        # (cached like _edges_list: observe_many sits on the per-alert
        # hot path and must not re-materialize the tuple per call)
        self._n = len(self.edges) + 1  # + overflow
        self._shards: dict[int, _SketchShard] = {}
        self.rolls = 0

    def _shard_list(self) -> list:
        """Point-in-time shard list, tolerating a brand-new writer
        thread's first observe resizing the dict mid-iteration (the
        obs/metrics.py retry idiom; read-only either way)."""
        for _ in range(8):
            try:
                return list(self._shards.values())
            except RuntimeError:
                continue
        return list(dict(self._shards).values())

    def observe(self, v: float) -> None:
        shard = self._shards.get(threading.get_ident())
        if shard is None:
            shard = self._shards.setdefault(
                threading.get_ident(), _SketchShard(self._n))
        if v < 0.0:
            v = 0.0
        i = bisect_left(self._edges_list, v)
        shard.cur[i] += 1
        shard.total[i] += 1
        shard.sum += v
        if v > shard.max:
            shard.max = v

    def observe_many(self, values) -> int:
        """Vectorized observe (the per-alert batch path); returns n."""
        values = np.maximum(np.asarray(values, np.float64).ravel(), 0.0)
        if values.size == 0:
            return 0
        shard = self._shards.get(threading.get_ident())
        if shard is None:
            shard = self._shards.setdefault(
                threading.get_ident(), _SketchShard(self._n))
        idx = np.searchsorted(self._edges_arr, values, side="left")
        np.add.at(shard.cur, idx, 1)
        np.add.at(shard.total, idx, 1)
        shard.sum += float(values.sum())
        m = float(values.max())
        if m > shard.max:
            shard.max = m
        return int(values.size)

    def roll(self) -> None:
        """Retire the current window (owner-thread call, once per window
        boundary). Writers racing the swap can at worst land one observe
        in the just-retired window — diagnostic tolerance, same as a
        scrape racing a write in obs/metrics.py."""
        self.rolls += 1
        for s in self._shard_list():
            s.prev[:] = s.cur
            s.cur[:] = 0

    def _merged(self, scope: str) -> np.ndarray:
        out = np.zeros(self._n, np.int64)
        for s in self._shard_list():
            if scope == "total":
                out += s.total
            else:  # window: last complete + current partial
                out += s.prev
                out += s.cur
        return out

    def count(self, scope: str = "window") -> int:
        return int(self._merged(scope).sum())

    def quantile(self, q: float, scope: str = "window") -> float | None:
        """Interpolated quantile over the scope's counts; None if empty."""
        counts = self._merged(scope)
        total = int(counts.sum())
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.edges):
                    return self.edges[-1]  # overflow saturates at hi
                hi_e = self.edges[i]
                lo_e = self.edges[i - 1] if i > 0 else 0.0
                frac = (rank - cum) / c
                if lo_e <= 0.0:
                    return hi_e * frac  # sub-resolution bucket: linear
                return float(lo_e * (hi_e / lo_e) ** frac)
            cum += c
        return self.edges[-1]

    def quantiles(self, qs=DEFAULT_QS, scope: str = "window") -> dict:
        return {qlabel(q): self.quantile(q, scope) for q in qs}

    def nbytes(self) -> int:
        """Preallocated counter memory (the bounded-memory pin: constant
        regardless of how many values were observed)."""
        return sum(s.cur.nbytes + s.prev.nbytes + s.total.nbytes
                   for s in self._shard_list())

    def summary(self, scope: str = "window") -> dict:
        out = {"count": self.count(scope),
               **{k: (round(v, 6) if v is not None else None)
                  for k, v in self.quantiles(scope=scope).items()}}
        if scope == "total":
            shards = self._shard_list()
            out["sum_s"] = round(sum(sh.sum for sh in shards), 6)
            out["max_s"] = round(
                max((sh.max for sh in shards), default=0.0), 6)
        return out

    # ------------------------------------------------- fleet merge core --
    def state(self) -> dict:
        """Lossless wire form (the fleet push payload): bucket
        geometry + the shard-summed count arrays for every scope. A
        sketch rebuilt by :meth:`from_state` answers every quantile/count
        query identically to this one — the counts ARE the sketch."""
        cur = np.zeros(self._n, np.int64)
        prev = np.zeros(self._n, np.int64)
        total = np.zeros(self._n, np.int64)
        sum_s = 0.0
        max_s = 0.0
        for s in self._shard_list():
            cur += s.cur
            prev += s.prev
            total += s.total
            sum_s += s.sum
            if s.max > max_s:
                max_s = s.max
        return {"v": 1, "lo": self.lo, "hi": self.hi,
                "per_decade": self.per_decade,
                "cur": cur.tolist(), "prev": prev.tolist(),
                "total": total.tolist(),
                "sum": sum_s, "max": max_s, "rolls": self.rolls}

    @classmethod
    def from_state(cls, wire: dict) -> "QuantileSketch":
        """Rebuild a sketch from :meth:`state` output (a plain-JSON wire
        payload, not a model state tree). Raises ValueError on
        geometry/count-length mismatch (a corrupt or skewed payload
        must never fold silently into a fleet quantile)."""
        sk = cls(lo=float(wire["lo"]), hi=float(wire["hi"]),
                 per_decade=int(wire["per_decade"]))
        cur = np.asarray(wire["cur"], np.int64)
        prev = np.asarray(wire["prev"], np.int64)
        total = np.asarray(wire["total"], np.int64)
        if not (cur.shape == prev.shape == total.shape == (sk._n,)):
            raise ValueError(
                f"sketch state count arrays have wrong length "
                f"(want {sk._n}, got {cur.shape}/{prev.shape}/"
                f"{total.shape})")
        shard = sk._shards.setdefault(threading.get_ident(),
                                      _SketchShard(sk._n))
        shard.cur[:] = cur
        shard.prev[:] = prev
        shard.total[:] = total
        shard.sum = float(wire.get("sum", 0.0))
        shard.max = float(wire.get("max", 0.0))
        sk.rolls = int(wire.get("rolls", 0))
        return sk

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other``'s counts into this sketch, losslessly, scope by
        scope (cur+cur, prev+prev, total+total, sum/max folded). Only
        sketches over IDENTICAL bucket edges merge — fleet p99s must come
        from summed counts over one geometry, never from resampling
        (which would silently re-introduce the max-of-p99s lie this
        exists to kill). Returns self for chaining."""
        if other.edges != self.edges:
            raise ValueError(
                f"cannot merge sketches with different bucket edges "
                f"(lo/hi/per_decade {self.lo}/{self.hi}/{self.per_decade}"
                f" vs {other.lo}/{other.hi}/{other.per_decade})")
        shard = self._shards.get(threading.get_ident())
        if shard is None:
            shard = self._shards.setdefault(
                threading.get_ident(), _SketchShard(self._n))
        for s in other._shard_list():
            shard.cur += s.cur
            shard.prev += s.prev
            shard.total += s.total
            shard.sum += s.sum
            if s.max > shard.max:
                shard.max = s.max
        return self


class LatencyTracker:
    """Per-tick stage-waterfall fold + the per-alert e2e detect sketch.

    ``record_tick`` (loop thread, once per tick) observes each stage's
    wall seconds into its sketch, keeps the latest waterfall for
    ``GET /latency`` / postmortem embedding, polls the lag providers,
    and rolls the windows every ``window_ticks``. ``observe_detect``
    (AlertWriter, at sink-write time) feeds the e2e sketch. Both run on
    the loop thread by the serve stack's emission contract; the sketch
    shards tolerate other writers anyway.
    """

    def __init__(self, window_ticks: int = 120, cadence_s: float = 1.0,
                 registry: TelemetryRegistry | None = None, slo=None):
        if window_ticks < 1:
            raise ValueError(
                f"window_ticks must be >= 1; got {window_ticks}")
        self.window_ticks = int(window_ticks)
        self.cadence_s = float(cadence_s)
        self.slo = slo  # optional obs.slo.SloTracker fed per observation
        self.sketches = {s: QuantileSketch() for s in STAGES}
        self.last_waterfall: dict | None = None
        self.ticks = 0
        self.detect_samples = 0
        #: name -> callable(tick, ts) -> float | None; polled once per
        #: tick into rtap_obs_latency_lag{lag=name} (repl ack lag,
        #: incident-close lag — the CLI wires them)
        self.lag_providers: dict = {}
        self.last_lags: dict = {}
        reg = registry or get_registry()
        self._obs_samples = reg.counter(
            "rtap_obs_latency_samples_total",
            "per-alert end-to-end detection-latency samples observed at "
            "alert-sink write time (wall clock minus row source ts)")
        self._obs_rolls = reg.counter(
            "rtap_obs_latency_window_rolls_total",
            "quantile-sketch window boundaries crossed "
            "(--latency-window ticks each)")
        self._obs_q = {
            q: reg.gauge(
                "rtap_obs_latency_detect_seconds",
                "windowed detection-latency quantiles (source ts -> "
                "alert-sink flush), updated at window rolls and run end",
                quantile=qlabel(q))
            for q in DEFAULT_QS
        }
        self._obs_lag = {}
        self._reg = reg

    # ------------------------------------------------------------ feed --
    def observe_detect(self, lag_s) -> None:
        """Per-alert e2e latency (scalar or vector of wall-minus-source
        seconds), observed by AlertWriter after the batch reached the
        sink. Also feeds any ``detect`` SLO."""
        n = self.sketches["detect"].observe_many(lag_s)
        if n == 0:
            return
        self.detect_samples += n
        self._obs_samples.inc(n)
        if self.slo is not None:
            self.slo.observe_many("detect", np.asarray(lag_s, np.float64))

    def record_tick(self, tick: int, ts: int, phase_deltas: dict,
                    elapsed_s: float, poll_wall: float | None = None,
                    source=None) -> None:
        """Fold one tick's stage facts (loop thread).

        ``poll_wall`` is the wall clock right after the source poll;
        ``ts`` the tick's (clamped) source timestamp. ``source`` is
        duck-probed for the binary-ingest arrival/backfill surfaces
        (``last_arrival_lag_s`` / ``last_release_hold_s``) — absent on
        JSONL/HTTP sources, absent means the stage is simply not in the
        waterfall."""
        sk = self.sketches
        slo = self.slo
        ingest_lag = None
        if poll_wall is not None:
            ingest_lag = max(0.0, float(poll_wall) - float(ts))
            sk["ingest"].observe(ingest_lag)
            if slo is not None:
                slo.observe("ingest", ingest_lag)
        for stage in ("dispatch", "collect", "emit"):
            d = float(phase_deltas.get(stage, 0.0))
            sk[stage].observe(d)
            if slo is not None:
                # every measured stage feeds its (possibly declared)
                # SLO — an operator contract on emit/dispatch latency
                # must judge, not sit inert (observe is a dict miss for
                # undeclared stages)
                slo.observe(stage, d)
        sk["tick"].observe(float(elapsed_s))
        if slo is not None:
            slo.observe("tick", float(elapsed_s))
        wf = {
            "tick": int(tick),
            "ts": int(ts),
            "ingest_lag_s": round(ingest_lag, 6)
            if ingest_lag is not None else None,
            "dispatch_s": round(float(phase_deltas.get("dispatch", 0.0)), 6),
            "collect_s": round(float(phase_deltas.get("collect", 0.0)), 6),
            "emit_s": round(float(phase_deltas.get("emit", 0.0)), 6),
            "tick_s": round(float(elapsed_s), 6),
        }
        arrival = getattr(source, "last_arrival_lag_s", None)
        if arrival is not None:
            wf["arrival_lag_s"] = round(float(arrival), 6)
        hold = getattr(source, "last_release_hold_s", None)
        if hold is not None:
            wf["backfill_hold_s"] = round(float(hold), 6)
        for name, provider in self.lag_providers.items():
            try:
                v = provider(tick, ts)
            except Exception:  # noqa: BLE001 — a lag probe must not
                v = None  # kill the tick it narrates
            if v is None:
                continue
            self.last_lags[name] = float(v)
            g = self._obs_lag.get(name)
            if g is None:
                g = self._obs_lag[name] = self._reg.gauge(
                    "rtap_obs_latency_lag",
                    "first-class pipeline lag gauges by kind "
                    "(repl_ack_ticks, incident_close_s, ...)", lag=name)
            g.set(float(v))
        if self.last_lags:
            wf["lags"] = dict(self.last_lags)
        self.last_waterfall = wf
        self.ticks += 1
        if self.ticks % self.window_ticks == 0:
            self._roll()

    def _roll(self) -> None:
        for sk in self.sketches.values():
            sk.roll()
        self._obs_rolls.inc()
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        for q, g in self._obs_q.items():
            v = self.sketches["detect"].quantile(q)
            if v is not None:
                g.set(round(v, 6))

    # --------------------------------------------------------- consume --
    def quantile(self, stage: str, q: float,
                 scope: str = "window") -> float | None:
        """Stage quantile — the SLO verdict's observed-value source."""
        sk = self.sketches.get(stage)
        return None if sk is None else sk.quantile(q, scope)

    def snapshot(self) -> dict:
        """The ``GET /latency`` body: per-stage windowed + lifetime
        quantiles, the latest waterfall, and the lag gauges."""
        return {
            "ts": time.time(),
            "window_ticks": self.window_ticks,
            "ticks": self.ticks,
            "detect_samples": self.detect_samples,
            "stages": {
                name: {"window": sk.summary("window"),
                       "total": sk.summary("total")}
                for name, sk in self.sketches.items()
            },
            "waterfall": self.last_waterfall,
            "lags": dict(self.last_lags),
        }

    def sketch_states(self) -> dict:
        """Per-stage lossless sketch states (the fleet push payload) —
        the aggregator rebuilds and merges these so fleet quantiles are
        computed from pooled counts, not from per-member quantiles."""
        return {name: sk.state() for name, sk in self.sketches.items()}

    def stats(self) -> dict:
        """End-of-run block for the loop's stats dict (and the soak
        artifacts). Publishes the final quantile gauges so the exit
        snapshot carries fresh values."""
        self._publish_gauges()
        return {
            "window_ticks": self.window_ticks,
            "ticks": self.ticks,
            "detect_samples": self.detect_samples,
            "detect": self.sketches["detect"].summary("total"),
            "stages": {name: self.sketches[name].summary("total")
                       for name in STAGES if name != "detect"},
            "waterfall": self.last_waterfall,
            **({"lags": dict(self.last_lags)} if self.last_lags else {}),
        }
