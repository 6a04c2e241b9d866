"""Telemetry primitives: Counter / Gauge / Histogram + TelemetryRegistry.

The port's copy of the JAX package's ``obs/metrics.py`` (same names, same
semantics): every host-side hot path of the serve stack — the tick loop's
phases, alert emission, ingest health, checkpoint saves, the journal —
emits through ONE process-wide registry.

- **Lock-free writer fast path.** No instrument takes a lock on ``inc`` /
  ``set`` / ``observe``: every writer thread owns a private cell (keyed by
  ``threading.get_ident()``); readers sum the cells.
- **Allocation-free histogram observe.** Buckets are a numpy int64 array
  per writer thread, bucket search is ``bisect`` over a plain-float edge
  list.
- **Fixed log-spaced buckets** suited to the 1 ms - 10 s tick-latency range
  (:func:`log_buckets`): the measurement primitive is a histogram, never an
  average.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Sequence

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "TelemetryRegistry",
    "get_registry",
    "log_buckets",
]

_VALID_TYPES = ("counter", "gauge", "histogram")


def log_buckets(lo: float = 1e-3, hi: float = 10.0,
                per_decade: int = 5) -> tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds covering [lo, hi].

    Defaults span 1 ms .. 10 s at 5 buckets/decade — the tick-latency range
    the 1 s-cadence serve path lives in (sub-ms phases up through the
    multi-second warm-up-compile outliers the soak forensics chase).
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi; got lo={lo}, hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1; got {per_decade}")
    n = int(round(np.log10(hi / lo) * per_decade))
    edges = lo * (10.0 ** (np.arange(n + 1) / per_decade))
    # float roundoff must not drop the intended top edge
    edges[-1] = max(edges[-1], hi)
    return tuple(float(e) for e in edges)


def _sum_cells(cells: dict) -> float:
    """Sum a per-thread cell dict, tolerating a concurrent first write from
    a brand-new thread (dict resize mid-iteration raises RuntimeError —
    vanishingly rare; retry, then fall back to a point-in-time copy)."""
    for _ in range(8):
        try:
            return sum(cells.values())
        except RuntimeError:
            continue
    return sum(dict(cells).values())


class _Instrument:
    """Common identity: name + fixed label set (one instrument per child)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: dict[str, str] | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})

    def _meta(self) -> dict:
        d: dict = {"name": self.name, "type": self.kind}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class Counter(_Instrument):
    """Monotonic counter. ``inc`` touches only the calling thread's cell —
    lock-free and safe under concurrent writers (each thread owns its key)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: dict[str, str] | None = None):
        super().__init__(name, help, labels)
        self._cells: dict[int, float] = {}

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        cells = self._cells
        tid = threading.get_ident()
        cells[tid] = cells.get(tid, 0.0) + n

    @property
    def value(self) -> float:
        return _sum_cells(self._cells)

    def snapshot_value(self):
        return self.value


class Gauge(_Instrument):
    """Last-write-wins point-in-time value. ``set`` is a single attribute
    store (atomic under the GIL); ``inc``/``dec`` are single-writer
    conveniences (document ownership if you share one across threads)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: dict[str, str] | None = None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1) -> None:
        self._value += n

    def dec(self, n: float = 1) -> None:
        self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def snapshot_value(self):
        return self._value


class _HistShard:
    """One writer thread's private histogram state (no cross-thread writes)."""

    __slots__ = ("counts", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = np.zeros(n_buckets, np.int64)
        self.sum = 0.0
        self.min = np.inf
        self.max = -np.inf


class Histogram(_Instrument):
    """Fixed-bucket histogram with Prometheus ``le`` (v <= edge) semantics.

    ``observe`` is O(log n_buckets) and allocation-free on a thread's
    second and later observes: bisect over a plain-float edge list, then an
    in-place numpy int64 bucket increment in the calling thread's shard.
    The implicit +Inf bucket is the last slot.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] | None = None,
                 labels: dict[str, str] | None = None):
        super().__init__(name, help, labels)
        edges = tuple(float(e) for e in (buckets or log_buckets()))
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name} buckets must be strictly increasing and "
                f"non-empty; got {edges}")
        self.edges = edges
        self._edges_list = list(edges)  # bisect target (no numpy boxing)
        self._shards: dict[int, _HistShard] = {}

    def observe(self, v: float) -> None:
        shard = self._shards.get(threading.get_ident())
        if shard is None:
            shard = self._shards.setdefault(
                threading.get_ident(), _HistShard(len(self.edges) + 1))
        shard.counts[bisect_left(self._edges_list, v)] += 1
        shard.sum += v
        if v < shard.min:
            shard.min = v
        if v > shard.max:
            shard.max = v

    def _merged(self) -> _HistShard:
        out = _HistShard(len(self.edges) + 1)
        for _ in range(8):
            try:
                shards = list(self._shards.values())
                break
            except RuntimeError:
                continue
        else:
            shards = list(dict(self._shards).values())
        for s in shards:
            out.counts += s.counts
            out.sum += s.sum
            out.min = min(out.min, s.min)
            out.max = max(out.max, s.max)
        return out

    @property
    def count(self) -> int:
        return int(self._merged().counts.sum())

    @property
    def sum(self) -> float:
        return self._merged().sum

    def snapshot_value(self) -> dict:
        m = self._merged()
        count = int(m.counts.sum())
        cum = np.cumsum(m.counts)
        out = {
            "buckets": {repr(e): int(c) for e, c in zip(self.edges, cum)},
            "count": count,
            "sum": m.sum,
        }
        out["buckets"]["+Inf"] = count
        if count:
            out["min"] = m.min
            out["max"] = m.max
        return out


def _key(name: str, labels: dict[str, str]) -> tuple:
    return (name, tuple(sorted(labels.items())))


class TelemetryRegistry:
    """Process-wide instrument registry: get-or-create by (name, labels).

    Creation takes a lock (cold path, once per instrument); the returned
    instruments are cached by every call site, so steady-state emission
    never touches the registry. One metric NAME has one type and one help
    string — a type conflict is a programming error and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, _Instrument] = {}
        self._types: dict[str, str] = {}
        self._buckets: dict[str, tuple] = {}
        self._help: dict[str, str] = {}  # one HELP string per metric name

    def _get_or_create(self, cls, name: str, help: str,
                       labels: dict[str, str], **kw) -> _Instrument:
        key = _key(name, labels)
        inst = self._instruments.get(key)
        if inst is not None:
            if inst.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}")
            return inst
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                prior = self._types.get(name)
                if prior is not None and prior != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {prior}, "
                        f"requested {cls.kind}")
                if cls.kind == "histogram":
                    buckets = tuple(kw.get("buckets") or log_buckets())
                    prior_b = self._buckets.setdefault(name, buckets)
                    if prior_b != buckets:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {prior_b}; one family, one grid")
                    kw["buckets"] = buckets
                inst = cls(name, help=help, labels=labels, **kw)
                self._types[name] = cls.kind
                if help:
                    self._help.setdefault(name, help)
                self._instruments[key] = inst
            elif inst.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] | None = None,
                  **labels: str) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def collect(self) -> list[_Instrument]:
        """Stable-ordered instrument list (by name, then label items)."""
        with self._lock:
            items = sorted(self._instruments.items())
        return [inst for _, inst in items]

    def help_for(self, name: str) -> str:
        """The metric's HELP string (the Prometheus text header)."""
        return self._help.get(name, "")

    def snapshot(self) -> dict:
        """Point-in-time JSON-able view of every instrument."""
        return {
            "ts": time.time(),
            "metrics": [
                {**inst._meta(), "value": inst.snapshot_value()}
                for inst in self.collect()
            ],
        }


_REGISTRY = TelemetryRegistry()


def get_registry() -> TelemetryRegistry:
    """The process-wide default registry every serve-path instrument lands
    in. Library code takes an optional registry and defaults to this."""
    return _REGISTRY
