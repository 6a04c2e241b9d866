"""Deterministic, seedable fault injection for the serve stack.

Every recovery path in the resilience layer is exercised end-to-end, not
trusted: a :class:`ChaosSpec` (hand-written JSON or generated from a seed)
schedules faults against the live loop's IO seams — the source callable,
per-group dispatch/collect, the alert sink's file object, and checkpoint
saves — and a :class:`ChaosEngine` injects them at exactly the scripted
ticks. Same seed, same schedule, same injection points: a chaos soak that
found a bug is a reproducer, not an anecdote
(``python -m rtap_tpu_torch.chaos_soak --seed N``; ``serve --chaos-spec
FILE``). This is the port's copy of the JAX package's
``resilience/chaos.py``: the same vocabulary in the same order, and
``ChaosSpec.generate(seed)`` draws the JAX package's schedule (the same
``digest()``) for the same seed, so a soak that found a bug reproduces in
either package.

Fault vocabulary (``Fault.kind``):

- ``source_timeout``      — the poll yields NaN for the targeted stream
  indices (``streams``; None = the whole vector) — a timed-out exporter
- ``source_malformed``    — the source raises ``ValueError`` (garbage
  payload reached the adapter)
- ``source_conn_drop``    — the source raises ``ConnectionResetError``
- ``source_backwards_ts`` — the poll's timestamp jumps back ``ts_skew_s``
  seconds (a misbehaving exporter clock)
- ``dispatch_exception``  — group ``group``'s dispatch raises
- ``collect_exception``   — group ``group``'s collect raises
- ``dispatch_hang``       — group ``group``'s dispatch blocks ``seconds``
  (a wedged device RPC, scaled down to test budget)
- ``alert_sink_oserror``  — every alert-file write raises ``OSError``
  (full disk) for the fault window
- ``checkpoint_oserror``  — the per-group checkpoint save raises
  ``OSError`` for the fault window
- ``proc_exit``           — the PROCESS dies abruptly (``os._exit``, no
  cleanup, no flush) at the tick boundary right after the tick's row is
  ingested/journaled — the durability layer's honest crash
  (``chaos_soak --supervise`` runs this under the supervisor + journal
  recovery path). Excluded from seed-GENERATED schedules
  (it would kill the generating test run); schedule it explicitly.
- ``conn_drop`` / ``stall_socket`` / ``corrupt_bytes`` — network faults
  on a byte-stream edge: the replication channel consults
  ``ChaosEngine.on_wire`` per shipped record (in the JAX package only
  ``resilience/replicate.py`` calls it; the binary-ingest wire does not).
  Excluded from the default generated draw (they fire only where a wire
  seam exists, and adding them would shift existing seeds' digests). In
  the port no seam calls :meth:`ChaosEngine.on_wire` yet: its one
  consumer, the replication channel, is not ported (ROADMAP M5); the
  kinds stay in the vocabulary so specs and digests match the JAX
  package's.
- ``topology_burst``      — the poll ADDS ``magnitude`` to the targeted
  stream indices for the fault window: a correlated multi-stream fault
  (a real blast radius, not one exporter misbehaving) for the incident-
  correlation drill (``chaos_soak
  --topology-burst`` schedules one spanning multiple groups and asserts
  exactly ONE cluster-level incident pages, not N per-stream alerts).
  Excluded from generated schedules: an undirected burst has no
  topology to correlate — schedule it explicitly with the stream
  indices of the adjacent nodes it floods.

A fault is active for ticks ``[tick, tick + duration)``. Group-targeted
kinds apply to every group when ``group`` is None. The engine logs every
actual injection (``engine.injected``) and counts them in
``rtap_obs_chaos_injected_total{kind=...}`` so a chaos run's artifact
states what was injected, not just what was scheduled.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from dataclasses import asdict, dataclass, field

import numpy as np

from rtap_tpu_torch.obs import get_registry

__all__ = ["ChaosEngine", "ChaosError", "ChaosSpec", "FAULT_KINDS",
           "Fault", "GENERATED_KINDS", "PROC_EXIT_CODE"]

FAULT_KINDS = (
    "source_timeout",
    "source_malformed",
    "source_conn_drop",
    "source_backwards_ts",
    "dispatch_exception",
    "collect_exception",
    "dispatch_hang",
    "alert_sink_oserror",
    "checkpoint_oserror",
    "proc_exit",
    # network fault kinds for the byte-stream edges: the
    # replication channel and the binary-ingest wire share one seam —
    # ChaosEngine.on_wire(tick, data) — so both paths prove the same
    # recovery vocabulary (CRC skip + resync/backfill, reconnect,
    # bounded-buffer non-stall)
    "conn_drop",      # the wire send raises ConnectionResetError
    "stall_socket",   # the wire send blocks `seconds` (slow peer)
    "corrupt_bytes",  # bytes flip in flight (CRC must catch, never apply)
    # correlated multi-stream burst: the source adds
    # `magnitude` to the targeted stream indices for the window — the
    # incident-correlation drill's blast-radius fault
    "topology_burst",
)

#: kinds NOT in the default generated draw, in addition to keeping every
#: older seed's schedule byte-identical (digest-stable):
#: - proc_exit kills the process (schedule it explicitly);
#: - the wire kinds only fire where a wire seam consults the
#:   engine (replication sender / binary feeders) — generating them
#:   into a plain serve schedule would inject nothing, and adding them
#:   to the draw would shift every existing seed's digest. Pass
#:   kinds=(..., "corrupt_bytes", ...) to generate() to draw them.
#: - topology_burst needs explicit stream targeting (a random draw has
#:   no topology to correlate) — schedule it by hand.
_UNGENERATED = ("proc_exit", "conn_drop", "stall_socket", "corrupt_bytes",
                "topology_burst")
GENERATED_KINDS = tuple(k for k in FAULT_KINDS if k not in _UNGENERATED)

#: exit code of an injected proc_exit death (distinguishable from real
#: crashes and from SIGKILL in supervisor logs)
PROC_EXIT_CODE = 86

#: kinds that target one StreamGroup (``group`` field; None = all groups)
GROUP_KINDS = ("dispatch_exception", "collect_exception", "dispatch_hang",
               "checkpoint_oserror")


class ChaosError(RuntimeError):
    """The injected dispatch/collect failure (distinguishable from real
    faults in logs and quarantine events by its message prefix)."""


@dataclass(frozen=True)
class Fault:
    kind: str
    tick: int
    duration: int = 1
    group: int | None = None
    streams: tuple[int, ...] | None = None  # source faults: vector indices
    seconds: float = 0.25  # dispatch_hang block length
    ts_skew_s: int = 3600  # source_backwards_ts jump
    magnitude: float = 12.0  # topology_burst value offset

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.tick < 0 or self.duration < 1:
            raise ValueError(
                f"need tick >= 0 and duration >= 1; got {self.tick}, "
                f"{self.duration}")

    def active(self, tick: int, group: int | None = None) -> bool:
        if not self.tick <= tick < self.tick + self.duration:
            return False
        return self.group is None or group is None or self.group == group


@dataclass
class ChaosSpec:
    """A deterministic fault schedule: explicit list or seed-generated."""

    faults: list[Fault] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSpec":
        """Parse the ``--chaos-spec`` JSON shape: either
        ``{"seed": S, "faults": [{"kind": ..., "tick": ...}, ...]}`` or
        ``{"seed": S, "generate": {"n_ticks": T, "n_groups": G,
        "rate": R, "kinds": [...]}}``."""
        seed = int(d.get("seed", 0))
        if "generate" in d:
            if "faults" in d:
                raise ValueError(
                    "chaos spec takes 'faults' OR 'generate', not both")
            return cls.generate(seed=seed, **d["generate"])
        faults = [
            Fault(**{**f, "streams": tuple(f["streams"])
                     if f.get("streams") is not None else None})
            for f in d.get("faults", [])
        ]
        return cls(faults=faults, seed=seed)

    @classmethod
    def from_file(cls, path: str) -> "ChaosSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def generate(cls, seed: int, n_ticks: int, n_groups: int = 1,
                 rate: float = 0.05,
                 kinds: tuple[str, ...] | None = None) -> "ChaosSpec":
        """Seed-deterministic schedule: each tick draws one fault with
        probability ``rate``, kind and target group uniform. The PRNG is
        a private ``random.Random(seed)`` — the global random state and
        wall clock never touch the schedule, so ``--seed N`` is a full
        reproducer of the injected fault sequence."""
        if not 0 <= rate <= 1:
            raise ValueError(f"rate must be in [0, 1]; got {rate}")
        kinds = tuple(kinds or GENERATED_KINDS)
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = random.Random(seed)
        faults = []
        for t in range(int(n_ticks)):
            if rng.random() >= rate:
                continue
            kind = kinds[rng.randrange(len(kinds))]
            gi = rng.randrange(max(1, int(n_groups)))
            # source_timeout carries a group too: it targets ONE group's
            # worth of streams so healthy groups keep bit-identical inputs
            # (the reference shape: one exporter times out, not the whole
            # fleet) — live_loop maps group -> vector indices from its
            # routing (ChaosEngine.set_group_streams)
            targeted = kind in GROUP_KINDS or kind == "source_timeout"
            faults.append(Fault(
                kind=kind, tick=t,
                group=gi if targeted else None,
                seconds=0.05 if kind == "dispatch_hang" else 0.25,
            ))
        return cls(faults=faults, seed=seed)

    def to_dict(self) -> dict:
        # `magnitude` serializes only for the kind that reads it: every
        # older spec keeps its exact dict shape, so existing seeds'
        # digests stay pinned (tests/unit/test_replicate.py)
        faults = []
        for f in self.faults:
            d = asdict(f)
            if f.kind != "topology_burst":
                del d["magnitude"]
            faults.append(d)
        return {"seed": self.seed, "faults": faults}

    def shifted(self, base: int) -> "ChaosSpec":
        """The schedule as seen by a RESTARTED process that resumes at
        global tick `base`: faults before the resume point are dropped
        (they already fired — in particular a proc_exit that fired must
        not re-kill every restart), the rest shift to the restart's
        local tick clock. proc_exit fires AFTER its tick is journaled,
        so a restart's base is always past the killing fault's tick and
        the drop is unambiguous."""
        if base <= 0:
            return self
        out = []
        for f in self.faults:
            if f.tick + f.duration <= base:
                continue
            start = max(f.tick, base)
            out.append(Fault(
                kind=f.kind, tick=start - base,
                duration=f.tick + f.duration - start, group=f.group,
                streams=f.streams, seconds=f.seconds,
                ts_skew_s=f.ts_skew_s, magnitude=f.magnitude))
        return ChaosSpec(faults=out, seed=self.seed)

    def digest(self) -> str:
        """Stable content hash of the schedule — two runs with the same
        seed/spec must print the same digest (reproducibility proof in
        the chaos_soak artifact)."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


class ChaosEngine:
    """Injects a :class:`ChaosSpec` at the live loop's IO seams.

    The loop drives the tick clock (:meth:`set_tick`) and calls the
    ``on_dispatch`` / ``on_collect`` / ``on_checkpoint_save`` hooks at its
    seams; :meth:`wrap_source` and :meth:`wrap_alert_writer` wrap the
    objects whose faults live OUTSIDE the loop's code. Injections are
    logged in ``self.injected`` and counted per kind.
    """

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self.tick = 0
        self.injected: list[dict] = []
        #: gi -> tuple of source-vector indices; filled by live_loop from
        #: its routing (set_group_streams) so a group-targeted
        #: source_timeout with streams=None hits exactly that group's
        #: slice of the vector — not the whole fleet
        self.group_streams: dict[int, tuple] = {}
        obs = get_registry()
        self._obs_injected = {
            kind: obs.counter(
                "rtap_obs_chaos_injected_total",
                "chaos faults actually injected, by kind", kind=kind)
            for kind in FAULT_KINDS
        }
        self._by_kind: dict[str, list[Fault]] = {}
        for f in spec.faults:
            self._by_kind.setdefault(f.kind, []).append(f)
        #: wire faults fire ONCE per scheduled Fault: the wire RETRIES
        #: the same record after a fault (reconnect + backfill, resync
        #: after a CRC skip), so a window that re-fired on the retry
        #: would be a permanent outage, not an injected fault
        self._wire_fired: set[int] = set()

    def set_tick(self, tick: int) -> None:
        """The loop's current tick — timestamps injections that happen
        outside a hook call (the alert-sink file wrapper)."""
        self.tick = int(tick)

    def set_group_streams(self, mapping: dict[int, tuple]) -> None:
        """Adopt the loop's group -> source-vector-indices routing (called
        at loop start and after every routing rebuild): generated
        source_timeout faults carry a target group, and only the loop
        knows which vector slice that group reads."""
        self.group_streams = {int(g): tuple(ix) for g, ix in mapping.items()}

    def _find(self, kind: str, tick: int,
              group: int | None = None) -> Fault | None:
        for f in self._by_kind.get(kind, ()):
            if f.active(tick, group):
                return f
        return None

    def _record(self, kind: str, tick: int, group: int | None = None) -> None:
        self._obs_injected[kind].inc()
        entry: dict = {"kind": kind, "tick": int(tick)}
        if group is not None:
            entry["group"] = int(group)
        self.injected.append(entry)

    # ---- loop seams -------------------------------------------------
    def on_dispatch(self, group: int, tick: int) -> None:
        """Called before a group's dispatch; may block (hang) or raise."""
        f = self._find("dispatch_hang", tick, group)
        if f is not None:
            self._record("dispatch_hang", tick, group)
            time.sleep(f.seconds)
        if self._find("dispatch_exception", tick, group) is not None:
            self._record("dispatch_exception", tick, group)
            raise ChaosError(
                f"chaos: dispatch exception (group {group}, tick {tick})")

    def on_collect(self, group: int, tick: int) -> None:
        """Called before a group's collect; may raise."""
        if self._find("collect_exception", tick, group) is not None:
            self._record("collect_exception", tick, group)
            raise ChaosError(
                f"chaos: collect exception (group {group}, tick {tick})")

    def on_checkpoint_save(self, group: int, tick: int) -> None:
        """Called before a group's checkpoint save; may raise OSError."""
        if self._find("checkpoint_oserror", tick, group) is not None:
            self._record("checkpoint_oserror", tick, group)
            raise OSError(28, "chaos: no space left on device")

    def on_wire(self, tick: int, data: bytes) -> bytes:
        """The byte-stream wire seam: consulted per shipped
        record by the replication sender (resilience/replicate.py) and
        by binary-ingest feeders that opt in. Keyed by the RECORD's
        tick, not the wall clock, so a seeded schedule is an exact
        reproducer. May block (``stall_socket`` — the leader's tick
        must not stall, which is the bounded-buffer property this
        proves), raise (``conn_drop`` — reconnect + journal backfill),
        or return corrupted bytes (``corrupt_bytes`` — the receiver's
        CRC walker must skip, never apply, and resync via its gap
        request)."""
        f = self._find("stall_socket", tick)
        if f is not None and id(f) not in self._wire_fired:
            self._wire_fired.add(id(f))
            self._record("stall_socket", tick)
            time.sleep(f.seconds)
        f = self._find("conn_drop", tick)
        if f is not None and id(f) not in self._wire_fired:
            self._wire_fired.add(id(f))
            self._record("conn_drop", tick)
            raise ConnectionResetError(
                f"chaos: wire connection dropped (tick {tick})")
        f = self._find("corrupt_bytes", tick)
        if f is not None and id(f) not in self._wire_fired:
            self._wire_fired.add(id(f))
            self._record("corrupt_bytes", tick)
            out = bytearray(data)
            if out:
                out[len(out) // 2] ^= 0xFF  # deterministic single flip
            return bytes(out)
        return data

    def on_tick_ingested(self, tick: int) -> None:
        """Called right after the tick's row was ingested (and journaled,
        when a journal is armed); a scheduled proc_exit dies HERE —
        abruptly, no cleanup, no flush (os._exit). Firing after the
        journal append makes the restart semantics unambiguous: the
        killing tick is on disk, the resumed process replays it, and
        ChaosSpec.shifted(base) drops the fault for good."""
        if self._find("proc_exit", tick) is not None:
            self._record("proc_exit", tick)
            import os

            os._exit(PROC_EXIT_CODE)

    # ---- object wrappers --------------------------------------------
    def wrap_source(self, source):
        """Wrap a live_loop source callable with the source fault kinds;
        delegates every other attribute (drain_unknown, set_ids, ...)."""
        return _ChaosSource(self, source)

    def wrap_alert_writer(self, writer) -> None:
        """Wrap the writer's underlying file so scripted windows raise
        OSError on write/flush — exercising AlertWriter's own
        retry-then-quarantine path from below, not around it."""
        writer.wrap_sink(lambda fh: _FaultyFile(fh, self))


class _ChaosSource:
    """Source-callable wrapper injecting the ``source_*`` fault kinds."""

    def __init__(self, engine: ChaosEngine, inner):
        self._engine = engine
        self._inner = inner

    def __call__(self, tick: int):
        eng = self._engine
        if eng._find("source_conn_drop", tick) is not None:
            eng._record("source_conn_drop", tick)
            raise ConnectionResetError("chaos: connection dropped")
        if eng._find("source_malformed", tick) is not None:
            eng._record("source_malformed", tick)
            raise ValueError("chaos: malformed payload")
        values, ts = self._inner(tick)
        f = eng._find("source_timeout", tick)
        if f is not None:
            eng._record("source_timeout", tick, f.group)
            values = np.array(values, np.float32, copy=True)
            streams = f.streams
            if streams is None and f.group is not None:
                # group-targeted fault without explicit indices: the
                # loop's routing says which slice the group reads
                streams = eng.group_streams.get(f.group)
            if streams is None:
                values[...] = np.nan
            else:
                values[list(streams)] = np.nan
        f = eng._find("source_backwards_ts", tick)
        if f is not None:
            eng._record("source_backwards_ts", tick)
            ts = int(ts) - int(f.ts_skew_s)
        f = eng._find("topology_burst", tick)
        if f is not None:
            # correlated multi-stream burst: flood the targeted
            # indices (None = the whole fleet — a global brown-out). NaNs
            # from an overlapping source_timeout stay NaN: a timed-out
            # exporter reports nothing, burst or not.
            eng._record("topology_burst", tick)
            values = np.array(values, np.float32, copy=True)
            if f.streams is None:
                values += np.float32(f.magnitude)
            else:
                values[list(f.streams)] += np.float32(f.magnitude)
        return values, ts

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _FaultyFile:
    """File-object proxy whose writes raise OSError during fault windows
    (the engine's tick clock decides). Everything else delegates."""

    def __init__(self, fh, engine: ChaosEngine):
        self._fh = fh
        self._engine = engine

    def _check(self) -> None:
        eng = self._engine
        if eng._find("alert_sink_oserror", eng.tick) is not None:
            eng._record("alert_sink_oserror", eng.tick)
            raise OSError(28, "chaos: no space left on device")

    def write(self, s):
        self._check()
        return self._fh.write(s)

    def writelines(self, lines):
        self._check()
        return self._fh.writelines(lines)

    def flush(self):
        self._check()
        return self._fh.flush()

    def close(self):
        return self._fh.close()

    def __getattr__(self, name):
        return getattr(self._fh, name)
