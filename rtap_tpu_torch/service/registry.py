"""Stream groups: many metric streams stepped in lockstep on one device.

Port of the JAX package's ``service/registry.py``: streams are packed into
fixed-capacity groups, every stream of a group shares one batched step
(ops/step.chunk_step), and the host keeps the likelihood and the debounced
alerts. The device argument takes the place of the JAX package's
``backend``: ``cuda`` by default, ``"cpu"`` for the plain PyTorch path. The
mesh argument is not ported yet; passing it raises. Checkpoints are
service/checkpoint.py's.

``health=True`` makes every dispatched chunk also return the per-group
health leaf (ops/health.py) and ``predict=k`` > 0 arms the predictive-
horizon reducer at horizon k (ops/predict.py; the state gains the
predictor leaves). :meth:`StreamGroup.collect_chunk` leaves the chunk's
numpy leaves, with a leading tick axis, in ``last_health`` and
``last_predict`` for the host trackers. Model state and scores are the same
with either on or off.

With ``cfg.classifier.enabled`` each tick also predicts every stream's
next value (ops/classifier.py): the chunk's predictions [T, G] ride the
same pinned copy as the scores and land in ``last_predictions``; a
:class:`TickResult` carries the tick's row. A group's per-stream encoder
resolutions (``state["enc_resolution"]``, f32 [G, n_fields] on the group's
device) may be set after construction, as a batched NAB corpus run does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from rtap_tpu_torch import resolve_device
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import init_state
from rtap_tpu_torch.ops.step import chunk_step, replicate_state_device, set_state_row
from rtap_tpu_torch.service.likelihood_batch import BatchAnomalyLikelihood


@dataclass
class TickResult:
    """Scores for one tick of one group, index-aligned with group.stream_ids."""

    raw: np.ndarray  # [G] f32
    likelihood: np.ndarray  # [G] f64
    log_likelihood: np.ndarray  # [G] f64
    alerts: np.ndarray  # [G] bool
    prediction: np.ndarray | None = None  # [G] f32, when the classifier is on


PAD_PREFIX = "__pad"


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported to rtap_tpu_torch yet (ROADMAP.md, port "
            "queue A); use the JAX package for it")


class StreamGroup:
    """G lockstep streams sharing one batched device step.

    Slots whose id starts with ``__pad`` are capacity, not streams: they are
    fed NaN, never emitted, and can be claimed mid-run by a new stream
    (:meth:`claim_slot`) or returned by a departing one
    (:meth:`release_slot`). Claiming resets the slot's model state,
    likelihood moments + probation clock and debounce counter."""

    def __init__(self, cfg: ModelConfig, stream_ids: list[str], seed: int = 0,
                 device=None, threshold: float = 0.5, debounce: int = 1,
                 mesh=None, health: bool = False, predict: int = 0):
        _refuse_mesh(mesh)
        if debounce < 1:
            raise ValueError(f"debounce must be >= 1, got {debounce}")
        if predict < 0:
            raise ValueError(f"predict horizon must be >= 0, got {predict}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the dense SP overlap counts through an f32 product (ops/sp.py)
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.stream_ids = list(stream_ids)
        self.G = len(self.stream_ids)
        self.seed = seed
        self.threshold = threshold
        self.debounce = int(debounce)
        self.health = bool(health)
        self.predict = int(predict)  # horizon k; 0 = predictor off
        # the last collected chunk's reducer leaves [T, ...] (numpy)
        self.last_health: dict | None = None
        self.last_predict: dict | None = None
        # the last collected chunk's predicted values [T, G] (classifier only)
        self.last_predictions: np.ndarray | None = None
        self._alert_run = np.zeros(self.G, np.int64)
        self.likelihood = BatchAnomalyLikelihood(cfg.likelihood, self.G)
        self.ticks = 0
        # alert-id timeline epoch: 0 on a group's original timeline, bumped
        # when a quarantine restore rewinds self.ticks so re-used tick
        # indices never collide with delivered alert ids (checkpointed)
        self.alert_epoch = 0
        self._seq = 0
        self._collected = 0
        self.state = replicate_state_device(init_state(cfg, seed, self.predict), self.G,
                                            self.device)
        # host mirror of stream 0's tm_iter, the lockstep clock the learning
        # cadence reads: advanced per dispatched tick, reset when slot 0 is
        # re-initialized, so no tick reads it back from the device
        self._tick0 = 0
        # resume cursors a checkpoint-loaded group carries (service/
        # checkpoint.load_group): the alert sink's byte offset and the
        # global journal tick at the save instant; None on a fresh group
        self.resume_alerts_offset: int | None = None
        self.resume_journal_tick: int | None = None

    # ---- dynamic membership (slots are static, streams are data) ----
    @property
    def n_live(self) -> int:
        return self.G - sum(1 for s in self.stream_ids if s.startswith(PAD_PREFIX))

    def live_slots(self) -> np.ndarray:
        """Slot indices holding real streams, ascending: emission and value
        routing index with it so pad/released slots never surface."""
        return np.array([i for i, s in enumerate(self.stream_ids)
                         if not s.startswith(PAD_PREFIX)], np.int64)

    def free_slot_count(self) -> int:
        return self.G - self.n_live

    def learning_rows(self, m: int, learn: bool = True) -> list[bool]:
        """Which of the next `m` dispatched ticks run the TM learning pass
        (one kernel launch each on the card): all of them at full rate,
        those the config's cadence names otherwise, none with `learn` off."""
        if not learn:
            return [False] * m
        if not self.cfg.cadence_active:
            return [True] * m
        return [bool(self.cfg.learns_on(self._tick0 + t)) for t in range(m)]

    def claim_slot(self, stream_id: str) -> int:
        """Assign `stream_id` to a pad slot mid-run -> slot index; the slot
        restarts exactly like a stream registered into a fresh group."""
        if stream_id.startswith(PAD_PREFIX):
            raise ValueError(f"stream id may not start with {PAD_PREFIX!r}")
        if stream_id in self.stream_ids:
            raise KeyError(f"duplicate stream id {stream_id!r}")
        slot = next((i for i, s in enumerate(self.stream_ids) if s.startswith(PAD_PREFIX)), None)
        if slot is None:
            raise RuntimeError(
                f"group is full ({self.G} live streams); capacity comes "
                "from pad slots (group-size rounding or released streams)")
        self._reset_slot_state(slot)
        self.stream_ids[slot] = stream_id
        return slot

    def release_slot(self, stream_id: str) -> int:
        """Return a stream's slot to pad capacity -> freed slot index."""
        try:
            slot = self.stream_ids.index(stream_id)
        except ValueError:
            raise KeyError(f"unknown stream id {stream_id!r}") from None
        self.stream_ids[slot] = f"{PAD_PREFIX}!released{slot}"
        self._alert_run[slot] = 0
        return slot

    def _reset_slot_state(self, slot: int) -> None:
        fresh = init_state(self.cfg, self.seed, self.predict)
        if self.predict:
            # the claimed slot's predictor warm-up restarts now: scoring a
            # real tick against its zeroed ring would fake a divergence
            fresh["pred_tick0"] = np.int32(self.ticks)
        self.state = set_state_row(self.state, fresh, slot)
        if slot == 0:
            self._tick0 = int(fresh["tm_iter"])
        self.likelihood.reset_slot(slot)
        self._alert_run[slot] = 0

    def set_enc_resolution(self, resolution: np.ndarray) -> None:
        """Give each stream its own encoder resolution: `resolution` is
        [G, n_fields] (f32 after the cast), kept on the group's device."""
        res = np.asarray(resolution, np.float32)
        want = tuple(self.state["enc_resolution"].shape)
        if res.shape != want:
            raise ValueError(f"enc_resolution must be {want}; got {res.shape}")
        self.state["enc_resolution"] = torch.from_numpy(res.copy()).to(self.device)

    # ---- stepping ----
    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            # pinned + non_blocking: the copy queues behind the previous
            # chunk instead of waiting for it
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _debounced(self, loglik: np.ndarray) -> np.ndarray:
        """Advance the consecutive-hit counters one tick -> alert mask [G]."""
        hits = loglik >= self.threshold
        self._alert_run = np.where(hits, self._alert_run + 1, 0)
        return self._alert_run >= self.debounce

    def tick(self, values: np.ndarray, ts, learn: bool = True) -> TickResult:
        """Score one tick. `values` [G] or [G, n_fields]; `ts` scalar or [G]."""
        values = np.asarray(values, np.float32)
        if values.ndim == 1:
            values = values[:, None]
        ts = np.array(np.broadcast_to(np.asarray(ts, np.int32), (self.G,)))  # writable
        self.collect_chunk(self.dispatch_chunk(values[None], ts[None], learn))
        return self._last_tick

    def dispatch_chunk(self, values: np.ndarray, ts: np.ndarray, learn: bool = True) -> dict:
        """Enqueue T ticks on the device without waiting for the result ->
        a handle for :meth:`collect_chunk` (its ``learned`` is how many of
        the T ticks ran the learning pass). Handles must be collected in
        dispatch order (the likelihood is sequential)."""
        values = np.asarray(values, np.float32)
        if values.ndim == 2:
            values = values[..., None]
        T = values.shape[0]
        self.state, out = chunk_step(
            self.state, self._to_device(values), self._to_device(np.asarray(ts, np.int32)),
            self.cfg, learn=learn, tick0=self._tick0, health=self.health,
            predict=bool(self.predict))
        leaves = {"health": None, "predict": None, "pred": None}
        if self.predict:  # wraps outermost (ops/step.py)
            out, leaves["predict"] = out
        if self.health:
            out, leaves["health"] = out
        if self.cfg.classifier.enabled:  # (raw, prediction, probability)
            out, leaves["pred"] = out[0], out[1]
        leaves["raw"] = out
        done = None
        if self.device.type == "cuda":
            # the scores' and leaves' copies to pinned host memory are
            # queued right behind this chunk, with an event: collecting it
            # later waits for THIS chunk only, not for chunks dispatched
            # after it (a .cpu() at collect time would queue behind those
            # and overlap nothing)
            leaves = {k: v if v is None else _pinned_copy(v) for k, v in leaves.items()}
            done = torch.cuda.Event()
            done.record()
        learned = self.learning_rows(T, learn)
        self._tick0 += T
        self._seq += 1
        return {**leaves, "done": done, "T": T, "seq": self._seq,
                "learned": sum(learned), "learned_rows": learned}

    def collect_chunk(self, handle: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Block on a dispatched chunk -> (raw [T, G], log_likelihood [T, G],
        alerts [T, G]); classifier predictions land in ``last_predictions``."""
        if handle["seq"] != self._collected + 1:
            raise RuntimeError(
                f"collect_chunk out of order: handle seq {handle['seq']}, "
                f"expected {self._collected + 1} (likelihood state is sequential)")
        if handle["done"] is not None:
            handle["done"].synchronize()
        raw = handle["raw"].numpy()
        pred = None if handle["pred"] is None else handle["pred"].numpy()
        if handle["health"] is not None:
            self.last_health = {k: v.numpy() for k, v in handle["health"].items()}
        if handle["predict"] is not None:
            self.last_predict = {k: v.numpy() for k, v in handle["predict"].items()}
        self._collected = handle["seq"]
        T = handle["T"]
        self.last_predictions = pred
        self.ticks += T
        lik = np.empty((T, self.G))
        loglik = np.empty((T, self.G))
        alerts = np.empty((T, self.G), bool)
        for i in range(T):
            lik[i], loglik[i] = self.likelihood.update(raw[i])
            alerts[i] = self._debounced(loglik[i])
        self._last_tick = TickResult(raw[-1], lik[-1], loglik[-1], alerts[-1],
                                     None if pred is None else pred[-1])
        return raw, loglik, alerts

    def run_chunk(self, values: np.ndarray, ts: np.ndarray,
                  learn: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Replay T ticks synchronously: `values` [T, G] or [T, G, n_fields],
        `ts` [T, G] -> (raw [T, G], log_likelihood [T, G], alerts [T, G]);
        with the classifier, predictions [T, G] land in ``last_predictions``."""
        return self.collect_chunk(self.dispatch_chunk(values, ts, learn))

    def overflow_total(self) -> int:
        """Sum of the per-stream kernel capacity-overflow counters."""
        return int(self.state["tm_overflow"].sum())


def alert_gid(gi: int, grp) -> int | str:
    """The alert_id group field: the bare group index on a group's original
    timeline, ``<gi>.e<epoch>`` after a quarantine restore has rewound its
    tick counter."""
    return gi if not grp.alert_epoch else f"{gi}.e{grp.alert_epoch}"


def _pinned_copy(x):
    """A tensor, or a dict of them, copied into pinned host memory behind the
    work already queued (non-blocking)."""
    if isinstance(x, dict):
        return {k: _pinned_copy(v) for k, v in x.items()}
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


@dataclass(frozen=True)
class SlotAddress:
    """A stream's (shard, group, slot) address. ``shard`` is 0: the port
    runs each group on one device."""

    shard: int
    group: int
    slot: int


@dataclass
class _Slot:
    group: StreamGroup
    index: int


class StreamGroupRegistry:
    """Lazy stream_id -> (group, slot) assignment: streams fill the open
    group until it reaches `group_size`, then a new group opens; every group
    is padded to `group_size`.

    `stagger_learn` (on only when ``cfg.learn_every`` > 1) shifts each
    group's learning cadence by its index: group i is built with
    ``learn_phase = (i mod learn_every) * learn_burst``, so on any tick past
    the full-rate window 1/learn_every of the groups learn instead of all of
    them every learn_every-th tick. The phases follow from the group index
    alone, so a registry rebuilt with the same flags reproduces them."""

    def __init__(self, cfg: ModelConfig, group_size: int = 1024, device=None, seed: int = 0,
                 threshold: float = 0.5, debounce: int = 1,
                 mesh=None, health: bool = False, predict: int = 0,
                 stagger_learn: bool = False):
        _refuse_mesh(mesh)
        self.cfg = cfg
        self.stagger_learn = bool(stagger_learn) and cfg.learn_every > 1
        self.health = bool(health)
        self.predict = int(predict)
        self.device = resolve_device(device)
        self.group_size = int(group_size)
        self.seed = seed
        self.threshold = threshold
        self.debounce = int(debounce)
        self.groups: list[StreamGroup] = []
        self._slots: dict[str, _Slot] = {}
        self._pending: list[str] = []
        self._finalized = False
        # bumped on every post-finalize membership change; live_loop watches
        # it to rebuild value/emission routing
        self.version = 0

    def add_stream(self, stream_id: str) -> None:
        """Register a stream: buffered into the next group before
        :meth:`finalize`, claiming a free pad slot after it (RuntimeError
        when every slot is live; capacity comes from group-size rounding,
        `reserve` slots or released streams)."""
        if stream_id.startswith(PAD_PREFIX):
            raise ValueError(f"stream id may not start with {PAD_PREFIX!r}")
        if stream_id in self._slots or stream_id in self._pending:
            raise KeyError(f"duplicate stream id {stream_id!r}")
        if self._finalized:
            for grp in self.groups:
                if grp.free_slot_count():
                    slot = grp.claim_slot(stream_id)
                    self._slots[stream_id] = _Slot(grp, slot)
                    self.version += 1
                    return
            raise RuntimeError(
                f"registry at capacity ({len(self._slots)} live streams, 0 "
                "free slots): pre-provision with reserve= or release "
                "departed streams")
        self._pending.append(stream_id)
        if len(self._pending) == self.group_size:
            self._seal()

    def remove_stream(self, stream_id: str) -> None:
        """Release a departed stream's slot back to pad capacity (it stops
        being fed and emitted; a later add_stream may claim it).
        Post-finalize only."""
        if not self._finalized:
            raise RuntimeError("remove_stream is a post-finalize operation")
        s = self._slots.pop(stream_id, None)
        if s is None:
            raise KeyError(f"unknown stream id {stream_id!r}")
        s.group.release_slot(stream_id)
        self.version += 1

    def _group_cfg(self, gi: int) -> ModelConfig:
        """The config group `gi` is built with: the registry's, its cadence
        phase shifted by whole bursts when stagger_learn is on (at most
        learn_every distinct configs fleet-wide)."""
        if not self.stagger_learn:
            return self.cfg
        return replace(self.cfg,
                       learn_phase=(gi % self.cfg.learn_every) * self.cfg.learn_burst)

    def _new_group(self, ids: list[str]) -> StreamGroup:
        grp = StreamGroup(self._group_cfg(len(self.groups)), ids,
                          seed=self.seed + len(self.groups), device=self.device,
                          threshold=self.threshold, debounce=self.debounce,
                          health=self.health, predict=self.predict)
        self.groups.append(grp)
        return grp

    def _seal(self) -> None:
        if not self._pending:
            return
        ids = self._pending
        padded = ids + [f"{PAD_PREFIX}{i}" for i in range(self.group_size - len(ids))]
        grp = self._new_group(padded)
        for i, sid in enumerate(ids):
            self._slots[sid] = _Slot(grp, i)
        self._pending = []

    def finalize(self, reserve: int = 0) -> None:
        """Seal the last partially-filled group, padded to group_size.
        `reserve` adds that many extra claimable pad slots (counting the
        pads the rounding already left, rounded up to whole all-pad
        groups)."""
        if reserve < 0:
            raise ValueError(f"reserve must be >= 0; got {reserve}")
        rounding_pads = (-len(self._pending)) % self.group_size if self._pending else 0
        self._seal()
        extra = max(0, reserve - rounding_pads)
        for _ in range((extra + self.group_size - 1) // self.group_size):
            self._new_group([f"{PAD_PREFIX}{i}" for i in range(self.group_size)])
        self._finalized = True

    def lookup(self, stream_id: str) -> tuple[StreamGroup, int]:
        s = self._slots[stream_id]
        return s.group, s.index

    def __contains__(self, stream_id: str) -> bool:
        return stream_id in self._slots or stream_id in self._pending

    def dispatch_ids(self) -> list[str]:
        """Live stream ids in (group, slot) order — the value-vector order
        live_loop's routing and every source snapshot follow."""
        return [g.stream_ids[i] for g in self.groups for i in g.live_slots()]

    def slot_map(self) -> dict[str, SlotAddress]:
        """Live stream id -> (shard, group, slot) address; iterating it
        reproduces :meth:`dispatch_ids`. Pads/released slots are absent."""
        return {g.stream_ids[int(slot)]: SlotAddress(shard=0, group=gi, slot=int(slot))
                for gi, g in enumerate(self.groups) for slot in g.live_slots()}

    @property
    def free_slots(self) -> int:
        return sum(g.free_slot_count() for g in self.groups)

    @property
    def n_streams(self) -> int:
        return len(self._slots) + len(self._pending)
