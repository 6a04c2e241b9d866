"""Typed configuration for the HTM anomaly pipeline (PyTorch port).

A verbatim copy of the JAX package's ``config.py``: the port keeps its own
copy so it never imports the JAX package, and the two serialize to the same
JSON (``ModelConfig.from_dict(other.to_dict())`` round-trips between them;
tests/test_torch_state.py pins it). Keep the two in step when either
changes.

Presets:

- :func:`nab_preset` — NuPIC/NAB-scale model (2048 columns, 32 cells/col),
  used for detection-quality runs on NAB-format corpora.
- :func:`cluster_preset` — a small-footprint model for massive stream counts,
  where per-stream device memory is the binding constraint.

All sizes are static, so every kernel sees fixed shapes; segment/synapse
pools are bounded capacity by design, mirroring NuPIC's maxSegmentsPerCell /
maxSynapsesPerSegment bounds.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


# RDSE bucket indices are clamped to this magnitude on BOTH backends before
# integer conversion. The device kernel runs int32 (no x64 on TPU); without a
# shared clamp, a wild value (overflowed counter, sensor garbage) >= 2^31
# buckets from the offset would wrap on device but not on host, silently and
# permanently diverging the SDR stream. 2^30 is exactly representable in f32
# and leaves headroom for the +active_bits hash-key offsets.
RDSE_BUCKET_CLAMP = 1 << 30


@dataclass(frozen=True)
class RDSEConfig:
    """Random Distributed Scalar Encoder (SURVEY.md C1).

    Scalar -> sparse binary SDR. A value maps to bucket
    ``b = round((value - offset) / resolution)``; bucket ``b`` activates bits
    ``{hash(seed, b + k) % size : k in 0..active_bits-1}``. Adjacent buckets
    share ``active_bits - 1`` hash keys, so SDR overlap decays linearly with
    bucket distance — the defining RDSE property. Hash collisions within one
    bucket are tolerated (the SDR then has active_bits-1 on bits), the same
    deterministic-union approach used by the public htm.core RDSE; this keeps
    the encoder table-free and device-computable.

    ``offset`` is bound to the first value a stream sees (NuPIC behavior),
    stored in per-stream state.
    """

    size: int = 400
    active_bits: int = 21
    resolution: float = 0.9
    seed: int = 42


@dataclass(frozen=True)
class ScalarEncoderConfig:
    """Classic bucketed ScalarEncoder (SURVEY.md C2, NuPIC `scalar.py`):
    a fixed [min_val, max_val] range mapped onto ``size`` bits with a
    ``width``-bit contiguous run; bucket = round((v - min) * (size - width)
    / (max - min)), input clipped into range (NuPIC clipInput=True).

    Unlike the RDSE it needs the value range up front and wastes resolution
    outside it — the detector presets keep the RDSE; this exists for parity
    with the reference's encoder family and for fields with known ranges
    (e.g. percentages). Selected per model via ``ModelConfig.scalar``.
    """

    size: int = 400
    width: int = 21
    min_val: float = 0.0
    max_val: float = 100.0


#: Valid per-field encoder kinds of a composite multi-field encoder
#: ("Encoding Data for HTM Systems", PAPERS.md 1602.05925):
#:   rdse        — the RDSE over the field's raw value (the default family)
#:   delta       — RDSE over the FIRST DIFFERENCE of the value (NuPIC
#:                 DeltaEncoder semantics: rate-of-change is the signal;
#:                 the first sample, having no predecessor, encodes as
#:                 missing). Needs per-stream prev-value state (enc_prev).
#:   categorical — hash-bucketed enum: category id c activates bits
#:                 {hash(seed, c*w + k) % size : k < w}. DISJOINT key
#:                 ranges per category, so distinct categories share no
#:                 hash keys and their SDRs overlap only by chance — the
#:                 defining categorical property (no false similarity
#:                 between adjacent ids), vs the RDSE's deliberate
#:                 linear-decay overlap. Log-template ids (the drain-style
#:                 miner in rtap_tpu/ingest/templates.py) ride this kind.
FIELD_KINDS = ("rdse", "delta", "categorical")


@dataclass(frozen=True)
class FieldSpec:
    """One field of a :class:`CompositeEncoderConfig` (name + kind + its
    own encoder geometry). ``resolution`` applies to rdse/delta kinds;
    categorical buckets are the (rounded) ids themselves."""

    name: str
    kind: str = "rdse"
    size: int = 128
    active_bits: int = 11
    resolution: float = 0.5
    seed: int = 42

    def categorical_clamp(self) -> int:
        """Category-id magnitude bound: ids clamp here on BOTH backends so
        the device's int32 key arithmetic (c * active_bits + k) can never
        wrap where the host's int64 would not (same contract as
        RDSE_BUCKET_CLAMP)."""
        return RDSE_BUCKET_CLAMP // max(self.active_bits, 1)


@dataclass(frozen=True)
class CompositeEncoderConfig:
    """Composite multi-field encoder: fuse heterogeneous fields — e.g.
    {value, delta, event-class} (+ the DateConfig hour-of-day ring, which
    stays a ModelConfig-level field) — into ONE SDR per stream.

    Each field owns a disjoint bit range (the per-field layout table,
    ``ModelConfig.field_layout``), so SDR union semantics (PAPERS.md
    1503.07469) carry the joint code and the RDSE key-space attribution
    decode (service/attribution.py) can name which FIELD spiked. Wire
    records stay [n_fields] f32 rows; categorical fields carry the
    category id as a float (template ids from the log miner included).
    """

    fields: tuple[FieldSpec, ...] = ()

    def __post_init__(self) -> None:
        if not self.fields:
            raise ValueError("CompositeEncoderConfig needs >= 1 field")
        # dict/JSON round-trips hand tuples back as lists; normalize so
        # frozen-config hashing (the jit static key) stays stable
        object.__setattr__(self, "fields", tuple(
            f if isinstance(f, FieldSpec) else FieldSpec(**f)
            for f in self.fields))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names) or any(not n for n in names):
            raise ValueError(
                f"composite field names must be non-empty and unique; got "
                f"{names} (attribution reports fields BY NAME)")
        for f in self.fields:
            if f.kind not in FIELD_KINDS:
                raise ValueError(
                    f"field {f.name!r}: kind must be one of {FIELD_KINDS}; "
                    f"got {f.kind!r}")
            if not 0 < f.active_bits < f.size:
                raise ValueError(
                    f"field {f.name!r}: needs 0 < active_bits < size; got "
                    f"w={f.active_bits}, n={f.size}")
            if f.kind in ("rdse", "delta") and not f.resolution > 0:
                raise ValueError(
                    f"field {f.name!r}: resolution must be > 0; got "
                    f"{f.resolution}")

    @property
    def size(self) -> int:
        return sum(f.size for f in self.fields)

    @property
    def has_delta(self) -> bool:
        return any(f.kind == "delta" for f in self.fields)


@dataclass(frozen=True)
class DateConfig:
    """Date/time encoder (SURVEY.md C2): periodic time-of-day + weekend bits.

    ``time_of_day_width`` bits win a contiguous (wrapping) run on a periodic
    ring of ``time_of_day_size`` bits covering 24h. ``weekend_width`` bits are
    all-on during Sat/Sun, all-off otherwise. Width 0 disables a field.
    """

    time_of_day_width: int = 21
    time_of_day_size: int = 54  # ring size; NuPIC n = w * period/radius ~ 21*24/9.49
    weekend_width: int = 0

    @property
    def size(self) -> int:
        return (self.time_of_day_size if self.time_of_day_width else 0) + self.weekend_width


@dataclass(frozen=True)
class SPConfig:
    """Spatial Pooler (SURVEY.md C3) — global inhibition variant.

    Semantics follow the public NuPIC SpatialPooler (overlap = count of
    connected synapses on active inputs; boost; global top-k inhibition;
    Hebbian permanence learning), re-laid-out as dense per-column arrays:
    a fixed potential mask [columns, input_size] and a dense permanence
    matrix masked by it. Tie-breaks in the top-k are deterministic by lower
    column index (score = overlap * columns + (columns-1-c)), identical in
    the numpy oracle and the TPU kernel.
    """

    columns: int = 2048
    potential_pct: float = 0.8
    syn_perm_connected: float = 0.2
    syn_perm_active_inc: float = 0.003
    syn_perm_inactive_dec: float = 0.0005
    stimulus_threshold: int = 0
    num_active_columns: int = 40  # k winners (global inhibition)
    boost_strength: float = 0.0
    duty_cycle_period: int = 1000
    min_pct_overlap_duty_cycle: float = 0.001
    syn_perm_below_stimulus_inc: float = 0.01  # bump for starved columns
    seed: int = 1956
    # Permanence storage: 0 = f32 (reference semantics), 16/8 = fixed-point
    # quanta on 1/(2^bits - 1) with exact integer arithmetic on both backends
    # (models/perm.py). Quantization is the per-stream HBM lever (SURVEY.md
    # §7 hard part 4): SP perm is the second-largest state tensor.
    perm_bits: int = 0
    # Structurally sparse pool storage: True replaces the dense
    # `potential` bool [C, n_in] mask + `perm` [C, n_in] plane with a
    # member-index table `members` [C, P] (P potential inputs per column,
    # -1 = empty slot) + `perm` [C, P] over the members only. Overlap and
    # learning become gathers over the member table (ops/sp_tpu.py); bytes
    # and the per-tick sweep shrink from C*n_in to C*P. SDR theory says
    # sparsity, not pool width, carries capacity (PAPERS.md 1503.07469).
    # False (default) keeps the dense layout — every pre-existing config,
    # checkpoint, and golden is byte-identical.
    sparse_pool: bool = False
    # Members per column in the sparse layout: 0 derives
    # P = round(potential_pct * input_size) (the structural twin of the
    # dense mask's expected density); > 0 pins P explicitly — the
    # dense->sparse checkpoint migration needs an exact P that covers the
    # widest migrated column (models/migrate.py). Ignored when dense.
    pool_members: int = 0


@dataclass(frozen=True)
class TMConfig:
    """Temporal Memory (SURVEY.md C4/C5) — vanilla TM with bounded dense pools.

    NuPIC's pointer-graph `Connections` store becomes pre-allocated pools
    (SURVEY.md §7 design stance): per cell, ``max_segments_per_cell`` segment
    slots x ``max_synapses_per_segment`` synapse slots, each synapse a
    (presynaptic cell id, permanence) pair; id < 0 marks an empty slot.
    Segment allocation uses free slots first, then evicts the least recently
    used segment (NuPIC's eviction rule). Winner-cell and best-segment
    tie-breaks are deterministic by lowest index.
    """

    cells_per_column: int = 32
    activation_threshold: int = 13
    min_threshold: int = 10
    initial_permanence: float = 0.21
    connected_permanence: float = 0.5
    permanence_increment: float = 0.1
    permanence_decrement: float = 0.1
    predicted_segment_decrement: float = 0.001
    max_segments_per_cell: int = 16
    max_synapses_per_segment: int = 32
    new_synapse_count: int = 20
    seed: int = 1960
    # Static-shape capacities for the device kernel's column-compact learning
    # pass (SURVEY.md §7 hard part 1): at most `learn_cap` segments learn per
    # step (>= active columns; predicted columns can contribute several).
    # Overflow is counted in state["tm_overflow"]; tests assert it stays zero
    # at the configured sizes.
    learn_cap: int = 128
    # Permanence storage for the TM synapse pools — the single largest state
    # tensor (see SPConfig.perm_bits; models/perm.py). At 8 bits the coarse
    # quantum makes predicted_segment_decrement 1/255 ≈ 0.0039 (floored at one
    # quantum); the detection-quality impact per domain is measured in
    # eval/fault_eval, not assumed.
    perm_bits: int = 0
    # Max simultaneously-active columns per step (>= SPConfig.num_active_columns,
    # validated in ModelConfig). The device kernel's membership tests and its
    # learning workspace are column-compact: active cells can only live in
    # active columns, so comparing against <= col_cap column ids + a packed
    # K-bit per-column cell mask replaces comparing against a flat active-cell
    # id list (8-32x fewer VPU ops at preset sizes).
    col_cap: int = 40
    # Static capacity of the RTAP_TM_SWEEP=compact punish/death pass (ops/
    # tm_tpu.py): at most `punish_cap` matching segments in non-active columns
    # are punished per step; overflow is counted in state["tm_overflow"].
    # Dense-sweep mode (the round-3 semantics) ignores it.
    punish_cap: int = 256
    # Forward-index fanout capacity F (RTAP_TM_DENDRITE=forward, ops/
    # fwd_index.py): max synapse slots per presynaptic cell tracked by
    # fwd_slots [num_cells, F]. A cell exceeding F drops appends — counted in
    # state["fwd_of"] (a dropped entry corrupts dendrite counts, so tests
    # assert the counter stays zero). Memory when the index is enabled:
    # num_cells * F * 4 B (+1-2 B/synapse slot for fwd_pos). Size F to the
    # fanout TAIL: hot winner cells concentrate synapses (measured on the
    # cluster preset's diurnal feed: max fanout 231-382 after 12k ticks and
    # still rising — docs/FORWARD_INDEX_DESIGN.md round-4 measurement), so
    # production forward-mode runs need F >= ~512 at that workload. The
    # default stays small because the index is opt-in and tests own their F.
    fanout_cap: int = 64


@dataclass(frozen=True)
class ClassifierConfig:
    """SDR classifier (SURVEY.md C10) — decodes TM cell state to a predicted
    value distribution, the "prediction" half of the reference's name.

    Semantics follow the public NuPIC SDRClassifier (softmax regression from
    active-cell patterns to encoder buckets, one-step-ahead): at record t the
    pattern from t-1 is trained toward the bucket of the value at t
    (error = onehot - softmax, SGD with rate ``alpha``); inference applies
    the pattern at t to predict t+1. Per-bucket actual values are tracked
    with an EMA (``act_value_alpha``) and the predicted value is the actual
    value of the argmax bucket.

    TPU-native layout: weights are a dense [num_cells, buckets] matrix per
    stream; the pattern->logits matvec and the outer-product update both run
    on the MXU. Buckets are the RDSE bucket index shifted by ``buckets // 2``
    and clamped to [0, buckets) — offset binding centers the first value, and
    NAB-style resolutions span the value range in ~130 buckets.

    Memory note (state_nbytes includes it when enabled): ``cls_w`` is
    [num_cells, buckets] f32 per stream — +1.06 MB/stream on the cluster
    preset (2048 cells x 130, roughly DOUBLING its state) and +34 MB/stream
    on the NAB preset. That is why it is off by default and should stay off
    for massive-stream-count deployments unless predictions are required.
    """

    enabled: bool = False
    buckets: int = 130
    alpha: float = 0.01
    act_value_alpha: float = 0.3


@dataclass(frozen=True)
class LikelihoodConfig:
    """Anomaly likelihood post-process (SURVEY.md C8) — stays on host.

    Faithful to the public NuPIC `anomaly_likelihood.py`: keep a rolling
    window of raw scores, periodically fit a Gaussian to the *moving-averaged*
    scores, and report ``1 - Q((shortTermMean - mu)/sigma)``, log-scaled.

    ``mode="window"`` keeps the exact rolling window (quality runs);
    ``mode="streaming"`` replaces it with exponential moving moments so that
    100k streams do not need a [streams, window] buffer on host
    (SURVEY.md §7 hard part 5).
    """

    learning_period: int = 288
    estimation_samples: int = 100
    historic_window_size: int = 8640
    reestimation_period: int = 100
    averaging_window: int = 10
    mode: str = "window"  # "window" | "streaming"
    streaming_decay: float = 0.999  # EMA decay for streaming mode

    @property
    def probationary_period(self) -> int:
        return self.learning_period + self.estimation_samples

    def safe_inject_frac(self, length: int, margin: int = 100, cap: float = 0.6) -> float:
        """Earliest fault-injection point (fraction of a `length`-tick
        stream) that clears the probation plus a settling margin — a fault
        injected while the likelihood is pinned at 0.5 is undetectable by
        construction, and scoring it corrupts recall with a measurement
        artifact. Shared by the fault eval and the report script so the two
        can never drift. Raises when the stream is too short to evaluate."""
        frac = (self.probationary_period + margin) / length
        if frac > cap:
            raise ValueError(
                f"stream length {length} too short to evaluate: probation "
                f"{self.probationary_period} + margin {margin} is {frac:.0%} "
                f"of it (cap {cap:.0%}); lengthen the streams or shorten the "
                "likelihood learning period"
            )
        return frac


@dataclass(frozen=True)
class ModelConfig:
    """Bundle: one HTM anomaly model (per stream or per stream group)."""

    rdse: RDSEConfig = field(default_factory=RDSEConfig)
    date: DateConfig = field(default_factory=DateConfig)
    sp: SPConfig = field(default_factory=SPConfig)
    tm: TMConfig = field(default_factory=TMConfig)
    likelihood: LikelihoodConfig = field(default_factory=LikelihoodConfig)
    classifier: ClassifierConfig = field(default_factory=ClassifierConfig)
    n_fields: int = 1  # multivariate: number of scalar fields fused into one SDR
    # When set, value fields use the classic ScalarEncoder instead of the
    # RDSE (same layout position; date bits unchanged). None = RDSE default.
    scalar: ScalarEncoderConfig | None = None
    # Composite multi-field encoder: when set, each of the
    # n_fields wire fields encodes by ITS OWN FieldSpec (rdse / delta /
    # categorical, per-field sizes) instead of the uniform RDSE/scalar
    # family; date bits are unchanged. None = the uniform default — every
    # pre-existing config/checkpoint/artifact is byte-identical.
    composite: CompositeEncoderConfig | None = None
    # Learning cadence: learn on ticks where tm_iter % learn_every == 0 (or
    # tm_iter < learn_full_until — the maturity window learns every tick).
    # 1 = NuPIC-faithful continuous learning (default). Thinning mature
    # streams' learning to every k-th tick skips the learning pass on the
    # other ticks; its detection-quality cost is measured in the JAX
    # package's fault eval (--learn-every).
    learn_every: int = 1
    learn_full_until: int = 0
    # Burst shape of the thinned cadence: learn `learn_burst` CONSECUTIVE
    # ticks out of every `learn_every * learn_burst` (same 1/learn_every
    # average rate and device cost, same scalar clock). burst=1 is the
    # spread schedule (every k-th tick) — which breaks the temporal
    # adjacency TM sequence learning feeds on (synapses grow toward the
    # PREVIOUS tick's winner cells, so isolated learn ticks mostly learn
    # k-step-apart pairs). Bursts preserve adjacency inside each burst;
    # quality measured in eval/fault_eval.py --learn-burst.
    learn_burst: int = 1
    # Cadence phase offset: group i of a many-group deployment learns on
    # ticks where (it - learn_phase) % learn_every == 0. With every group
    # at phase 0, ALL groups learn on the same ticks — the per-tick device
    # compute spikes to the full-fleet learning cost on learn ticks and
    # idles on the rest, and at 100k streams the spike alone exceeds the
    # 1 s cadence. Staggering phases (registry stagger_learn) spreads the
    # fleet's learning load evenly across ticks; per-group semantics are
    # identical up to a <learn_every-tick shift of its schedule.
    learn_phase: int = 0

    def learns_on(self, it):
        """The cadence predicate, shared by the device schedule
        (ops/step.py:_tick, traced jnp scalar) and the host twin
        (HTMModel.run, python int) so the two can never diverge:
        learn when `it` (completed steps) is inside the full-rate maturity
        window or on the cadence (burst=1: every k-th tick shifted by
        learn_phase; burst=B: the first B ticks of every k*B-tick cycle,
        phased so a burst begins the tick the maturity window ends —
        absolute phasing would freeze learning for up to (k-1)*B ticks
        right as scoring starts — then shifted by learn_phase)."""
        if self.learn_burst == 1:
            # the original spread schedule (measured semantics; unchanged
            # by the burst/phase features at phase 0)
            return (it < self.learn_full_until) | (
                (it - self.learn_phase) % self.learn_every == 0)
        rel = it - self.learn_full_until - self.learn_phase
        # negative inside the window, where the first clause already grants
        # learning (python/jnp % both give non-negative results, so the
        # second clause stays well-defined)
        return (it < self.learn_full_until) | (
            rel % (self.learn_every * self.learn_burst) < self.learn_burst
        )

    @property
    def cadence_active(self) -> bool:
        """True when the schedule can ever skip a learn tick — the single
        gate shared by the device path (ops/step.py) and the host twins
        (HTMModel.run, registry CPU path), so 'is a cadence configured'
        can never be answered differently on different paths."""
        return self.learn_every > 1

    def with_learn_every(self, k: int, full_until: int | None = None,
                         burst: int = 1) -> "ModelConfig":
        """Cadence config with the standard maturity alignment: full-rate
        learning for the likelihood learning_period (or an explicit
        `full_until`; note this is the Gaussian-fit window, NOT the full
        probation — probation additionally spans estimation_samples ticks
        during which the likelihood is still pinned at 0.5 but learning
        already thins; the measured cadence curve in SCALING.md used
        exactly this boundary). The single policy shared by the operator CLI and
        the fault eval so quality numbers always describe the config the
        service runs. Invalid k (< 1) fails loudly via validation."""
        if k == 1 and full_until is None and burst == 1:
            return self
        return dataclasses.replace(
            self, learn_every=k, learn_burst=burst,
            learn_full_until=(self.likelihood.learning_period
                              if full_until is None else full_until),
        )

    def with_learning_period(self, learning_period: int) -> "ModelConfig":
        """Likelihood probation override (the measured precision lever:
        lp600 is +3 f1 points on the quality study, cost = +5 min warm-up
        over the preset's 300 at 1 s cadence, 10 min total). Apply BEFORE
        `with_learn_every`: the cadence's default full-rate window is the
        learning_period, so the other order silently pins full_until to
        the old probation — this helper and the CLI both enforce the safe
        ordering so callers cannot compose them wrong. Re-deriving
        learn_full_until here keeps an already-cadenced config aligned."""
        if learning_period < 1:
            raise ValueError(f"learning_period must be >= 1; got {learning_period}")
        cfg = dataclasses.replace(self, likelihood=dataclasses.replace(
            self.likelihood, learning_period=learning_period))
        if cfg.cadence_active and self.learn_full_until == \
                self.likelihood.learning_period:
            # the cadence was using the default maturity boundary: keep it
            # tied to the (new) probation rather than the stale value
            cfg = dataclasses.replace(cfg, learn_full_until=learning_period)
        return cfg

    def __post_init__(self) -> None:
        # A col_cap below the SP winner count would silently truncate the
        # kernel's column-compact active set and corrupt dendrite counts (the
        # tm_overflow counter is the only symptom). Fail loudly at construction.
        if self.tm.col_cap < self.sp.num_active_columns:
            raise ValueError(
                f"TMConfig.col_cap={self.tm.col_cap} is below "
                f"SPConfig.num_active_columns={self.sp.num_active_columns}; raise it"
            )
        if self.tm.cells_per_column > 32:
            raise ValueError(
                "cells_per_column > 32 is unsupported: the device kernel packs a "
                "column's cell activity into one int32 bit mask"
            )
        for name, bits in (("sp", self.sp.perm_bits), ("tm", self.tm.perm_bits)):
            if bits not in (0, 8, 16):
                raise ValueError(f"{name}.perm_bits must be 0 (f32), 8, or 16; got {bits}")
        if self.tm.punish_cap < 1:
            raise ValueError(f"TMConfig.punish_cap must be >= 1; got {self.tm.punish_cap}")
        if not 1 <= self.tm.fanout_cap <= (1 << 15) - 1:
            raise ValueError(
                f"TMConfig.fanout_cap must be in [1, 32767] (fwd_pos is int16 at "
                f"widest); got {self.tm.fanout_cap}"
            )
        if self.composite is not None:
            if self.scalar is not None:
                raise ValueError(
                    "composite and scalar encoder configs are exclusive "
                    "(each field of a composite picks its own kind)")
            if len(self.composite.fields) != self.n_fields:
                raise ValueError(
                    f"composite declares {len(self.composite.fields)} "
                    f"field(s) but n_fields={self.n_fields}; the wire row "
                    "and the layout table must agree")
            if self.classifier.enabled:
                raise ValueError(
                    "the SDR classifier decodes the uniform RDSE bucket "
                    "space of field 0 and is unsupported with a composite "
                    "encoder (predict on a scalar-config model instead)")
        if self.scalar is not None:
            # An invalid scalar range corrupts SDRs silently (negative buckets
            # wrap on host but drop on device — parity breaks) — fail loudly.
            if self.scalar.width >= self.scalar.size:
                raise ValueError(
                    f"ScalarEncoderConfig.width={self.scalar.width} must be "
                    f"< size={self.scalar.size}"
                )
            if not self.scalar.min_val < self.scalar.max_val:
                raise ValueError(
                    f"ScalarEncoderConfig needs min_val < max_val; got "
                    f"[{self.scalar.min_val}, {self.scalar.max_val}]"
                )
        if self.learn_every < 1:
            raise ValueError(f"learn_every must be >= 1; got {self.learn_every}")
        if self.learn_burst < 1:
            raise ValueError(f"learn_burst must be >= 1; got {self.learn_burst}")
        if self.learn_burst > 1 and self.learn_every == 1:
            # it % (1*B) < B is always true: the operator asked for a burst
            # cadence that can never thin anything — same loud-failure
            # policy as an invalid k (a saved config claiming learn_burst=8
            # at full rate would misrepresent what actually ran)
            raise ValueError(
                f"learn_burst={self.learn_burst} requires learn_every > 1 "
                "(with learn_every=1 the burst schedule never thins learning)"
            )
        if self.learn_full_until < 0:
            raise ValueError(
                f"learn_full_until must be >= 0; got {self.learn_full_until}"
            )
        cycle = self.learn_every * self.learn_burst
        if not 0 <= self.learn_phase < cycle:
            # a phase outside the cadence cycle silently aliases; demand
            # the canonical value so saved configs read unambiguously.
            # The cycle is k ticks for the spread schedule and k*B for
            # bursts (a burst-mode stagger offsets whole B-tick bursts)
            raise ValueError(
                f"learn_phase must be in [0, learn_every*learn_burst="
                f"{cycle}); got {self.learn_phase}"
            )
        if self.sp.pool_members < 0:
            raise ValueError(
                f"SPConfig.pool_members must be >= 0; got {self.sp.pool_members}"
            )
        if self.sp.sparse_pool:
            p = self.sp_members
            if not 1 <= p <= self.input_size:
                raise ValueError(
                    f"sparse SP pool needs 1 <= members <= input_size="
                    f"{self.input_size}; potential_pct={self.sp.potential_pct} "
                    f"/ pool_members={self.sp.pool_members} derive P={p}"
                )
        if self.sp.columns * self.tm.cells_per_column >= 1 << 24:
            # The kernel round-trips presynaptic cell ids through f32 one-hot
            # matmuls; ids >= 2^24 would lose bits silently.
            raise ValueError(
                "columns * cells_per_column must stay below 2^24 (cell ids are "
                "routed through f32 matmuls in the device kernel)"
            )

    @property
    def field_size(self) -> int:
        """Bits one value field occupies in the SDR (RDSE or classic
        scalar). Composite fields size individually — use
        :meth:`field_layout` there (this property serves the uniform
        family only and refuses to guess)."""
        if self.composite is not None:
            raise ValueError(
                "composite fields have per-field sizes; use field_layout()")
        return self.scalar.size if self.scalar is not None else self.rdse.size

    @property
    def input_size(self) -> int:
        if self.composite is not None:
            return self.composite.size + self.date.size
        return self.field_size * self.n_fields + self.date.size

    def field_resolutions(self) -> tuple[float, ...]:
        """Per-field encoder resolution, wire order — what the per-stream
        ``enc_resolution`` state row initializes from. Uniform configs
        repeat the family resolution; composite rdse/delta fields carry
        their FieldSpec's, and categorical fields use 1.0 (bucket ==
        rounded category id — one shared bucket formula serves all
        kinds)."""
        if self.composite is not None:
            return tuple(
                f.resolution if f.kind in ("rdse", "delta") else 1.0
                for f in self.composite.fields)
        # uniform families share one resolution (the scalar family ignores
        # enc_resolution entirely but the state row has always carried the
        # rdse default — preserved bit-for-bit)
        return (self.rdse.resolution,) * self.n_fields

    def field_layout(self) -> list[tuple[str, str, int, int]]:
        """The per-field SDR layout table: one (name, kind, offset, size)
        row per value field, in wire order — the single source of truth
        for encoder twins, attribution decode, and docs/WORKLOADS.md.
        Uniform configs report kind 'scalar'/'rdse' with synthetic names
        f0..fN-1; composite configs report the declared FieldSpec names."""
        rows: list[tuple[str, str, int, int]] = []
        off = 0
        if self.composite is not None:
            for f in self.composite.fields:
                rows.append((f.name, f.kind, off, f.size))
                off += f.size
            return rows
        kind = "scalar" if self.scalar is not None else "rdse"
        for i in range(self.n_fields):
            rows.append((f"f{i}", kind, off, self.field_size))
            off += self.field_size
        return rows

    @property
    def num_cells(self) -> int:
        return self.sp.columns * self.tm.cells_per_column

    @property
    def sp_members(self) -> int:
        """Members per column P of the sparse SP pool layout (0 for the
        dense layout): an explicit ``pool_members`` wins (the migration
        path pins it to the widest migrated column); otherwise P derives
        from the dense mask's expected density, round-half-up — the same
        arithmetic the scaling-math analyzer re-derives statically
        (analysis/scalingmath.py), so the two can never disagree."""
        if not self.sp.sparse_pool:
            return 0
        if self.sp.pool_members:
            return self.sp.pool_members
        return int(self.sp.potential_pct * self.input_size + 0.5)

    # ---- serialization (JSON round-trip for config files) ----
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        def known(cfg_cls, sub: dict) -> dict:
            # Serialized configs may carry fields from other framework
            # versions (e.g. the retired active_cap/winner_cap capacity
            # bounds): accept and drop them so old checkpoints stay loadable.
            names = {f.name for f in dataclasses.fields(cfg_cls)}
            return {k: v for k, v in sub.items() if k in names}

        sp = SPConfig(**known(SPConfig, d.get("sp", {})))
        tm = TMConfig(**known(TMConfig, d.get("tm", {})))
        # Migration: configs serialized before col_cap existed default to 40;
        # clamp up to the SP winner count (col_cap is a transient kernel
        # workspace bound, not part of saved state shapes, so raising it on
        # resume is semantics-preserving) rather than failing validation.
        if tm.col_cap < sp.num_active_columns:
            import logging

            logging.getLogger(__name__).warning(
                "stored TMConfig.col_cap=%d below num_active_columns=%d; clamping up",
                tm.col_cap, sp.num_active_columns,
            )
            tm = dataclasses.replace(tm, col_cap=sp.num_active_columns)
        return cls(
            rdse=RDSEConfig(**known(RDSEConfig, d.get("rdse", {}))),
            date=DateConfig(**known(DateConfig, d.get("date", {}))),
            sp=sp,
            tm=tm,
            likelihood=LikelihoodConfig(**known(LikelihoodConfig, d.get("likelihood", {}))),
            classifier=ClassifierConfig(**known(ClassifierConfig, d.get("classifier", {}))),
            n_fields=d.get("n_fields", 1),
            scalar=(
                ScalarEncoderConfig(**known(ScalarEncoderConfig, d["scalar"]))
                if d.get("scalar") is not None
                else None
            ),
            composite=(
                CompositeEncoderConfig(
                    fields=tuple(FieldSpec(**known(FieldSpec, f))
                                 for f in d["composite"]["fields"]))
                if d.get("composite") is not None
                else None
            ),
            # pre-cadence checkpoints default to full-rate learning
            learn_every=d.get("learn_every", 1),
            learn_full_until=d.get("learn_full_until", 0),
            learn_burst=d.get("learn_burst", 1),
            learn_phase=d.get("learn_phase", 0),
        )

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        return cls.from_dict(json.loads(s))


def rdse_resolution(min_val: float, max_val: float, buckets: int = 130) -> float:
    """NAB's encoder-resolution rule: the expected value range spans ~130
    buckets (SURVEY.md §5 key defaults). Single source of truth — the preset
    and the per-file rescale in nab/runner.py both use it."""
    return max(0.001, (max_val - min_val) / float(buckets))


def nab_preset(min_val: float = 0.0, max_val: float = 100.0) -> ModelConfig:
    """NuPIC/NAB-scale model for detection-quality runs.

    Mirrors the NAB Numenta-detector parameter family (SURVEY.md §5 key
    defaults): RDSE n=400/w=21 with resolution (max-min)/130, SP 2048
    columns / 40 winners, TM 32 cells per column. Segment pools are bounded
    at 16x32 (vs NuPIC's loose 128-segment cap) — dense-pool capacity
    actually reached by single-metric streams is far below the cap.
    """
    resolution = rdse_resolution(min_val, max_val)
    return ModelConfig(
        rdse=RDSEConfig(size=400, active_bits=21, resolution=resolution),
        date=DateConfig(time_of_day_width=21, time_of_day_size=54, weekend_width=0),
        sp=SPConfig(columns=2048, num_active_columns=40),
        tm=TMConfig(cells_per_column=32, max_segments_per_cell=16,
                    max_synapses_per_segment=32, col_cap=40),
        likelihood=LikelihoodConfig(mode="window"),
    )


def _round_half_up(x: float) -> int:
    """Shared by the scaled presets: banker's rounding once produced a
    degenerate perfect-match segment geometry (see scaled_cluster_preset);
    both width-scaling paths must round the same way."""
    return int(x + 0.5)


def _guard_segment_capacity(name: str, columns: int, ns: int, cap: int) -> None:
    if ns > cap:
        raise ValueError(
            f"{name}({columns}) needs new_synapse_count={ns} > "
            f"max_synapses_per_segment={cap}: upscaling past the preset's "
            "segment capacity silently truncates growth; widen the TM pools "
            "explicitly instead"
        )


def scaled_nab_preset(columns: int, min_val: float = 0.0,
                      max_val: float = 100.0) -> ModelConfig:
    """NAB preset rescaled to `columns` SP width at the preset's ~2%
    activation sparsity, segment geometry tracking the winner count at the
    NuPIC Numenta-detector ratios (sample half the winners per learned
    segment, activate on ~0.65 of the samples, match on ~half — the
    2048/40/20/13/10 family scaled down, round-half-up like
    scaled_cluster_preset so small widths keep non-degenerate thresholds).

    Purpose: the model-width study (SCALING.md, scripts/model_size_eval.py)
    measured the CLUSTER preset heavily oversized on node-metric streams;
    this preset asks the same question of the NAB-family model on the
    diverse-profile stand-in corpus (scripts/nab_standin_report.py
    --columns), where the full-size 2048-column model is the 10.5 s/tick
    CPU-infeasible config. Cells per column stay at the preset's 32 — width
    is the measured axis; the cells axis is deliberately unexplored here.
    """
    base = nab_preset(min_val, max_val)
    k = max(4, _round_half_up(columns * base.sp.num_active_columns
                              / base.sp.columns))
    ns = max(3, _round_half_up(k * base.tm.new_synapse_count
                               / base.sp.num_active_columns))
    _guard_segment_capacity("scaled_nab_preset", columns, ns,
                            base.tm.max_synapses_per_segment)
    act = max(2, _round_half_up(ns * base.tm.activation_threshold
                                / base.tm.new_synapse_count))
    mn = max(1, min(act, _round_half_up(ns * base.tm.min_threshold
                                        / base.tm.new_synapse_count)))
    return dataclasses.replace(
        base,
        sp=dataclasses.replace(base.sp, columns=columns, num_active_columns=k),
        tm=dataclasses.replace(base.tm, activation_threshold=act,
                               min_threshold=mn, new_synapse_count=ns,
                               col_cap=k),
    )


def node_preset(n_metrics: int = 3, perm_bits: int = 16) -> ModelConfig:
    """Multivariate per-node model (SURVEY.md §6 benchmark config 4:
    'multivariate per-node cpu/mem/net fused RDSE').

    One HTM model per NODE, fusing its `n_metrics` scalar fields into a
    single SDR (`ModelConfig.n_fields`; each field gets its own RDSE bit
    range and per-field offset binding — models/oracle/encoders.py). The SP
    learns cross-metric structure, so a fault visible in any one field (or a
    correlated node-level fault across all of them) perturbs the shared
    column code. Built on the DENSE cluster geometry
    (:func:`dense_cluster_preset` — the earlier dense cluster_preset), NOT
    the sparse member-index preset: the sparse-pool quality evidence
    (reports/sparse_quality.json) covers single-metric streams only, and
    the fused multi-field bars in tests/integration/
    test_multivariate_node.py measurably regress at the sparse P=0.5*n_in
    width (learned-quiet p99 raw 0.10 -> 0.30; sweeping P recovers one bar
    only at the cost of leaving the weakest single-field window response
    at the alertability threshold). Sparse-migrating the multivariate
    config needs its own occupancy/quality study — until then it keeps
    the measured dense geometry, and only the SP pool tables grow with
    input_size.
    """
    base = dense_cluster_preset(perm_bits=perm_bits)
    return dataclasses.replace(base, n_fields=n_metrics)


def composite_preset(perm_bits: int = 16, value_resolution: float = 0.5,
                     n_event_classes_hint: int = 256) -> ModelConfig:
    """Composite workload model: one stream fuses
    {value, delta, event-class} + the hour-of-day ring into a single SDR.

    Built on the cluster_preset footprint (only the SP potential/permanence
    matrices grow with input_size; the TM pools — the dominant state — are
    unchanged, same as node_preset). Field geometry keeps the preset's
    ~8.6% per-field bit density (11/128):

    - ``value``  — RDSE over the raw metric (the scalar component; its
      encoding arithmetic is IDENTICAL to the scalar path's field 0, so
      composite F1 on scalar faults is an apples comparison).
    - ``delta``  — RDSE over the first difference (NuPIC DeltaEncoder):
      rate-of-change anomalies (a slope flip inside the normal band) that
      the absolute value hides.
    - ``event_class`` — hash-bucketed categorical over event/template ids
      (log-template ids from rtap_tpu/ingest/templates.py ride here).
      ``n_event_classes_hint`` documents the expected id cardinality; the
      encoder itself is table-free and unbounded.
    - hour-of-day — the DateConfig ring at REDUCED weight (7 of the
      54-bucket NAB ring, vs the NAB family's 21): date bits are context,
      not signal, and at sub-hour horizons they are near-constant. At the
      NAB width they are 21 of 54 active bits, so a full value-field
      novelty flips only ~1/3 of the SP's input overlap and the anomaly
      contrast of a scalar fault collapses (measured: composite F1 0.72
      vs scalar 0.97 on eval/workload_eval.py's regression gate). At 7
      bits the ring still gives the TM its seasonality context while the
      {value, delta} pair dominates the code — the gate holds with F1
      above the scalar baseline (reports/workloads_r09.json). This is the
      paper's composite-encoder weighting rule: bits are allocated by
      field importance, not uniformly.
    """
    base = cluster_preset(perm_bits=perm_bits)
    del n_event_classes_hint  # documentation-only: the encoder is table-free
    return dataclasses.replace(
        base,
        n_fields=3,
        composite=CompositeEncoderConfig(fields=(
            FieldSpec(name="value", kind="rdse", size=128, active_bits=11,
                      resolution=value_resolution),
            FieldSpec(name="delta", kind="delta", size=128, active_bits=11,
                      resolution=value_resolution),
            FieldSpec(name="event_class", kind="categorical", size=128,
                      active_bits=11),
        )),
        date=DateConfig(time_of_day_width=7, time_of_day_size=54,
                        weekend_width=0),
    )


def categorical_preset(perm_bits: int = 16) -> ModelConfig:
    """Single-field categorical model (event-class / log-template streams):
    the cluster_preset footprint with the one value field encoded as a
    hash-bucketed categorical — the eval config for the categorical and
    log-template NAB-style modalities (eval/workload_eval.py)."""
    base = cluster_preset(perm_bits=perm_bits)
    return dataclasses.replace(
        base,
        composite=CompositeEncoderConfig(fields=(
            FieldSpec(name="event_class", kind="categorical", size=128,
                      active_bits=11),
        )),
    )


def cluster_preset(perm_bits: int = 16) -> ModelConfig:
    """Small-footprint model for 1k-100k concurrent streams per device.

    Per-stream device memory dominates at that stream count. Honest
    footprint: measure with models/state.state_nbytes, which sums the
    actual arrays.

    The SP pool is the sparse member-index layout
    (``sparse_pool``; P = 64 of 128 inputs per column — SDR capacity rides
    sparsity, not pool width, PAPERS.md 1503.07469) and the TM segment pool
    is right-sized from live occupancy evidence (obs/health occupancy
    histograms + reports/sparse_quality.json: single-metric streams leave
    most of the old 4-segment lanes empty) to 2 segments/cell with LRU
    eviction unchanged. Current measured state_nbytes totals — presyn
    narrows to int16 and seg_pot to int16 automatically (num_cells = 2048
    here), independent of perm_bits:

    - perm_bits=0  (f32 perms):  433,173 B/stream (was 826 KB dense)
    - perm_bits=16 (u16 quanta): 302,101 B/stream (was 564,245 B: -46%)
    - perm_bits=8  (u8 quanta):  236,565 B/stream (was 433,173 B)

    The earlier dense geometry survives as :func:`dense_cluster_preset`
    (checkpoint migration source, quality A/B baseline, frozen golden).
    """
    return ModelConfig(
        rdse=RDSEConfig(size=128, active_bits=11, resolution=0.5),
        date=DateConfig(time_of_day_width=0, time_of_day_size=0, weekend_width=0),
        sp=SPConfig(columns=256, potential_pct=0.5, sparse_pool=True,
                    num_active_columns=10,
                    syn_perm_active_inc=0.01, syn_perm_inactive_dec=0.002,
                    perm_bits=perm_bits),
        # activation_threshold/new_synapse_count ratio 5/10: a learned segment
        # samples one winner cell from each of the 10 active columns, and
        # activates on half of them recurring — measured on the fault-injection
        # eval, the old brittle 7/8 ratio left steady-state raw ~0.23 (p90 =
        # 0.9, i.e. frequent full bursts) vs 0.06 (p90 = 0.2) here, and f1
        # 0.44 -> 0.61 (eval/fault_eval.py, 40 streams x 1000 s).
        # learn_cap 64: the round-4 replay drive caught learn_cap=32
        # truncating learning bursts on the default synthetic workload
        # (tm_overflow_total=2 at magnitude 6; 48 clears it — kept at 64 for
        # headroom, the [learn_cap, M] workspace is tiny next to the pools)
        # max_segments_per_cell 2 (was 4): the compact right-sizing half of
        # the sparse-pool change — a knob-only change (no format change); the occupancy
        # evidence and the F1 A/B vs the dense baseline are committed in
        # reports/sparse_quality.json
        tm=TMConfig(cells_per_column=8, activation_threshold=5, min_threshold=4,
                    max_segments_per_cell=2, max_synapses_per_segment=12,
                    new_synapse_count=10, learn_cap=64, col_cap=10,
                    perm_bits=perm_bits),
        # probation 400: false-alert episodes cluster in ticks 150-400 with
        # the short round-2 probation (the tiny model is still maturing when
        # the likelihood starts firing) — measured 56 of 75 false episodes
        # landed there.
        likelihood=LikelihoodConfig(mode="streaming", historic_window_size=512,
                                    learning_period=300, estimation_samples=100),
    )


def dense_cluster_preset(perm_bits: int = 16) -> ModelConfig:
    """The earlier cluster preset: dense SP pool (potential mask at
    pct 0.8) and 4-segment TM lanes — 564,245 B/stream at u16.

    Kept verbatim because committed artifacts stand on it: the frozen
    quantized golden (tests/golden), the dense-layout checkpoint fixture
    the migration test restores (docs/MIGRATION.md), and the quality A/B
    baseline the sparse preset is measured against
    (reports/sparse_quality.json). New deployments should use
    :func:`cluster_preset`; dense checkpoints upgrade via
    ``load_group(..., sparsify=True)`` (service/checkpoint.py)."""
    base = cluster_preset(perm_bits=perm_bits)
    return dataclasses.replace(
        base,
        sp=dataclasses.replace(base.sp, potential_pct=0.8, sparse_pool=False),
        tm=dataclasses.replace(base.tm, max_segments_per_cell=4),
    )


def scaled_cluster_preset(columns: int, perm_bits: int = 16) -> ModelConfig:
    """Cluster preset rescaled to `columns` SP width at the preset's ~3.9%
    activation sparsity, the learned-segment geometry tracking the winner
    count (one sampled winner per active column; activation on half
    recurring — the preset's measured ratio, see cluster_preset's TMConfig
    comment).

    Measured at production scale (scripts/model_size_eval.py,
    reports/model_size_quality.json, 120 x 1500 fault eval): the
    256-column preset is heavily over-parameterized for node-metric
    streams — 128 cols scores f1 0.804, 64 cols 0.771, and 32 cols
    (70.5 KB/stream, 1/8 the state) 0.813, the best of all measured
    configs, vs the preset's 0.789. Size reduction preserves quality far
    better than cadence thinning. Caveat: synthetic node-metric workload;
    richer signals may need the width."""
    base = cluster_preset(perm_bits=perm_bits)
    # round-half-up (not banker's): 64 cols must give k=3, preserving ~the
    # preset's sparsity; and the activation ratio stays ~half of k — at
    # banker's k=2 the geometry degenerated to a 2-of-2 perfect-match
    # requirement, which confounded the first quarter-model measurement
    k = max(3, _round_half_up(columns * base.sp.num_active_columns
                              / base.sp.columns))
    _guard_segment_capacity("scaled_cluster_preset", columns, k,
                            base.tm.max_synapses_per_segment)
    return dataclasses.replace(
        base,
        sp=dataclasses.replace(base.sp, columns=columns, num_active_columns=k),
        tm=dataclasses.replace(base.tm,
                               activation_threshold=max(2, k // 2),
                               min_threshold=max(1, k // 2 - 1),
                               new_synapse_count=k, col_cap=k),
    )
