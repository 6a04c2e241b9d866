"""Synthetic cluster-metric generator with labeled fault injection.

Replaces the reference's monitored cluster + fault-injection rig (SURVEY.md
C17/C21 and §3.5): instead of stressing a live Kubernetes deployment with
cpu-burn / tc-netem / node-kill, we synthesize per-node per-metric time
series (diurnal sine + noise, metric-specific baselines) and inject labeled
anomalies — spike, level shift, drift, stuck-at, dropout — recording ground
-truth windows in NAB's `combined_windows.json` shape. Deterministic per
(seed, stream id): the same corpus regenerates bit-identically anywhere.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np

from rtap_tpu_torch.utils.hashing import hash_u32_np

ANOMALY_KINDS = ("spike", "level_shift", "drift", "stuck", "dropout")

# Per-metric (baseline, diurnal amplitude, noise sigma, clip range)
METRIC_PROFILES = {
    "cpu": (35.0, 20.0, 3.0, (0.0, 100.0)),
    "mem": (55.0, 10.0, 1.5, (0.0, 100.0)),
    "net": (20.0, 15.0, 5.0, (0.0, None)),
    "disk_io": (10.0, 6.0, 2.5, (0.0, None)),
    "latency_ms": (12.0, 4.0, 2.0, (0.0, None)),
}


@dataclass(frozen=True)
class SyntheticStreamConfig:
    length: int = 4000
    cadence_s: float = 1.0
    metric: str = "cpu"
    period_s: float = 86400.0  # diurnal
    n_anomalies: int = 3
    anomaly_magnitude: float = 4.0  # in units of (scaled) noise sigma
    noise_scale: float = 1.0  # multiplier on the metric's noise sigma
    # AR(1) coefficient of the noise: real node metrics are autocorrelated
    # (load moves smoothly), not white. 0 = iid Gaussian (legacy default);
    # ~0.85 makes per-tick deltas small relative to the stationary sigma, the
    # regime where an HTM at NAB-rule resolution can learn the baseline.
    noise_phi: float = 0.0
    # which fault kinds to inject; "drift" and "stuck" are near-invisible to
    # point-anomaly detectors by design (gradual / too-regular) — include them
    # only when evaluating that hard class
    kinds: tuple[str, ...] = ANOMALY_KINDS
    start_unix: int = 1_700_000_000
    # earliest injection point, as a fraction of the stream. Evaluations set
    # this past the detector's likelihood probation (a fault injected while
    # the likelihood is still flat-0.5 is undetectable by construction and
    # would poison recall with a measurement artifact, not a detector miss).
    inject_after_frac: float = 0.25
    # Signal family. "diurnal" is the original sine+AR(1) generator every
    # committed quality figure was tuned on. "heldout" is a deliberately
    # DIFFERENT world for external validation (r4 verdict: the 32-col
    # density headline's quality evidence was self-referential): Student-t
    # heavy-tailed innovations, 2-state volatility bursts, a per-stream
    # linear trend, and UNLABELED benign level shifts (regime switches the
    # detector must absorb, not alert on). Fault injection/labeling is
    # shared between families; magnitudes stay anchored to the metric's
    # NOMINAL sigma so "6-sigma" means the same thing in both worlds.
    family: str = "diurnal"


@dataclass(frozen=True)
class FaultEvent:
    """Ground truth for one injected fault (SURVEY.md §3.5 eval unit)."""

    kind: str  # one of ANOMALY_KINDS
    onset: int  # unix sec the fault begins
    end: int  # unix sec the injected interval ends
    window: tuple[int, int]  # labeled detection window (onset/end + margin)


@dataclass
class LabeledStream:
    """One generated stream: values + ground-truth anomaly windows."""

    stream_id: str
    timestamps: np.ndarray  # int64 unix seconds, [T]
    values: np.ndarray  # float32, [T]
    windows: list[tuple[int, int]] = field(default_factory=list)  # unix-sec spans
    events: list[FaultEvent] = field(default_factory=list)  # kind-labeled faults


def _rng_for(seed: int, stream_id: str) -> np.random.Generator:
    # zlib.crc32 is process-independent (unlike builtin hash with its salt),
    # keeping the "regenerates bit-identically anywhere" contract.
    sid_hash = int(hash_u32_np(np.uint32(zlib.crc32(stream_id.encode())), seed))
    return np.random.Generator(np.random.Philox(key=(seed, sid_hash)))


def _inject(
    signal: np.ndarray, t_unix: np.ndarray, rng: np.random.Generator,
    cfg: SyntheticStreamConfig, sigma: float, kind: str, c: int, dur: int,
) -> tuple[tuple[int, int], FaultEvent]:
    """Inject one `kind` fault centered at index `c` into `signal` in place;
    -> (window, event). Extracted verbatim from generate_stream so the
    per-stream and per-node generators share one fault vocabulary (and
    generate_stream's rng draw order — the bit-identical-regeneration
    contract — is unchanged)."""
    s, e = int(c), min(int(c) + dur, len(signal) - 1)
    mag = cfg.anomaly_magnitude * sigma
    if kind == "spike":
        signal[s : s + max(1, dur // 4)] += mag * rng.choice([-1.0, 1.0])
    elif kind == "level_shift":
        signal[s:] += mag * rng.choice([-1.0, 1.0])
    elif kind == "drift":
        ramp = np.linspace(0.0, mag, e - s)
        signal[s:e] += ramp
        signal[e:] += mag
    elif kind == "stuck":
        signal[s:e] = signal[s]
    elif kind == "dropout":
        signal[s:e] = 0.0
    margin = max(2, dur // 2)
    win = (int(t_unix[max(0, s - margin)]), int(t_unix[min(len(signal) - 1, e + margin)]))
    return win, FaultEvent(kind, int(t_unix[s]), int(t_unix[e]), win)


def _heldout_base(
    rng: np.random.Generator, cfg: SyntheticStreamConfig, base: float,
    amp: float, sigma: float, t_idx: np.ndarray, phase: float,
) -> np.ndarray:
    """Held-out-family base signal (no faults yet): heavy-tailed bursty
    AR noise + diurnal + trend + unlabeled benign regime switches.

    - Innovations are Student-t (df=3, scaled to unit variance): real ops
      metrics have far heavier tails than the Gaussian the tuned-on family
      uses, so likelihood tails face in-distribution outliers.
    - A 2-state volatility chain (calm sigma / 2.5x burst sigma, mean dwell
      ~200/40 ticks) makes variance non-stationary.
    - A per-stream linear trend (+-[0.5, 2] sigma over the stream) breaks
      the stationary-baseline assumption.
    - 1-3 benign level shifts of +-(1..1.5) sigma at random times are NOT
      labeled: a regime switch the detector must absorb. They are kept
      below fault scale (faults sweep 2-6 sigma) but are real precision
      hazards for over-sensitive configs.
    """
    n = len(t_idx)
    innov = rng.standard_t(3, n) / np.sqrt(3.0)
    # volatility chain: geometric dwell times, calm <-> burst
    vol = np.empty(n, np.float64)
    i, burst = 0, False
    while i < n:
        dwell = int(rng.geometric(1.0 / (40.0 if burst else 200.0)))
        vol[i : i + dwell] = 2.5 if burst else 1.0
        i += dwell
        burst = not burst
    phi = max(cfg.noise_phi, 0.9)  # smooth like real node metrics
    noise = np.empty(n, np.float64)
    prev = 0.0
    scaled = innov * vol * sigma * np.sqrt(1.0 - phi * phi)
    for j in range(n):
        prev = phi * prev + scaled[j]
        noise[j] = prev
    slope_total = rng.uniform(0.5, 2.0) * sigma * rng.choice([-1.0, 1.0])
    trend = slope_total * (t_idx / max(n - 1, 1))
    regime = np.zeros(n, np.float64)
    for _ in range(int(rng.integers(1, 4))):
        at = int(rng.integers(int(n * 0.1), n - 1))
        regime[at:] += rng.uniform(1.0, 1.5) * sigma * rng.choice([-1.0, 1.0])
    return (
        base
        + amp * np.sin(2 * np.pi * t_idx * cfg.cadence_s / cfg.period_s + phase)
        + trend + regime + noise
    )


def generate_stream(
    stream_id: str, cfg: SyntheticStreamConfig, seed: int = 0
) -> LabeledStream:
    """Generate one labeled stream.

    The base signal is baseline + diurnal sine (phase hashed from stream id)
    + Gaussian noise; `cfg.n_anomalies` injections are placed in the
    post-probation region with jittered spacing, each a random kind from
    ANOMALY_KINDS. Window labels span the injected interval plus a small
    margin, mirroring how NAB windows surround each anomaly.
    """
    rng = _rng_for(seed, stream_id)
    base, amp, sigma, clip = METRIC_PROFILES.get(cfg.metric, METRIC_PROFILES["cpu"])
    sigma = sigma * cfg.noise_scale
    t_idx = np.arange(cfg.length, dtype=np.float64)
    t_unix = (cfg.start_unix + t_idx * cfg.cadence_s).astype(np.int64)
    phase = rng.uniform(0, 2 * np.pi)
    if cfg.family == "heldout":
        signal = _heldout_base(rng, cfg, base, amp, sigma, t_idx, phase)
    elif cfg.family == "diurnal":
        # draw order below is the bit-identical-regeneration contract for
        # every committed artifact — never reorder
        noise = rng.normal(0.0, sigma, cfg.length)
        if cfg.noise_phi > 0.0:
            # AR(1), stationary std == sigma: x_t = phi*x_{t-1} + eps*sqrt(1-phi^2)
            noise *= np.sqrt(1.0 - cfg.noise_phi**2)
            for i in range(1, cfg.length):
                noise[i] += cfg.noise_phi * noise[i - 1]
        signal = (
            base
            + amp * np.sin(2 * np.pi * t_idx * cfg.cadence_s / cfg.period_s + phase)
            + noise
        )
    else:
        raise ValueError(f"unknown signal family {cfg.family!r} "
                         "(expected 'diurnal' or 'heldout')")

    windows: list[tuple[int, int]] = []
    events: list[FaultEvent] = []
    if cfg.n_anomalies > 0:
        # keep injections clear of the likelihood probation region
        lo = int(cfg.length * cfg.inject_after_frac)
        n_candidates = cfg.length - 50 - lo
        if n_candidates < cfg.n_anomalies:
            # same guard as generate_node: a degenerate candidate range would
            # otherwise surface as an opaque numpy ValueError
            raise ValueError(
                f"stream length {cfg.length} too short: the injection range "
                f"[{lo}, {cfg.length - 50}) has {max(n_candidates, 0)} candidate "
                f"centers for n_anomalies={cfg.n_anomalies}; lengthen the stream "
                "or lower inject_after_frac/n_anomalies"
            )
        centers = np.sort(rng.choice(np.arange(lo, cfg.length - 50), size=cfg.n_anomalies, replace=False))
        for c in centers:
            kind = cfg.kinds[rng.integers(len(cfg.kinds))]
            dur = int(rng.integers(5, 40))
            win, ev = _inject(signal, t_unix, rng, cfg, sigma, kind, int(c), dur)
            windows.append(win)
            events.append(ev)

    if clip[0] is not None:
        signal = np.maximum(signal, clip[0])
    if clip[1] is not None:
        signal = np.minimum(signal, clip[1])
    return LabeledStream(stream_id, t_unix, signal.astype(np.float32), windows, events)


def generate_cluster(
    n_nodes: int,
    metrics: Sequence[str] = ("cpu", "mem", "net"),
    cfg: SyntheticStreamConfig | None = None,
    seed: int = 0,
) -> list[LabeledStream]:
    """`n_nodes * len(metrics)` labeled streams, ids `node{i:05d}.{metric}`."""
    cfg = cfg or SyntheticStreamConfig()
    out = []
    for i in range(n_nodes):
        for m in metrics:
            scfg = replace(cfg, metric=m)
            out.append(generate_stream(f"node{i:05d}.{m}", scfg, seed=seed))
    return out


def cluster_streams(n_streams: int, length: int, seed: int = 0, **kw) -> list[LabeledStream]:
    """The replay's synthetic cluster data: `n_streams` streams of
    :func:`generate_cluster` (nodes of cpu/mem/net, cut to `n_streams`) with
    smooth AR(1) noise (noise_phi 0.97, noise_scale 0.5) at a 1 s cadence;
    `kw` sets further :class:`SyntheticStreamConfig` fields."""
    cfg = SyntheticStreamConfig(length=length, cadence_s=1.0, noise_phi=0.97, noise_scale=0.5,
                                **kw)
    return generate_cluster((n_streams + 2) // 3, cfg=cfg, seed=seed)[:n_streams]


@dataclass
class LogStream:
    """One synthetic log-line stream (the log-template modality):
    raw lines + ground-truth anomaly windows. Feed ``lines`` through
    :class:`rtap_tpu_torch.ingest.TemplateMiner` to get the template-id value
    stream a categorical composite field scores."""

    stream_id: str
    timestamps: np.ndarray  # int64 unix seconds, [T]
    lines: list[str]
    windows: list[tuple[int, int]] = field(default_factory=list)
    events: list[FaultEvent] = field(default_factory=list)


#: steady-state log-template pool: realistic shapes with numeric variable
#: positions (the drain-style miner masks digit-bearing tokens), one
#: format per template so mined ids are stable
_LOG_TEMPLATES = (
    "connected to host 10.0.{a}.{b} port {p}",
    "request /api/v1/items served in {ms} ms status 200",
    "heartbeat ok seq {n}",
    "cache lookup key item-{n} hit ratio 0.{r}",
    "gc pause {ms} ms heap {n} mb",
    "scheduled job sync-{n} finished rc 0",
)

#: the anomalous burst template — a structure steady state never emits
_LOG_BURST_TEMPLATE = "ERROR disk failure on volume {n} remounting read-only"


def generate_log_stream(
    stream_id: str, cfg: SyntheticStreamConfig, seed: int = 0,
) -> LogStream:
    """Seeded log-burst stream: one line per tick drawn from the steady
    template pool (numeric fields re-drawn per line, so the miner's
    masking is load-bearing), with ``cfg.n_anomalies`` bursts of the
    ERROR template injected post-probation — the log-burst workload.
    Windows label the burst spans NAB-style."""
    rng = _rng_for(seed, stream_id)
    T = cfg.length
    t_unix = (cfg.start_unix + np.arange(T) * cfg.cadence_s).astype(np.int64)
    # steady mix biased toward the first templates (realistic skew)
    weights = np.array([2.0 ** -i for i in range(len(_LOG_TEMPLATES))])
    weights /= weights.sum()
    choices = rng.choice(len(_LOG_TEMPLATES), size=T, p=weights)

    def render(i: int) -> str:
        return _LOG_TEMPLATES[choices[i]].format(
            a=rng.integers(256), b=rng.integers(256), p=rng.integers(1024, 65536),
            ms=rng.integers(1, 500), n=rng.integers(1, 100000),
            r=rng.integers(10, 99))

    lines = [render(i) for i in range(T)]
    windows: list[tuple[int, int]] = []
    events: list[FaultEvent] = []
    if cfg.n_anomalies > 0:
        lo = int(T * cfg.inject_after_frac)
        n_candidates = T - 50 - lo
        if n_candidates < cfg.n_anomalies:
            raise ValueError(
                f"stream length {T} too short for {cfg.n_anomalies} log "
                f"burst(s) past inject_after_frac={cfg.inject_after_frac}")
        centers = np.sort(rng.choice(np.arange(lo, T - 50),
                                     size=cfg.n_anomalies, replace=False))
        for c in centers:
            dur = int(rng.integers(5, 25))
            s, e = int(c), min(int(c) + dur, T - 1)
            for i in range(s, e):
                lines[i] = _LOG_BURST_TEMPLATE.format(n=rng.integers(16))
            margin = max(2, dur // 2)
            win = (int(t_unix[max(0, s - margin)]),
                   int(t_unix[min(T - 1, e + margin)]))
            windows.append(win)
            events.append(FaultEvent("log_burst", int(t_unix[s]),
                                     int(t_unix[e]), win))
    return LogStream(stream_id, t_unix, lines, windows, events)


def generate_categorical_stream(
    stream_id: str, cfg: SyntheticStreamConfig, seed: int = 0,
    n_classes: int = 6,
) -> LabeledStream:
    """Seeded event-class stream (the categorical modality): each tick
    carries a category id drawn from a skewed steady distribution over
    ``n_classes`` classes; anomalies are bursts of a NOVEL class (id ==
    n_classes, never seen in steady state) — the shape a categorical
    encoder must catch and a scalar RDSE treats as merely 'one bucket
    further'. Values are float ids ready for a categorical field."""
    rng = _rng_for(seed, stream_id)
    T = cfg.length
    t_unix = (cfg.start_unix + np.arange(T) * cfg.cadence_s).astype(np.int64)
    weights = np.array([2.0 ** -i for i in range(n_classes)])
    weights /= weights.sum()
    values = rng.choice(n_classes, size=T, p=weights).astype(np.float32)
    windows: list[tuple[int, int]] = []
    events: list[FaultEvent] = []
    if cfg.n_anomalies > 0:
        lo = int(T * cfg.inject_after_frac)
        n_candidates = T - 50 - lo
        if n_candidates < cfg.n_anomalies:
            raise ValueError(
                f"stream length {T} too short for {cfg.n_anomalies} class "
                f"burst(s) past inject_after_frac={cfg.inject_after_frac}")
        centers = np.sort(rng.choice(np.arange(lo, T - 50),
                                     size=cfg.n_anomalies, replace=False))
        for c in centers:
            dur = int(rng.integers(5, 25))
            s, e = int(c), min(int(c) + dur, T - 1)
            values[s:e] = float(n_classes)  # the novel class
            margin = max(2, dur // 2)
            win = (int(t_unix[max(0, s - margin)]),
                   int(t_unix[min(T - 1, e + margin)]))
            windows.append(win)
            events.append(FaultEvent("class_burst", int(t_unix[s]),
                                     int(t_unix[e]), win))
    return LabeledStream(stream_id, t_unix, values, windows, events)


@dataclass
class TopologyWorkload:
    """A seeded multi-service cluster with ONE cascading fault: the ground
    truth of the cascade eval (``python -m rtap_tpu_torch.predict_eval``)."""

    streams: list[LabeledStream]
    #: the faulted service name
    burst_service: str
    #: nodes hit, in cascade order
    burst_nodes: list[str]
    #: tick index each node's burst begins (cascade: onset + j * lag)
    burst_onsets: dict[str, int]
    #: burst duration in ticks (per node)
    burst_dur: int
    #: the topology spec dict ({"services": ...}) matching the stream ids
    spec: dict
    #: origin node carrying the slow-drift precursor ramp (None: no ramp)
    precursor_node: str | None = None
    #: tick the origin node's ramp begins (its onset - precursor_ticks)
    precursor_start: int | None = None


def generate_topology_workload(
    n_services: int = 3,
    nodes_per_service: int = 3,
    metrics: Sequence[str] = ("cpu", "mem"),
    cfg: SyntheticStreamConfig | None = None,
    seed: int = 0,
    burst_at_frac: float = 0.75,
    cascade_lag: int = 2,
    burst_dur: int = 8,
    burst_magnitude: float = 12.0,
    precursor_ramp: float = 0.0,
    precursor_ticks: int = 0,
) -> TopologyWorkload:
    """Seeded cascading-fault workload (the JAX package's generator, the
    same draws and bytes): per-node
    per-metric base signals (ids ``{svc}-{i:02d}.{metric}``, the
    inference-friendly naming), plus ONE deterministic multi-node burst —
    a seeded service is hit node by node (node j's burst begins
    ``cascade_lag * j`` ticks after the first) across ALL its metrics,
    the blast-radius shape exactly one cluster-level incident must
    cover. All other services stay fault-free (the false-positive
    control).

    ``precursor_ramp`` > 0 (with ``precursor_ticks`` > 0) prepends a
    slow linear drift to the ORIGIN node only — every metric climbs from
    0 to ``precursor_ramp * sigma`` over the ``precursor_ticks`` ticks
    ending at that node's burst onset (the cascade scenario: the
    predictive horizon must page on the origin's drift BEFORE the second
    node's step fault lands). The ramp is applied post-draw like the
    burst itself, so enabling it never perturbs the RNG draw order."""
    cfg = cfg or SyntheticStreamConfig(length=400, n_anomalies=0,
                                      noise_phi=0.9, noise_scale=0.3)
    if cfg.n_anomalies:
        raise ValueError(
            "generate_topology_workload owns its fault injection; pass a "
            "cfg with n_anomalies=0")
    if precursor_ramp < 0 or precursor_ticks < 0:
        raise ValueError("precursor_ramp/precursor_ticks must be >= 0")
    if (precursor_ramp > 0) != (precursor_ticks > 0):
        raise ValueError(
            "precursor_ramp and precursor_ticks arm the drift together: "
            "set both > 0 (or neither)")
    rng = _rng_for(seed, "topology-workload")
    svc_names = [f"svc{chr(ord('a') + i)}" for i in range(n_services)]
    burst_service = svc_names[int(rng.integers(n_services))]
    onset0 = int(cfg.length * burst_at_frac)
    if onset0 - precursor_ticks < 0:
        # same loud-failure discipline as the cascade-fit check below: a
        # truncated ramp would silently hand the eval a steeper (easier)
        # drift than the caller asked for
        raise ValueError(
            f"precursor ramp does not fit: onset {onset0} needs "
            f"{precursor_ticks} ramp ticks before it (lower "
            f"precursor_ticks or raise burst_at_frac/length)")
    last_onset = onset0 + cascade_lag * (nodes_per_service - 1)
    if last_onset + 2 > cfg.length - 1:
        # the last cascaded node must still get a real burst (>= 2 ticks
        # before the final tick) — fail loudly, like generate_log_stream,
        # instead of IndexError-ing on timestamps or silently emitting a
        # burst-less "burst node" that wrecks the soak's blast-radius check
        raise ValueError(
            f"cascade does not fit: last node's onset {last_onset} needs "
            f">= 2 burst ticks inside length {cfg.length} (lower "
            f"burst_at_frac/cascade_lag/nodes_per_service or raise length)")
    streams: list[LabeledStream] = []
    burst_nodes: list[str] = []
    burst_onsets: dict[str, int] = {}
    spec: dict = {"services": {}}
    for svc in svc_names:
        nodes = [f"{svc}-{i:02d}" for i in range(nodes_per_service)]
        spec["services"][svc] = nodes
        for j, node in enumerate(nodes):
            onset = onset0 + cascade_lag * j
            if svc == burst_service:
                burst_nodes.append(node)
                burst_onsets[node] = onset
            for m in metrics:
                scfg = replace(cfg, metric=m, n_anomalies=0)
                s = generate_stream(f"{node}.{m}", scfg, seed=seed)
                if svc == burst_service:
                    sigma = METRIC_PROFILES.get(
                        m, METRIC_PROFILES["cpu"])[2] * cfg.noise_scale
                    e = min(onset + burst_dur, cfg.length - 1)
                    sig = s.values.astype(np.float64)
                    sig[onset:e] += burst_magnitude * sigma
                    if precursor_ticks and j == 0:
                        # origin-node slow drift: 0 -> ramp*sigma over the
                        # ticks ending at onset (endpoint excluded — the
                        # step itself is the fault, the ramp its precursor)
                        r0 = onset - precursor_ticks
                        sig[r0:onset] += precursor_ramp * sigma * \
                            np.linspace(0.0, 1.0, precursor_ticks,
                                        endpoint=False)
                    lo_c, hi_c = METRIC_PROFILES.get(
                        m, METRIC_PROFILES["cpu"])[3]
                    if lo_c is not None:
                        sig = np.maximum(sig, lo_c)
                    if hi_c is not None:
                        sig = np.minimum(sig, hi_c)
                    s.values = sig.astype(np.float32)
                    margin = max(2, burst_dur // 2)
                    win = (int(s.timestamps[max(0, onset - margin)]),
                           int(s.timestamps[min(cfg.length - 1, e + margin)]))
                    s.windows.append(win)
                    s.events.append(FaultEvent(
                        "cascade", int(s.timestamps[onset]),
                        int(s.timestamps[e]), win))
                streams.append(s)
    return TopologyWorkload(
        streams=streams, burst_service=burst_service,
        burst_nodes=burst_nodes, burst_onsets=burst_onsets,
        burst_dur=burst_dur, spec=spec,
        precursor_node=burst_nodes[0] if precursor_ticks else None,
        precursor_start=(burst_onsets[burst_nodes[0]] - precursor_ticks)
        if precursor_ticks else None)


@dataclass
class NodeStream:
    """One node's fused multivariate stream (SURVEY.md §6 benchmark config 4:
    'multivariate per-node cpu/mem/net fused RDSE'): values [T, F] feed ONE
    HTM model with n_fields=F, versus `generate_cluster`'s one model per
    node-metric."""

    node_id: str
    metrics: tuple[str, ...]
    timestamps: np.ndarray  # int64 unix seconds, [T]
    values: np.ndarray  # float32, [T, F]
    windows: list[tuple[int, int]] = field(default_factory=list)
    events: list[FaultEvent] = field(default_factory=list)
    # which metric columns each event touched, index-aligned with `events`
    event_metrics: list[tuple[str, ...]] = field(default_factory=list)


def generate_node(
    node_id: str,
    cfg: SyntheticStreamConfig,
    metrics: Sequence[str] = ("cpu", "mem", "net"),
    seed: int = 0,
    coupled_frac: float = 0.5,
    fault_metrics: Sequence[str] | None = None,
) -> NodeStream:
    """Generate one node's multivariate stream with NODE-LEVEL faults.

    Each metric gets its own clean base signal (phase/noise keyed by
    `<node_id>.<metric>`, deterministic like everything else here). Faults
    are placed once per NODE at shared times — each event hits either ALL
    metrics simultaneously (probability `coupled_frac`: the node-saturation
    shape, e.g. cpu+mem+net degrade together) or exactly one metric (a
    single-metric fault the fused model must still catch). Windows are the
    union over touched metrics; `event_metrics` records the ground truth of
    which columns moved. `fault_metrics` restricts which metrics uncoupled
    faults may land on (evaluations use it to avoid metrics whose natural
    range makes a given fault kind in-distribution, e.g. a +6-sigma spike on
    `net`, whose diurnal peak already reaches that level).
    """
    if fault_metrics is not None:
        bad = set(fault_metrics) - set(metrics)
        if bad or not fault_metrics:
            raise ValueError(
                f"fault_metrics must be a non-empty subset of metrics {tuple(metrics)}; "
                f"got {tuple(fault_metrics)}"
            )
    n_anom = cfg.n_anomalies
    # A too-short stream makes the fault-center draw below degenerate (empty
    # or undersized candidate range -> opaque numpy ValueError); fail with
    # the actual constraint instead (the CLI guards its own replay path, but
    # node_eval and other callers come through here).
    lo_check = int(cfg.length * cfg.inject_after_frac)
    n_candidates = cfg.length - 50 - lo_check
    if n_candidates < n_anom:
        raise ValueError(
            f"stream length {cfg.length} too short: the injection range "
            f"[{lo_check}, {cfg.length - 50}) has {max(n_candidates, 0)} candidate "
            f"centers for n_anomalies={n_anom}; lengthen the stream or lower "
            "inject_after_frac/n_anomalies"
        )
    cfg = replace(cfg, n_anomalies=0)  # per-metric injections off; node-level below
    parts = [
        generate_stream(f"{node_id}.{m}", replace(cfg, metric=m), seed=seed)
        for m in metrics
    ]
    values = np.stack([p.values for p in parts], axis=1)  # [T, F]
    t_unix = parts[0].timestamps
    rng = _rng_for(seed, node_id)

    windows: list[tuple[int, int]] = []
    events: list[FaultEvent] = []
    event_metrics: list[tuple[str, ...]] = []
    lo = int(cfg.length * cfg.inject_after_frac)
    centers = np.sort(rng.choice(np.arange(lo, cfg.length - 50), size=n_anom, replace=False))
    for c in centers:
        kind = cfg.kinds[rng.integers(len(cfg.kinds))]
        dur = int(rng.integers(5, 40))
        pool = tuple(fault_metrics) if fault_metrics is not None else tuple(metrics)
        if rng.random() < coupled_frac:
            touched = tuple(metrics)
        else:
            touched = (pool[rng.integers(len(pool))],)
        # the window is a function of (c, dur, margin) only, so every touched
        # metric of one event shares it — keep the first (win, ev) pair
        win = ev = None
        for f, m in enumerate(metrics):
            if m not in touched:
                continue
            sigma = METRIC_PROFILES.get(m, METRIC_PROFILES["cpu"])[2] * cfg.noise_scale
            col = np.ascontiguousarray(values[:, f], dtype=np.float64)
            w, e = _inject(col, t_unix, rng, replace(cfg, metric=m), sigma, kind, int(c), dur)
            win, ev = win or w, ev or e
            lo_c, hi_c = METRIC_PROFILES.get(m, METRIC_PROFILES["cpu"])[3]
            if lo_c is not None:
                col = np.maximum(col, lo_c)
            if hi_c is not None:
                col = np.minimum(col, hi_c)
            values[:, f] = col.astype(np.float32)
        windows.append(win)
        events.append(ev)
        event_metrics.append(touched)
    return NodeStream(node_id, tuple(metrics), t_unix, values, windows, events, event_metrics)
