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

