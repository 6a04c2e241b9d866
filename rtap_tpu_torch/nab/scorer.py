"""NAB (Numenta Anomaly Benchmark) scorer, numpy only.

A copy of the JAX package's ``nab/scorer.py``, a reimplementation of the
published NAB scoring:

- Each labeled anomaly has a window; the FIRST detection inside a window
  earns a true-positive credit weighted by a scaled sigmoid of its relative
  position (early detection -> credit near +1, at window end -> 0). Later
  detections inside the same window are ignored.
- A detection outside any window is a false positive: negative credit, -1.0
  if before any window, else a sigmoid decay based on distance from the
  preceding window's right edge (capped at -1 beyond 3 window-widths).
- A window with no detection is a false negative: costs fn_weight.
- Rows within the probationary period (15% of min(T, 5000)) are ignored.
- The corpus score uses ONE threshold optimized over the whole corpus, then
  is normalized 100 * (raw - null) / (perfect - null), where null = no
  detections and perfect = first-row-of-window detections with no FPs.

Weights per the three published profiles (standard / reward_low_FP /
reward_low_FN).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CostProfile:
    name: str
    tp_weight: float
    fp_weight: float
    fn_weight: float


PROFILES = {
    "standard": CostProfile("standard", 1.0, 0.11, 1.0),
    "reward_low_FP": CostProfile("reward_low_FP", 1.0, 0.22, 1.0),
    "reward_low_FN": CostProfile("reward_low_FN", 1.0, 0.11, 2.0),
}

PROBATION_PERCENT = 0.15
PROBATION_CAP = 5000


def probation_rows(n_rows: int) -> int:
    return int(PROBATION_PERCENT * min(n_rows, PROBATION_CAP))


def scaled_sigmoid(rel_pos: np.ndarray | float) -> np.ndarray | float:
    """NAB's scaled sigmoid: +0.9866 at window start (-1), 0 at window end (0),
    decaying to -1 for positions after the window; flat -1 beyond rel_pos 3."""
    rel = np.asarray(rel_pos, dtype=np.float64)
    val = 2.0 / (1.0 + np.exp(5.0 * np.minimum(rel, 4.0))) - 1.0
    val = np.where(rel > 3.0, -1.0, val)
    return float(val) if np.isscalar(rel_pos) else val


def _window_indices(
    timestamps: np.ndarray, windows: list[tuple[int, int]]
) -> list[tuple[int, int]]:
    """Convert unix-second windows to [left_idx, right_idx] inclusive row spans."""
    out = []
    for a, b in windows:
        idx = np.nonzero((timestamps >= a) & (timestamps <= b))[0]
        if len(idx):
            out.append((int(idx[0]), int(idx[-1])))
    return out


def score_file(
    detections: np.ndarray,
    timestamps: np.ndarray,
    windows: list[tuple[int, int]],
    profile: CostProfile,
) -> float:
    """Raw NAB score of one file given binary detections per row."""
    spans = _window_indices(timestamps, windows)
    return _score_spans(detections, spans, profile)


def _score_spans(
    detections: np.ndarray, spans: list[tuple[int, int]], profile: CostProfile
) -> float:
    """Raw score given precomputed window row-spans (hot path of the sweep)."""
    n = len(detections)
    prob = probation_rows(n)
    det_idx = np.nonzero(detections)[0]
    det_idx = det_idx[det_idx >= prob]

    score = 0.0
    credited: set[int] = set()
    for i in det_idx:
        in_window = False
        for w_i, (l, r) in enumerate(spans):
            if l <= i <= r:
                in_window = True
                if w_i not in credited:
                    credited.add(w_i)
                    width = max(r - l, 1)
                    rel = (i - r) / width  # -1 at left edge, 0 at right edge
                    score += profile.tp_weight * scaled_sigmoid(rel)
                break
        if not in_window:
            # FP: sigmoid decay from preceding window's right edge; -1 before any
            prev = [(l, r) for (l, r) in spans if r < i]
            if prev:
                l, r = prev[-1]
                width = max(r - l, 1)
                rel = (i - r) / width  # > 0
                score += profile.fp_weight * scaled_sigmoid(rel)
            else:
                score += profile.fp_weight * -1.0
    # FNs
    score -= profile.fn_weight * (len(spans) - len(credited))
    return score


def _prepare(
    per_file: list[tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]],
    profile: CostProfile,
) -> tuple[list[tuple[np.ndarray, list[tuple[int, int]]]], float, float]:
    """Precompute threshold-independent state: row spans + perfect/null totals."""
    prepped, perfect, null = [], 0.0, 0.0
    for scores, ts, windows in per_file:
        spans = _window_indices(ts, windows)
        prepped.append((scores, spans))
        perfect += profile.tp_weight * scaled_sigmoid(-1.0) * len(spans)
        null += -profile.fn_weight * len(spans)
    return prepped, perfect, null


def score_corpus(
    per_file: list[tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]],
    threshold: float,
    profile: CostProfile,
) -> float:
    """Normalized corpus score (0-100 scale; null=0, perfect=100) at a fixed
    threshold. `per_file` entries are (anomaly_scores, timestamps, windows)."""
    prepped, perfect, null = _prepare(per_file, profile)
    if perfect == null:
        return 0.0
    raw = sum(_score_spans(s >= threshold, spans, profile) for s, spans in prepped)
    return 100.0 * (raw - null) / (perfect - null)


def optimize_threshold(
    per_file: list[tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]],
    profile: CostProfile,
    max_candidates: int | None = None,
) -> tuple[float, float]:
    """EXHAUSTIVE threshold sweep over every distinct anomaly score (NAB's
    sweeper semantics) -> (best_threshold, best_normalized_score).

    Implemented as one descending-score incremental pass, O(n log n) over
    the pooled corpus instead of O(n) full re-scores per candidate: walking
    thresholds downward only ever ADDS detections, so each row contributes
    a precomputable delta — an FP row its (static) sigmoid cost, a window
    row an upgrade of its window's credit (windows never overlap in NAB,
    so the earliest active row in a window is also the max-credit one, and
    a window's first activation also cancels its FN cost). Equivalence
    with the direct per-threshold scorer is tested against `score_corpus`
    on randomized corpora.

    `max_candidates` is accepted for the reference's signature and
    ignored: the sweep is always exhaustive.
    """
    del max_candidates
    prepped, perfect, null = _prepare(per_file, profile)
    n_windows = sum(len(spans) for _, spans in prepped)

    # flatten: for each post-probation row, (score, window_key or None,
    # contribution). Window rows carry their credit; FP rows their cost.
    rows: list[tuple[float, int, float]] = []  # (score, kind/window id, value)
    FP = -1  # kind marker for non-window rows
    wid = 0
    for scores, spans in prepped:
        prob = probation_rows(len(scores))
        file_wids = list(range(wid, wid + len(spans)))
        wid += len(spans)
        # NaN scores can never satisfy `score >= t` in the direct scorer,
        # so they are excluded from the walk the same way
        for i in np.nonzero(~np.isnan(scores))[0]:
            if i < prob:
                continue
            placed = False
            for w_local, (l, r) in enumerate(spans):
                if l <= i <= r:
                    width = max(r - l, 1)
                    credit = profile.tp_weight * scaled_sigmoid((i - r) / width)
                    rows.append((float(scores[i]), file_wids[w_local], credit))
                    placed = True
                    break
            if not placed:
                prev = [(l, r) for (l, r) in spans if r < i]
                if prev:
                    l, r = prev[-1]
                    width = max(r - l, 1)
                    cost = profile.fp_weight * scaled_sigmoid((i - r) / width)
                else:
                    cost = -profile.fp_weight
                rows.append((float(scores[i]), FP, cost))

    if perfect == null:
        return 1.1, 0.0

    def normalize(raw: float) -> float:
        return 100.0 * (raw - null) / (perfect - null)

    # descending-score walk; snapshot after each distinct score value
    rows.sort(key=lambda t: -t[0])
    running = -profile.fn_weight * n_windows  # nothing detected
    best_t, best_s = 1.1, normalize(running)
    window_credit: dict[int, float] = {}
    i = 0
    while i < len(rows):
        v = rows[i][0]
        while i < len(rows) and rows[i][0] == v:
            _, kind, val = rows[i]
            if kind == FP:
                running += val
            elif kind not in window_credit:
                window_credit[kind] = val
                running += profile.fn_weight + val  # cancel FN, add credit
            elif val > window_credit[kind]:
                running += val - window_credit[kind]
                window_credit[kind] = val
            i += 1
        s = normalize(running)
        if s > best_s:
            best_t, best_s = v, s
    return best_t, best_s
