"""Per-alert provenance: which encoder fields drove an anomaly alert.

The port's copy of the JAX package's ``service/attribution.py``; its two
bucket functions (:func:`rdse_bucket`, :func:`scalar_bucket`) are copies of
the JAX package's oracle encoders' (the oracle itself is not ported).

The paper's premise is alerts that arrive *before* failure; an operator
acting on one needs to know WHICH of a node's fused metrics (cpu? mem?
net?) moved. SDR semantics make that decodable ("Properties of Sparse
Distributed Representations" / "Encoding Data for HTM Systems",
PAPERS.md): each field owns a disjoint encoder bit range, the RDSE maps
value -> bucket ``b`` -> bits ``{hash(b + k) : k < w}``, and buckets
``b0``, ``b1`` share exactly ``max(0, w - |b1 - b0|)`` hash keys — SDR
overlap decays linearly with bucket distance, BY CONSTRUCTION. So a
field whose consecutive-tick encodings stopped overlapping is a field
whose representation jumped, and the anomalous columns (active but
unpredicted) inherit that novelty through their field-segment potential
pools.

:class:`AlertAttributor` decodes in this encoder key-space: per alerting
stream it compares the current tick's per-field bucket against the
previous tick's, converts bucket distance to lost-overlap fraction
``min(1, |Δbucket| / w)``, and reports the top-k fields by normalized
contribution. The offset term of the bucket map cancels in the
difference, so no per-stream encoder state needs fetching from the
device — attribution costs one O(n_fields) numpy pass per ALERTING
stream plus one per-group history copy per tick, and is exact in
key-space (the per-tick column masks never reach the host from the
chunked device scan, so column-level decoding post-hoc is not possible
without changing the compiled step; the key-space decode is the same
overlap those columns see).

Enabled by ``serve --alert-attribution``; alert JSONL lines gain
``"top_fields": [{"field": i, "contribution": c, "bucket_delta": d},
...]`` (empty list on the first tick a stream is seen, or when nothing
moved — e.g. a purely temporal/date-driven anomaly).
"""

from __future__ import annotations

import numpy as np

from rtap_tpu_torch.config import RDSE_BUCKET_CLAMP, ModelConfig, ScalarEncoderConfig

__all__ = ["AlertAttributor", "rdse_bucket", "scalar_bucket"]


def rdse_bucket(value: float | np.ndarray, offset: float | np.ndarray,
                resolution: float) -> np.ndarray:
    """Bucket index: round((value - offset) / resolution), clamped to
    +-RDSE_BUCKET_CLAMP, in float32 end to end like the encoders."""
    v = np.asarray(value, np.float32)
    off = np.asarray(offset, np.float32)
    res = np.float32(resolution)
    # an f32 divide may overflow to inf for wild values: inf clamps to the
    # bound, as in the device encoder
    with np.errstate(over="ignore"):
        b = np.clip(np.round((v - off) / res), -RDSE_BUCKET_CLAMP, RDSE_BUCKET_CLAMP)
    return b.astype(np.int64)


def scalar_bucket(value: float | np.ndarray, cfg: ScalarEncoderConfig) -> np.ndarray:
    """Classic ScalarEncoder bucket: clip into [min, max], then
    round((v - min) * (size - width) / range), all in float32."""
    v = np.clip(np.asarray(value, np.float32), np.float32(cfg.min_val),
                np.float32(cfg.max_val))
    scale = np.float32(cfg.size - cfg.width) / (np.float32(cfg.max_val)
                                                 - np.float32(cfg.min_val))
    return np.round((v - np.float32(cfg.min_val)) * scale).astype(np.int64)

#: LRU bound on tracked routing tuples. Sized an order of magnitude
#: above any feasible live fleet (100k streams at G=1024 is ~100
#: groups) — so in practice only RETIRED
#: tuples (membership-rebuild churn) are ever evicted; a fleet that
#: somehow exceeds the cap degrades to empty top_fields and counts it
#: in ``live_evictions`` instead of hiding it.
_MAX_TRACKED_ROUTES = 8192


class AlertAttributor:
    """Stateful per-field novelty decoder for alert provenance.

    One instance serves the whole loop: history is keyed by the emission
    routing's id tuple (one entry per group; rebuilt snapshots age out),
    and the previous-value row carries the last FINITE value per field —
    a missing sample must not erase the baseline the next real value is
    judged against.
    """

    def __init__(self, cfg: ModelConfig, top_k: int = 3):
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1; got {top_k}")
        self.cfg = cfg
        self.top_k = int(top_k)
        if cfg.composite is not None:
            # composite family: per-field kinds and geometry;
            # alerts name the spiked FIELD by its declared name. Delta
            # fields compare consecutive ENCODED deltas, which needs a
            # 2-deep value history (base and base2 below).
            self._names = [name for name, _k, _o, _s in cfg.field_layout()]
            self._kinds = [f.kind for f in cfg.composite.fields]
            self._ws = np.array([f.active_bits for f in cfg.composite.fields],
                                np.int64)
            self._ress = np.array(
                [np.float32(r) for r in cfg.field_resolutions()], np.float32)
            self._cclamps = np.array(
                [f.categorical_clamp() for f in cfg.composite.fields],
                np.int64)
            self._w = int(self._ws.max())  # uniform-path fields unused
        elif cfg.scalar is not None:
            self._w = int(cfg.scalar.width)
        else:
            self._w = int(cfg.rdse.active_bits)
            # same f32 rounding as the encoder's own resolution path
            self._res = float(np.float32(cfg.rdse.resolution))
        self._prev: dict[tuple, tuple] = {}
        self._calls = 0
        #: evictions of recently-updated (plausibly live) routes — stays
        #: 0 unless the fleet exceeds _MAX_TRACKED_ROUTES groups
        self.live_evictions = 0

    def _bucket_delta(self, cur: np.ndarray, base: np.ndarray) -> np.ndarray:
        """Per-field bucket distance between two value rows.

        RDSE: computed directly as round((cur - base)/res) — subtracting
        FIRST is what makes the offset cancel exactly AND keeps f32
        precision (round(cur/res) - round(base/res) loses small moves on
        large-magnitude baselines and saturates at the ±2^30 bucket
        clamp, zeroing the attribution of the very field that spiked).
        Scalar encoder: bucket difference after the range clip (the
        clipped domain is small by construction)."""
        if self.cfg.scalar is not None:
            return (scalar_bucket(cur, self.cfg.scalar)
                    - scalar_bucket(base, self.cfg.scalar))
        return rdse_bucket(cur, base, self._res)

    def update_and_attribute(self, stream_ids: list[str],
                             values: np.ndarray,
                             alert_idx: np.ndarray) -> dict[int, list[dict]]:
        """Advance per-stream history one tick; attribute the alerts.

        `values` is the emission batch's value block ([n] or
        [n, n_fields], aligned with `stream_ids`); `alert_idx` the
        indices whose alert fired. Returns {index: top_fields list}.
        """
        self._calls += 1
        composite = self.cfg.composite is not None
        vals = np.asarray(values, np.float32)
        if vals.ndim == 1:
            vals = vals[:, None]
        key = tuple(stream_ids)
        entry = self._prev.get(key)
        prev = entry[0] if entry is not None else None
        prev2 = entry[1] if (composite and entry is not None) else None
        if prev is not None and prev.shape != vals.shape:
            prev = prev2 = None  # field-shape change: restart history
        # carry the last finite value forward per field: NaN gaps keep
        # the pre-gap baseline (the encoder's missing-sample semantics)
        if prev is None:
            carried = vals.copy()
        else:
            carried = np.where(np.isfinite(vals), vals, prev)
        # composite keeps 2-deep history (delta fields compare consecutive
        # ENCODED deltas, which needs the tick-before-base row too); the
        # last tuple element is always the LRU clock
        self._prev[key] = (carried, prev, self._calls) if composite \
            else (carried, self._calls)
        if len(self._prev) > _MAX_TRACKED_ROUTES:
            # LRU prune (rare: only route churn beyond the cap reaches
            # here). An evicted entry updated within the last cap-worth
            # of calls was plausibly a LIVE group's — count it loudly.
            items = sorted(self._prev.items(), key=lambda kv: kv[1][-1])
            drop = items[: len(items) - _MAX_TRACKED_ROUTES]
            floor = self._calls - _MAX_TRACKED_ROUTES
            self.live_evictions += sum(1 for _, v in drop if v[-1] >= floor)
            self._prev = dict(items[len(drop):])
        out: dict[int, list[dict]] = {}
        for g in np.asarray(alert_idx).ravel():
            g = int(g)
            if prev is None:
                out[g] = []
                continue
            cur, base = vals[g], prev[g]
            if composite:
                base2 = prev2[g] if prev2 is not None else None
                db, novelty = self._composite_novelty(cur, base, base2)
                ws = self._ws
            else:
                finite = np.isfinite(cur) & np.isfinite(base)
                db = np.zeros(cur.shape[0], np.int64)
                if finite.any():
                    db[finite] = self._bucket_delta(cur[finite], base[finite])
                novelty = np.minimum(np.abs(db), self._w) / float(self._w)
                ws = None
            total = float(novelty.sum())
            if total <= 0.0:
                out[g] = []
                continue
            order = np.argsort(-novelty, kind="stable")[: self.top_k]
            out[g] = [
                {"field": int(f),
                 # composite alerts name the spiked FIELD, not just its
                 # wire dimension
                 **({"name": self._names[int(f)]} if composite else {}),
                 "contribution": round(float(novelty[f] / total), 4),
                 "bucket_delta": int(db[f])}
                for f in order if novelty[f] > 0.0
            ]
        return out

    def _composite_novelty(self, cur: np.ndarray, base: np.ndarray,
                           base2: np.ndarray | None):
        """Per-field (bucket_delta, lost-overlap novelty) for a composite
        config: rdse fields decode exactly like the uniform family (at
        their own resolution/width); CATEGORICAL fields are all-or-
        nothing (distinct ids share no hash keys, so any id change is
        full novelty); DELTA fields compare this tick's encoded first
        difference against the previous tick's — which needs the
        2-deep history (no base2 yet -> no verdict for that field)."""
        F = len(self._kinds)
        db = np.zeros(F, np.int64)
        nov = np.zeros(F, np.float64)
        for f, kind in enumerate(self._kinds):
            c, b = float(cur[f]), float(base[f])
            if not (np.isfinite(c) and np.isfinite(b)):
                continue
            w = int(self._ws[f])
            res = float(self._ress[f])
            if kind == "categorical":
                # decode through the ENCODER's id clamp: two ids that
                # clip to the same category produce bit-identical SDRs
                # (categorical_bits), so they must not attribute as a
                # field change
                clamp = int(self._cclamps[f])
                cc = min(max(int(rdse_bucket(c, 0.0, res)), -clamp), clamp)
                bb = min(max(int(rdse_bucket(b, 0.0, res)), -clamp), clamp)
                d = cc - bb
                db[f] = d
                nov[f] = 1.0 if d else 0.0
            elif kind == "delta":
                if base2 is None or not np.isfinite(base2[f]):
                    continue
                d_cur = float(np.float32(c) - np.float32(b))
                d_prev = float(np.float32(b) - np.float32(base2[f]))
                # subtract-first like the rdse path: the shared baseline
                # term cancels exactly in f32
                db[f] = int(rdse_bucket(d_cur, d_prev, res))
                nov[f] = min(abs(int(db[f])), w) / float(w)
            else:  # rdse
                db[f] = int(rdse_bucket(c, b, res))
                nov[f] = min(abs(int(db[f])), w) / float(w)
        return db, nov
