"""PyTorch port vs the JAX package: detection latency and SLOs
(obs/latency.py, obs/slo.py).

* ``QuantileSketch``: the same observations give the same quantiles, counts
  and lossless state, across distributions and window rolls; the
  quantiles track numpy within one bucket ratio; memory is bounded.
* ``parse_slo``: the same specs and the same refusals.
* ``SloTracker`` / ``LatencyTracker``: the same observation sequences give
  the same burn, recovery and budget events, the same verdict and the same
  dump requests; ``tick_slo_pair``; the latency instrumentation costs
  under 1% of the tick budget.
"""

import numpy as np
import pytest

from rtap_tpu.obs import latency as jlat
from rtap_tpu.obs import slo as jslo
from rtap_tpu.obs.metrics import TelemetryRegistry as JReg
from rtap_tpu_torch.obs import latency, slo
from rtap_tpu_torch.obs.metrics import TelemetryRegistry

PHASES = ("source", "membership", "dispatch", "collect", "emit", "checkpoint")


def _values(dist, n=20_000):
    rng = np.random.default_rng(abs(hash(dist)) % 2**32)
    if dist == "uniform":
        v = rng.uniform(1e-3, 5.0, n)
    elif dist == "lognormal":
        v = rng.lognormal(-2.0, 1.2, n)
    elif dist == "exponential":
        v = rng.exponential(0.25, n)
    elif dist == "bimodal":
        v = np.concatenate([rng.normal(0.01, 0.002, 3 * n // 5),
                            rng.normal(2.0, 0.3, 2 * n // 5)])
    else:  # out of range both ways: the clamps
        v = np.concatenate([rng.uniform(1e-7, 1e-5, n // 2), rng.uniform(200, 500, n // 2)])
    return v


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "exponential", "bimodal", "clamped"])
def test_sketch_same_quantiles_as_jax(dist):
    vals = _values(dist)
    j, t = jlat.QuantileSketch(), latency.QuantileSketch()
    for chunk in np.array_split(vals, 7):
        j.observe_many(chunk)
        t.observe_many(chunk)
        j.roll()
        t.roll()
        j.observe(float(chunk[0]))
        t.observe(float(chunk[0]))
    for scope in ("window", "total"):
        assert t.count(scope) == j.count(scope)
        assert t.quantiles(scope=scope) == j.quantiles(scope=scope)
        assert t.summary(scope) == j.summary(scope)
    assert t.state() == j.state() and t.nbytes() == j.nbytes()
    back = latency.QuantileSketch.from_state(j.state())
    assert back.quantiles(scope="total") == j.quantiles(scope="total")
    if dist != "clamped":
        exact = float(np.percentile(vals, 99))
        est = latency.QuantileSketch()
        est.observe_many(np.clip(vals, 1e-4, 99.0))
        assert exact / 10 ** (1 / 20) <= est.quantile(0.99) <= exact * 10 ** (1 / 20)


def test_qlabel_and_stages_match():
    assert latency.STAGES == jlat.STAGES and latency.DEFAULT_QS == jlat.DEFAULT_QS
    for q in (0.5, 0.95, 0.99, 0.999, 0.9):
        assert latency.qlabel(q) == jlat.qlabel(q)


SPECS = ["detect=2s@p99", "tick=500ms@p95", "detect=1.5s@p99.9", "emit=20ms@p50",
         "", "detect", "detect=2s", "detect=2m@p99", "foo=2s@p99", "detect=0s@p99",
         "detect=2s@p0", "detect=2s@p100", "DETECT=2s@p99"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_matches_jax(spec):
    try:
        j = jslo.parse_slo(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            slo.parse_slo(spec)
        assert str(te.value) == str(e)
        return
    t = slo.parse_slo(spec)
    assert (t.name, t.target_s, t.quantile, t.label(), t.budget_frac) == \
        (j.name, j.target_s, j.quantile, j.label(), j.budget_frac)


class _Flight:
    def __init__(self):
        self.dumps = []

    def request_dump(self, reason, tick):
        self.dumps.append((reason, tick))

    def record_event(self, ev):
        pass


def _pattern(name):
    if name == "episodes":
        return [0.5] * 30 + [0.01] * 40 + [0.5] * 30
    if name == "at-budget":
        return [0.5 if k % 10 == 0 else 0.01 for k in range(200)]
    if name == "spike":
        return [0.01] * 50 + [0.5] * 3 + [0.01] * 20
    rng = np.random.default_rng(7)
    return list(np.where(rng.random(300) < 0.25, 0.4, 0.02))


@pytest.mark.parametrize("windows", [(5, 20), (10, 20), (3, 60)])
@pytest.mark.parametrize("pattern", ["episodes", "at-budget", "spike", "random"])
def test_slo_tracker_same_events_and_verdict(pattern, windows):
    out = {}
    for mod, reg in ((jslo, JReg), (slo, TelemetryRegistry)):
        events, fl = [], _Flight()
        tr = mod.SloTracker([mod.parse_slo("tick=100ms@p90"), mod.parse_slo("detect=2s@p99")],
                            fast_window=windows[0], slow_window=windows[1], fast_burn=2.0,
                            slow_burn=1.5, registry=reg(), sink=events.append, flight=fl)
        for k, v in enumerate(_pattern(pattern)):
            tr.observe("tick", v)
            tr.observe("detect", v * 10)
            tr.on_tick(k)
        v = tr.verdict()
        snap = {k: v for k, v in tr.snapshot().items() if k != "ts"}
        out[mod] = (events, fl.dumps, v, snap, tr.fleet_state())
    assert out[slo] == out[jslo]


def test_latency_tracker_waterfall_lags_and_slo_match():
    out = {}
    for lmod, smod, reg in ((jlat, jslo, JReg), (latency, slo, TelemetryRegistry)):
        events = []
        lat = lmod.LatencyTracker(window_ticks=10, cadence_s=0.5, registry=reg())
        tr = smod.SloTracker([smod.parse_slo("tick=100ms@p90")], fast_window=5, slow_window=20,
                             cadence_s=0.5, registry=reg(), sink=events.append,
                             quantile_source=lat.quantile)
        lat.slo = tr
        lat.lag_providers["incident_close_s"] = lambda t, ts: float(t % 3)
        for k in range(40):
            phases = {p: 0.001 * (1 + (k + i) % 4) for i, p in enumerate(PHASES)}
            lat.record_tick(k, 1_700_000_000 + k, phases, 0.02 + (0.3 if k % 9 == 0 else 0),
                            poll_wall=1_700_000_000.25 + k)
            lat.observe_detect(np.array([0.1 * (k % 5), 0.2]))
            tr.on_tick(k)
        snap = lat.snapshot()
        out[lmod] = (events, lat.stats(), {k: v for k, v in snap.items() if k != "ts"},
                     tr.verdict(), lat.sketch_states())
    assert out[latency] == out[jlat]


def test_tick_slo_pair_matches_and_overhead_gate():
    t_lat, t_slo = slo.tick_slo_pair(0.25)
    j_lat, j_slo = jslo.tick_slo_pair(0.25)
    assert [s.label() for s in t_slo.specs] == [s.label() for s in j_slo.specs]
    assert t_lat.window_ticks == j_lat.window_ticks
    from rtap_tpu_torch.obs.selfbench import measure_latency

    res = measure_latency(n=5000)
    assert res["per_tick_overhead_frac"] <= 0.01, res
