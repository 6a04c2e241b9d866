"""PyTorch port vs the JAX package: the live loop with the model-side
trackers (health, the predictive horizon with blast fusion, topology
incident correlation).

* The JAX live_loop and the port's on the same feed, with ``health``,
  ``predict=8`` and an inferred topology: byte-equal alert lines and
  ``precursor`` / ``predicted_incident`` / ``incident`` lines, health event
  lines equal with their float fields at ``rtol=1e-5, atol=1e-6`` (the
  health reducer's f32 means), bit-equal final state, equal tracker stats.
  Event lines that carry wall-clock fields (the watchdog's) are left out.
* Flags on vs off: model state (the predictor's own leaves aside) and the
  alert lines are identical.
* Exactly-once across a restart: a journal replay re-derives and suppresses
  the precursor ids already on disk; a crash mid-run resumed from
  checkpoints and the journal delivers no precursor, predicted_incident or
  incident id twice and loses none of the uninterrupted run's, with the
  JAX package's stream.
* Checkpoints carry the predict horizon; a resume with another is refused.
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.correlate import IncidentCorrelator as JCorrelator
from rtap_tpu.correlate import TopologyMap as JTopo
from rtap_tpu.obs.health import HealthTracker as JHealth
from rtap_tpu.predict import BlastFuser as JBlast
from rtap_tpu.predict import PredictTracker as JPredict
from rtap_tpu.service.loop import live_loop as j_live_loop
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.correlate import IncidentCorrelator, TopologyMap
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.obs.health import HealthTracker
from rtap_tpu_torch.predict import BlastFuser, PredictTracker
from rtap_tpu_torch.resilience.journal import TickJournal
from rtap_tpu_torch.service.checkpoint import load_group, peek_resume_ticks, save_group
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)

JCFG = j_scaled(32)
JCFG = dataclasses.replace(JCFG, likelihood=dataclasses.replace(
    JCFG.likelihood, learning_period=10, estimation_samples=5))
CFG = ModelConfig.from_dict(JCFG.to_dict())
IDS = ["web-00.cpu", "web-00.mem", "web-01.cpu", "web-01.mem", "db-00.cpu", "db-00.mem"]
# under this feed the web streams jump unpredictably over ticks 30-44: alerts,
# precursors on both clusters, incidents and score drift all fire by tick 70
THRESHOLD = 0.02
HORIZON = 8
TRACKED = ("precursor", "predicted_incident", "incident")
HEALTH_EVENTS = ("pool_saturated", "sparsity_collapsed", "score_drift")


def feed_value(sid: str, g: int) -> float:
    h = zlib.crc32(sid.encode())
    rng = np.random.Generator(np.random.Philox(key=(h, g)))
    v = 30 + 5 * np.sin(g / 3.0 + h % 7) + rng.normal(0, 0.3)
    return v + (40 * rng.random() if sid.startswith("web") and 30 <= g < 45 else 0.0)


class Feed:
    """Seeded by the GLOBAL tick (base + local), so a resumed run replays."""

    def __init__(self, base=0, crash_at=None):
        self.base, self.crash_at = base, crash_at

    def __call__(self, k):
        g = self.base + k
        if g == self.crash_at:
            raise Crash(g)
        return (np.array([feed_value(s, g) for s in IDS], np.float32), 1_700_000_000 + g)


class Crash(BaseException):
    """A process death mid-run, in process."""


def _registry(pkg, health=True, predict=HORIZON):
    if pkg == "jax":
        reg = JReg(JCFG, group_size=3, backend="tpu", threshold=THRESHOLD, debounce=1,
                   health=health, predict=predict)
    else:
        reg = StreamGroupRegistry(CFG, group_size=3, device="cpu", threshold=THRESHOLD,
                                  debounce=1, health=health, predict=predict)
    for sid in IDS:
        reg.add_stream(sid)
    reg.finalize()
    return reg


def _trackers(pkg):
    if pkg == "jax":
        topo = JTopo.infer()
        return dict(health=JHealth(JCFG, drift_min_ticks=20),
                    predictor=JPredict(HORIZON, threshold=0.3, min_ticks=3, warmup_ticks=4,
                                       blast=JBlast(topo, seed_streams=IDS)),
                    correlator=JCorrelator(topo, window_s=3, min_streams=2))
    topo = TopologyMap.infer()
    return dict(health=HealthTracker(CFG, drift_min_ticks=20),
                predictor=PredictTracker(HORIZON, threshold=0.3, min_ticks=3, warmup_ticks=4,
                                         blast=BlastFuser(topo, seed_streams=IDS)),
                correlator=IncidentCorrelator(topo, window_s=3, min_streams=2))


def _lines(path):
    """(alert lines, tracked event lines, health events as dicts)."""
    alerts, tracked, health = [], [], []
    with open(path) as f:
        for ln in f:
            if not ln.startswith('{"event"'):
                alerts.append(ln)
                continue
            ev = json.loads(ln)
            if ev["event"] in TRACKED:
                tracked.append(ln)
            elif ev["event"] in HEALTH_EVENTS:
                health.append(ev)
    return alerts, tracked, health


def _assert_close_tree(a, b):
    """Equal JSON-like trees, floats at the health tolerance."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_close_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close_tree(x, y)
    elif isinstance(a, float) and isinstance(b, float):
        assert b == pytest.approx(a, rel=1e-5, abs=1e-6)
    else:
        assert a == b


def _model_state(pkg, grp):
    if pkg == "jax":
        import jax

        return {k: np.asarray(v) for k, v in jax.device_get(grp.state).items()}
    return state_to_numpy(grp.state)


@pytest.mark.parametrize("depth", [1, 2])
def test_live_loop_with_trackers_matches_jax(tmp_path, depth):
    out = {}
    for pkg, loop in (("jax", j_live_loop), ("torch", live_loop)):
        reg = _registry(pkg)
        tr = _trackers(pkg)
        path = str(tmp_path / f"{pkg}.jsonl")
        stats = loop(Feed(), reg, n_ticks=70, cadence_s=0.0, alert_path=path,
                     pipeline_depth=depth, **tr)
        out[pkg] = (stats, reg, _lines(path), tr)
    (js, jreg, (ja, jt, jh), jtr), (ts, treg, (ta, tt, th), ttr) = out["jax"], out["torch"]
    assert ta == ja and tt == jt
    _assert_close_tree(jh, th)
    kinds = [json.loads(ln)["event"] for ln in tt]
    assert len(ta) > 50 and set(kinds) == set(TRACKED) and th, (len(ta), kinds, th)
    assert ts["predict"] == js["predict"] and ts["incidents"] == js["incidents"]
    _assert_close_tree(js["health"], ts["health"])
    _assert_close_tree(jtr["health"].snapshot(), ttr["health"].snapshot())
    assert ttr["predictor"].snapshot() == jtr["predictor"].snapshot()
    for jg, tg in zip(jreg.groups, treg.groups):
        a, b = _model_state("jax", jg), _model_state("torch", tg)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k], equal_nan=True), k
    assert os.path.exists(tmp_path / "torch.jsonl.corr")


def test_trackers_on_vs_off_leave_state_and_alerts_unchanged(tmp_path):
    runs = {}
    for name, on in (("on", True), ("off", False)):
        reg = _registry("torch", health=on, predict=HORIZON if on else 0)
        path = str(tmp_path / f"{name}.jsonl")
        live_loop(Feed(), reg, n_ticks=50, cadence_s=0.0, alert_path=path, pipeline_depth=2,
                  **(_trackers("torch") if on else {}))
        runs[name] = (reg, _lines(path))
    (ron, (aon, ton, _)), (roff, (aoff, toff, _)) = runs["on"], runs["off"]
    assert aon == aoff and len(aon) > 0 and ton and not toff
    for gon, goff in zip(ron.groups, roff.groups):
        son, soff = state_to_numpy(gon.state), state_to_numpy(goff.state)
        assert set(son) - set(soff) == {"pred_ring", "pred_miss_ewma", "pred_tick0"}
        for k in soff:
            assert np.array_equal(son[k], soff[k], equal_nan=True), k
        assert gon.likelihood.state_dict().keys() == goff.likelihood.state_dict().keys()


def _drift_feed(k, calm_until=24):
    """A learnable constant, then an unpredictable walk: the miss EWMA climbs."""
    if k < calm_until:
        return np.full(len(IDS), 30.0, np.float32), 1_700_000_000 + k
    rng = np.random.Generator(np.random.Philox(key=(97, k)))
    return (10 + 80 * rng.random(len(IDS))).astype(np.float32), 1_700_000_000 + k


def _event_ids(path, kinds=TRACKED):
    with open(path) as f:
        return [json.loads(ln).get("alert_id") or json.loads(ln).get("incident_id")
                for ln in f if ln.startswith('{"event"') and json.loads(ln)["event"] in kinds]


def test_journal_replay_suppresses_precursor_exactly_once(tmp_path):
    """The JAX package's resume continuity case: a journaled run that paged
    precursors is replayed from scratch; the folds re-derive the same ids on
    the group-tick clock and the suppression set swallows them."""
    jdir, alerts = str(tmp_path / "journal"), str(tmp_path / "alerts.jsonl")

    def tracker():
        return PredictTracker(horizon=2, threshold=0.3, min_ticks=3, warmup_ticks=4)

    reg = _registry("torch", health=False, predict=2)
    j = TickJournal(jdir)
    live_loop(_drift_feed, reg, n_ticks=40, cadence_s=0.0, alert_path=alerts, journal=j,
              predictor=tracker())
    j.close()
    first = _event_ids(alerts, ("precursor",))
    assert first, "run 1 paged no precursor"
    j2 = TickJournal(jdir)
    pt2 = tracker()
    stats = live_loop(_drift_feed, _registry("torch", health=False, predict=2), n_ticks=0,
                      cadence_s=0.0, alert_path=alerts, journal=j2, predictor=pt2)
    j2.close()
    assert stats["journal"]["replayed_ticks"] == 40
    assert pt2.events_suppressed >= len(first)
    assert _event_ids(alerts, ("precursor",)) == first  # exactly once
    assert pt2.stats()["streams_alarmed"] >= 1  # the replay re-latched the alarms


def _serve_once(pkg, workdir, total, crash_at=None):
    """One serve lifetime: resume from checkpoints + journal, replay, run the
    rest of the `total` budget with every tracker on; a crash escapes."""
    if pkg == "jax":
        from rtap_tpu.resilience.journal import TickJournal as Journal
        from rtap_tpu.service.checkpoint import peek_resume_ticks as peek
        loop = j_live_loop
    else:
        Journal, peek, loop = TickJournal, peek_resume_ticks, live_loop
    reg = _registry(pkg)
    journal = Journal(os.path.join(workdir, "journal"), segment_bytes=4096)
    ck = os.path.join(workdir, "ck")
    base = max(journal.next_tick, peek(ck))
    try:
        return loop(Feed(base=base, crash_at=crash_at), reg, n_ticks=total - base,
                    cadence_s=0.0, alert_path=os.path.join(workdir, "alerts.jsonl"),
                    checkpoint_dir=ck, checkpoint_every=16, pipeline_depth=2,
                    journal=journal, **_trackers(pkg)), reg
    finally:
        journal.close()


@pytest.mark.parametrize("crash_at", [37, 53])
def test_crash_resume_events_exactly_once_as_jax(tmp_path, crash_at):
    """Killed mid-burst (37) or after it (53), resumed from checkpoints and
    the journal: no alert line and no precursor, predicted_incident or
    incident id is delivered twice, none of the uninterrupted run's is
    lost, and the stream equals the JAX package's doing the same. (The
    trackers' latches are not checkpointed, in either package: after a
    resume the predictor may page an excursion again under a new tick's
    id; ROADMAP.md section C.)"""
    total = 70
    _, ref_reg = _serve_once("torch", str(tmp_path / "ref"), total)
    ref = os.path.join(tmp_path, "ref", "alerts.jsonl")
    got = {}
    for pkg in ("jax", "torch"):
        work = str(tmp_path / pkg)
        with pytest.raises(Crash):
            _serve_once(pkg, work, total, crash_at=crash_at)
        stats, reg = _serve_once(pkg, work, total)
        got[pkg] = (os.path.join(work, "alerts.jsonl"), stats, reg)
    path, stats, reg = got["torch"]
    want_ids, got_ids = _event_ids(ref), _event_ids(path)
    assert len(got_ids) == len(set(got_ids)), "an event id was delivered twice"
    assert set(want_ids) <= set(got_ids) and len(want_ids) >= 8
    alerts = _lines(path)[0]
    assert len(alerts) == len(set(alerts)) and sorted(alerts) == sorted(_lines(ref)[0])
    assert stats["journal"]["replayed_ticks"] > 0
    jalerts, jtracked, _ = _lines(got["jax"][0])
    assert alerts == jalerts and _lines(path)[1] == jtracked
    for a, b in zip(ref_reg.groups, reg.groups):
        sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
        assert all(np.array_equal(sa[k], sb[k], equal_nan=True) for k in sa)


def test_checkpoint_carries_the_predict_horizon(tmp_path):
    reg = _registry("torch", health=False, predict=3)
    live_loop(Feed(), reg, n_ticks=6, cadence_s=0.0)
    grp = reg.groups[0]
    save_group(grp, tmp_path / "g")
    meta = json.loads((tmp_path / "g" / "meta.json").read_text())
    assert meta["predict"] == 3
    back = load_group(tmp_path / "g", device="cpu")
    assert back.predict == 3
    a, b = state_to_numpy(grp.state), state_to_numpy(back.state)
    assert a.keys() == b.keys() and "pred_ring" in b
    assert all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)
    # a resume with another horizon is refused, as the JAX package does
    ck = str(tmp_path / "ck")
    live_loop(Feed(), _registry("torch", health=False, predict=3), n_ticks=4, cadence_s=0.0,
              checkpoint_dir=ck)
    with pytest.raises(ValueError, match="predict: checkpoint=3 vs requested=4"):
        live_loop(Feed(), _registry("torch", health=False, predict=4), n_ticks=4,
                  cadence_s=0.0, checkpoint_dir=ck)
