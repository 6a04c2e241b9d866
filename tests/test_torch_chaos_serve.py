"""PyTorch port vs the JAX package: scripted chaos against both live loops.

The four scenarios of tests/integration/test_chaos_serve.py (6 streams in 3
groups, 12 ticks) run through the JAX ``live_loop`` and the port's on the
same feed and fault spec, and a journal gap on resume. All exact:

* alert lines byte-equal, event lines equal leaving out their wall-clock
  fields (cadence 0 makes every tick a deterministic miss);
* ``quarantine_log``, ``scored_by_group`` and the failure counts equal;
* the final state leaves bit-equal, healthy and restored groups alike,
  and the healthy groups' scores equal to a fault-free run's;
* alert ids carry the ``.e<epoch>`` suffix after a restore;
* a journal gap on resume quarantines its group instead of raising.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.resilience import ChaosEngine as JEngine
from rtap_tpu.resilience import ChaosSpec as JSpec
from rtap_tpu.resilience import DegradationController as JDeg
from rtap_tpu.resilience import Fault as JFault
from rtap_tpu.resilience.journal import TickJournal as JJournal
from rtap_tpu.service.loop import live_loop as j_live_loop
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.obs import get_registry, summarize_snapshot
from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, DegradationController, Fault
from rtap_tpu_torch.resilience.journal import TickJournal
from rtap_tpu_torch.service.checkpoint import peek_resume_ticks
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)

JCFG = j_scaled(32)
JCFG = dataclasses.replace(JCFG, likelihood=dataclasses.replace(
    JCFG.likelihood, learning_period=4, estimation_samples=2))
CFG = ModelConfig.from_dict(JCFG.to_dict())
N_STREAMS = 6
GROUP_SIZE = 2  # 3 groups: fault the middle one
N_TICKS = 12
#: event fields that carry wall-clock measurements
WALL_KEYS = ("elapsed_s", "seconds", "cadence_s", "budget_s")


def _registry(pkg):
    # threshold floor + debounce 1: every scored tick writes an alert line
    if pkg == "jax":
        reg = JReg(JCFG, group_size=GROUP_SIZE, backend="tpu", threshold=-1e9, debounce=1)
    else:
        reg = StreamGroupRegistry(CFG, group_size=GROUP_SIZE, device="cpu", threshold=-1e9,
                                  debounce=1)
    for i in range(N_STREAMS):
        reg.add_stream(f"s{i}")
    reg.finalize()
    return reg


class Feed:
    """A seeded feed keyed by the GLOBAL tick; `crash_at` escapes the loop
    like a process death (a BaseException is not a source error)."""

    def __init__(self, base=0, crash_at=None):
        self.base, self.crash_at = base, crash_at

    def __call__(self, k):
        g = self.base + k
        if g == self.crash_at:
            raise Crash(g)
        rng = np.random.Generator(np.random.Philox(key=(77, g)))
        return (30 + 5 * rng.random(N_STREAMS)).astype(np.float32), 1_700_000_000 + g


class Crash(BaseException):
    pass


def _engines(faults):
    """The same fault list as (JAX engine, port engine)."""
    return (JEngine(JSpec(faults=[JFault(**f) for f in faults])),
            ChaosEngine(ChaosSpec(faults=[Fault(**f) for f in faults])))


def _lines(path):
    alerts, events = [], []
    with open(path) as f:
        for ln in f:
            if ln.startswith('{"event"'):
                ev = json.loads(ln)
                events.append({k: v for k, v in ev.items() if k not in WALL_KEYS})
            else:
                alerts.append(ln)
    return alerts, events


def _state(pkg, grp):
    if pkg == "jax":
        import jax

        model = {k: np.asarray(v) for k, v in jax.device_get(grp.state).items()}
    else:
        model = state_to_numpy(grp.state)
    return {**{f"model/{k}": v for k, v in model.items()},
            **{f"likelihood/{k}": np.asarray(v)
               for k, v in grp.likelihood.state_dict().items()},
            "alert_run": np.asarray(grp._alert_run), "ticks": np.asarray(grp.ticks),
            "alert_epoch": np.asarray(grp.alert_epoch)}


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


def _run_both(tmp_path, faults, **loop):
    """Both packages' live loops on the same feed and faults ->
    {pkg: (stats, registry, alert lines, event lines)}."""
    out = {}
    n_ticks = loop.pop("n_ticks", N_TICKS)
    for (pkg, run), engine in zip((("jax", j_live_loop), ("torch", live_loop)),
                                  _engines(faults)):
        d = tmp_path / pkg
        d.mkdir()
        reg = _registry(pkg)
        kw = dict(loop)
        if "checkpoint_every" in kw or "quarantine_restore_after" in kw:
            kw["checkpoint_dir"] = str(d / "ck")
        if "degradation" in kw:
            kw["degradation"] = kw["degradation"][pkg]
        stats = run(Feed(), reg, n_ticks=n_ticks, cadence_s=0.0,
                    alert_path=str(d / "alerts.jsonl"), chaos=engine, **kw)
        out[pkg] = (stats, reg, *_lines(d / "alerts.jsonl"))
    return out


def _assert_match(out, keys=("ticks", "scored", "scored_by_group", "quarantine_log",
                             "quarantined", "checkpoint_save_failures", "degradation",
                             "chaos_injected", "alerts")):
    (js, jreg, jal, jev), (ts, treg, tal, tev) = out["jax"], out["torch"]
    assert tal == jal and len(tal) > 0
    assert tev == jev
    for k in keys:
        assert ts.get(k) == js.get(k), k
    for jg, tg in zip(jreg.groups, treg.groups):
        _assert_states_equal(_state("jax", jg), _state("torch", tg))
    return ts


def _summary():
    return summarize_snapshot(get_registry().snapshot())


CONTAINED = [
    # one exporter (group 1's streams) times out: NaN inputs, still scored
    dict(kind="source_timeout", tick=2, streams=(2, 3)),
    # group 1's dispatch raises: quarantine, everyone else unharmed
    dict(kind="dispatch_exception", tick=5, group=1),
    # the alert disk fills for two ticks: the sink breaker opens
    dict(kind="alert_sink_oserror", tick=6, duration=2),
    # the checkpoint round at tick 7 fails for every unquarantined group
    dict(kind="checkpoint_oserror", tick=7),
]


def test_contained_faults_match_jax_and_healthy_groups_match_fault_free(tmp_path):
    before = _summary()
    out = _run_both(tmp_path, CONTAINED, checkpoint_every=4)
    after = _summary()
    ts = _assert_match(out)
    assert ts["scored_by_group"] == [2 * N_TICKS, 2 * 5, 2 * N_TICKS]
    assert ts["quarantined"]["group1"]["phase"] == "dispatch"
    assert ts["quarantine_log"][0] == {"event": "group_quarantined", "group": 1, "tick": 5,
                                       "phase": "dispatch"}
    assert ts["checkpoint_save_failures"] == 2
    # the port's counters moved as the JAX package's do (deltas: the
    # registry is process-wide and the JAX run has its own)
    assert after["rtap_obs_groups_quarantined"] == 1
    d = {k: v - before.get(k, 0) for k, v in after.items() if not isinstance(v, dict)}
    assert d["rtap_obs_chaos_injected_total{kind=dispatch_exception}"] == 1
    assert d["rtap_obs_resilience_events_total{event=alert_sink_quarantined}"] == 1
    # the healthy groups' scores equal a fault-free run's
    ref = _registry("torch")
    live_loop(Feed(), ref, n_ticks=N_TICKS, cadence_s=0.0)
    treg = out["torch"][1]
    for gi in (0, 2):
        _assert_states_equal(_state("torch", ref.groups[gi]), _state("torch", treg.groups[gi]))


def test_quarantined_group_restores_with_epoch_ids_like_jax(tmp_path):
    out = _run_both(tmp_path, [dict(kind="dispatch_exception", tick=5, group=1)],
                    checkpoint_every=3, quarantine_restore_after=3)
    ts = _assert_match(out)
    # saved at tick 2 -> quarantined at 5 -> restored at 8 from tick 3
    assert ts["scored_by_group"] == [2 * N_TICKS, 2 * (5 + 4), 2 * N_TICKS]
    assert "quarantined" not in ts
    assert ts["quarantine_log"][1] == {"event": "group_restored", "group": 1, "tick": 8,
                                       "resumed_from_tick": 3}
    assert len(ts["restore_s"]) == 1 and ts["restore_s"][0] > 0
    treg, tal = out["torch"][1], out["torch"][2]
    ids = [json.loads(ln)["alert_id"] for ln in tal]
    # the rewound timeline's ids carry the epoch; ids stay unique
    assert "1.e1:s2:3" in ids and len(set(ids)) == len(ids)
    assert treg.groups[1].alert_epoch == 1
    grp, slot = treg.lookup("s2")
    assert grp is treg.groups[1] and slot == 0


def test_degradation_ladder_matches_jax(tmp_path):
    ladders = {"jax": JDeg(window=4, degrade_after=2, recover_after=50, thin_factor=2,
                           widen_factor=2.0),
               "torch": DegradationController(window=4, degrade_after=2, recover_after=50,
                                              thin_factor=2, widen_factor=2.0)}
    out = _run_both(tmp_path, [], n_ticks=10, degradation=ladders)
    ts = _assert_match(out)
    assert ts["degradation"] == {"level": 3, "max_level": 3, "transitions": 3}
    degraded = [e for e in out["torch"][3] if e["event"] == "degraded"]
    assert [e["step"] for e in degraded] == ["learn_thin", "score_only", "tick_widen"]
    assert ts["scored"] == 10 * N_STREAMS
    # level 1 (ticks 2-3) learns on even ticks only, level 2 on from tick 4 none
    assert ts["learned_group_ticks"] == 3 * (2 + 1)


def test_raising_source_and_backwards_timestamps_match_jax(tmp_path):
    out = _run_both(tmp_path, [dict(kind="source_conn_drop", tick=1),
                               dict(kind="source_malformed", tick=2),
                               dict(kind="source_backwards_ts", tick=4)], n_ticks=8)
    ts = _assert_match(out)
    assert ts["scored"] == 8 * N_STREAMS
    kinds = {e["event"] for e in out["torch"][3]}
    assert {"source_error", "source_time_regression"} <= kinds


def _serve_once(pkg, workdir, total, crash_at=None):
    reg = _registry(pkg)
    jmod, run = (JJournal, j_live_loop) if pkg == "jax" else (TickJournal, live_loop)
    # small segments: compaction drops whole segments, and the gap needs it
    journal = jmod(os.path.join(workdir, "journal"), segment_bytes=1024)
    ck = os.path.join(workdir, "ck")
    base = max(journal.next_tick, peek_resume_ticks(ck))
    try:
        return run(Feed(base=base, crash_at=crash_at), reg, n_ticks=total - base,
                   cadence_s=0.0, alert_path=os.path.join(workdir, "alerts.jsonl"),
                   checkpoint_dir=ck, checkpoint_every=8, journal=journal), reg
    finally:
        journal.close()


def test_journal_gap_on_resume_quarantines_the_group_like_jax(tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        w = str(tmp_path / pkg)
        with pytest.raises(Crash):
            _serve_once(pkg, w, 40, crash_at=36)
        # group 1's checkpoint is lost: it resumes at tick 0, but the journal
        # was compacted toward tick 32 — a gap that must quarantine, not raise
        shutil.rmtree(os.path.join(w, "ck", "group0001"))
        stats, reg = _serve_once(pkg, w, 40)
        out[pkg] = (stats, reg, *_lines(os.path.join(w, "alerts.jsonl")))
    ts = _assert_match(out, keys=("ticks", "scored", "scored_by_group", "quarantine_log",
                                  "quarantined", "alerts"))
    assert ts["quarantine_log"] == [{"event": "group_quarantined", "group": 1, "tick": 0,
                                     "phase": "journal_replay_gap"}]
    assert ts["journal"]["gap_groups"] == [1]
    assert ts["journal"]["gap_groups"] == out["jax"][0]["journal"]["gap_groups"]
