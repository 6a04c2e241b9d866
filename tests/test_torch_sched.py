"""PyTorch port vs the JAX package: serve's scheduling flags.

* The registry's learning-phase stagger (the twins in
  tests/parity/test_learn_cadence.py): group i gets ``(i mod k) * burst``,
  the all-pad reserve groups too; off, or at full rate, it is inert.
* The JAX live_loop and the port's on the same seeded feed under
  ``stagger_learn``, ``dispatch_threads=2``, ``micro_chunk`` 1 and 3 with
  ``chunk_stagger`` (the twins in tests/unit/test_multigroup_serve.py):
  byte-equal alert lines (so raw scores and log-likelihoods are exact),
  bit-equal state. The port's staggered and plain runs hold the same lines
  and state.
* ``chunk_stagger`` with ``auto_register`` and ``auto_release_after`` (the
  twins in tests/unit/test_dynamic_streams.py), against the JAX loop.
* A resume under ``stagger_learn`` rebuilds the same phases and continues
  bit for bit, from the port's checkpoint and from a JAX ``save_group``
  checkpoint imported by ``load_group``.
* The validation errors are the JAX package's; the counters are exact under
  a thread pool; ``serve`` takes the four flags with the JAX defaults.

Exact: state, alert lines, raw scores. Everything runs on the CPU at 32
columns.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.service.loop import live_loop as j_live_loop
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_J = j_scaled(32)
_J = dataclasses.replace(_J, likelihood=dataclasses.replace(
    _J.likelihood, learning_period=10, estimation_samples=5))
# learning every other tick from tick 0 on: a short run sees the stagger
JCFG = _J.with_learn_every(2, full_until=0)
CFG = ModelConfig.from_dict(JCFG.to_dict())
IDS = [f"n{i // 2}.m{i % 2}" for i in range(8)]  # 4 groups of 2
GROUP = 2
TICKS = 20
THRESHOLD = 0.007


class Feed:
    """A seeded source keyed by the tick (base + local tick), with the
    discovery hooks of the JSONL sources: `joins` maps a tick to ids that
    start pushing then, `silent` an id to the tick from which it is NaN."""

    def __init__(self, ids, base=0, joins=None, silent=None):
        self.ids, self.base = list(ids), base
        self.joins, self.silent = joins or {}, silent or {}
        self._next = base

    def value(self, sid, g):
        if g >= self.silent.get(sid, 1 << 30):
            return np.nan
        h = zlib.crc32(sid.encode())
        rng = np.random.Generator(np.random.Philox(key=((3 << 32) + h, g)))
        v = 30 + 8 * np.sin(g / 3.0 + h % 7) + rng.normal(0, 0.5)
        return v + (40.0 if (g + h) % 11 == 0 else 0.0)

    def __call__(self, k):
        g = self.base + k
        self._next = g + 1
        return np.array([self.value(s, g) for s in self.ids], np.float32), 1_700_000_000 + g

    def drain_unknown(self):
        return sorted({s for t, new in self.joins.items() if t <= self._next
                       for s in new if s not in self.ids})

    def set_ids(self, ids):
        self.ids = list(ids)


def _registry(pkg, stagger=True, ids=IDS, reserve=0, jcfg=JCFG, group=GROUP,
              threshold=THRESHOLD, debounce=2):
    if pkg == "jax":
        reg = JReg(jcfg, group_size=group, backend="tpu", threshold=threshold,
                   debounce=debounce, stagger_learn=stagger)
    else:
        reg = StreamGroupRegistry(ModelConfig.from_dict(jcfg.to_dict()), group_size=group,
                                  device="cpu", threshold=threshold, debounce=debounce,
                                  stagger_learn=stagger)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize(reserve=reserve)
    return reg


def _lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith('{"event"')]


def _state(pkg, grp):
    if pkg == "jax":
        import jax

        model = {k: np.asarray(v) for k, v in jax.device_get(grp.state).items()}
    else:
        model = state_to_numpy(grp.state)
    return {**{f"model/{k}": v for k, v in model.items()},
            **{f"likelihood/{k}": np.asarray(v) for k, v in grp.likelihood.state_dict().items()},
            "alert_run": np.asarray(grp._alert_run), "ticks": np.asarray(grp.ticks),
            "ids": np.asarray(grp.stream_ids)}


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


# ---- the registry's phases ----

PHASE_CASES = {
    # test_registry_stagger_assigns_phases_and_shifts_learning: the
    # all-pad reserve group is staggered too
    "spread": dict(k=2, burst=1, group=2, n=6, reserve=2, stagger=True, want=[0, 1, 0, 1]),
    # test_stagger_with_burst_levels_learning_load: whole bursts offset
    "burst": dict(k=4, burst=3, group=1, n=8, reserve=0, stagger=True,
                  want=[0, 3, 6, 9, 0, 3, 6, 9]),
    # test_stagger_off_or_fullrate_is_inert
    "full-rate": dict(k=1, burst=1, group=2, n=4, reserve=0, stagger=True, want=[0, 0]),
    "off": dict(k=2, burst=1, group=2, n=6, reserve=0, stagger=False, want=[0, 0, 0]),
}


@pytest.mark.parametrize("case", list(PHASE_CASES))
def test_registry_stagger_phases_match_jax(case):
    c = PHASE_CASES[case]
    jcfg = _J.with_learn_every(c["k"], full_until=0, burst=c["burst"])
    regs = {pkg: _registry(pkg, stagger=c["stagger"], ids=[f"s{i}" for i in range(c["n"])],
                           reserve=c["reserve"], jcfg=jcfg, group=c["group"])
            for pkg in ("jax", "torch")}
    for pkg, reg in regs.items():
        assert [g.cfg.learn_phase for g in reg.groups] == c["want"], pkg
        assert reg.stagger_learn == (c["stagger"] and c["k"] > 1), pkg
    assert [g.cfg.to_dict() for g in regs["torch"].groups] == \
           [g.cfg.to_dict() for g in regs["jax"].groups]
    if case == "burst":
        # the learning load is flat: exactly n_groups / k groups learn per tick
        for it in range(48):
            assert sum(bool(g.cfg.learns_on(it)) for g in regs["torch"].groups) == 2, it


def test_staggered_group_learns_on_its_own_phase():
    """A phase-1 group steps like a group built with that phase explicitly
    (the stagger is config plumbing): in the port and in the JAX package,
    bit for bit, and its learning rows are the cadence's."""
    from rtap_tpu.service.registry import StreamGroup as JGroup
    from rtap_tpu_torch.service.registry import StreamGroup

    jreg, treg = _registry("jax"), _registry("torch")
    jref = JGroup(dataclasses.replace(JCFG, learn_phase=1), IDS[2:4],
                  seed=jreg.groups[1].seed, backend="tpu", threshold=THRESHOLD, debounce=2)
    tref = StreamGroup(dataclasses.replace(CFG, learn_phase=1), IDS[2:4],
                       seed=treg.groups[1].seed, device="cpu", threshold=THRESHOLD, debounce=2)
    feed = Feed(IDS[2:4])
    assert treg.groups[1].learning_rows(4) == [False, True, False, True]
    for k in range(4):
        vals, ts = feed(k)
        for g in (jreg.groups[1], treg.groups[1], jref, tref):
            g.tick(vals, ts)
    want = _state("jax", jref)
    for pkg, g in (("jax", jreg.groups[1]), ("torch", treg.groups[1]), ("torch", tref)):
        _assert_states_equal(want, _state(pkg, g))


# ---- live_loop under the scheduling flags ----

LOOP_CASES = {
    "stagger-learn": dict(),
    "threads2-depth2": dict(dispatch_threads=2, pipeline_depth=2),
    "threads2-checkpoint": dict(dispatch_threads=2, pipeline_depth=2, ck=5),
    "chunk-stagger-m3": dict(micro_chunk=3, chunk_stagger=True, dispatch_threads=2,
                             pipeline_depth=2),
    "chunk-stagger-m3-checkpoint": dict(micro_chunk=3, chunk_stagger=True, ck=4),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_live_loop_schedule_matches_jax(tmp_path, case):
    kw = dict(LOOP_CASES[case])
    ck = kw.pop("ck", None)
    out = {}
    for pkg, loop in (("jax", j_live_loop), ("torch", live_loop)):
        reg = _registry(pkg)
        extra = {} if ck is None else dict(checkpoint_dir=str(tmp_path / f"ck-{pkg}"),
                                           checkpoint_every=ck)
        stats = loop(Feed(reg.dispatch_ids()), reg, n_ticks=TICKS, cadence_s=0.0,
                     alert_path=str(tmp_path / pkg), **kw, **extra)
        out[pkg] = (stats, reg, _lines(tmp_path / pkg))
    (js, jreg, jlines), (ts, treg, tlines) = out["jax"], out["torch"]
    assert tlines == jlines and len(tlines) > 0
    for key in ("ticks", "scored", "scored_by_group", "alerts", "dispatch_threads",
                "chunk_stagger", "micro_chunk", "checkpoints_saved"):
        assert ts.get(key) == js.get(key), key
    assert ts["dispatch_threads"] == min(kw.get("dispatch_threads", 1), len(treg.groups))
    for jg, tg in zip(jreg.groups, treg.groups):
        _assert_states_equal(_state("jax", jg), _state("torch", tg))
    # every group learns on every other tick (its phase's)
    assert ts["learned_group_ticks"] == len(treg.groups) * TICKS // 2
    assert ts["kernel_launches"] == {"tm_learn": 0}
    if kw.get("chunk_stagger"):
        sched = ts["schedule"]
        # every row tick: the two groups of its phase learn
        assert sched["learning_groups"] == [2] * TICKS
        assert sum(sched["groups_dispatched"]) >= len(treg.groups) * TICKS // 3

    # the schedule changes when, not what: the port's plain run holds the
    # same lines and state
    reg = _registry("torch")
    live_loop(Feed(reg.dispatch_ids()), reg, n_ticks=TICKS, cadence_s=0.0,
              alert_path=str(tmp_path / "plain"))
    assert sorted(_lines(tmp_path / "plain")) == sorted(tlines)
    for pg, tg in zip(reg.groups, treg.groups):
        _assert_states_equal(_state("torch", pg), _state("torch", tg))


DYNAMIC_CASES = {
    # test_auto_register_composes_with_chunk_stagger
    "auto-register": dict(loop=dict(auto_register=True), reserve=2, n=6,
                          feed=dict(joins={7: ["late.a"], 13: ["late.b"]})),
    # test_auto_release_composes_with_chunk_stagger
    "auto-release": dict(loop=dict(auto_release_after=4, auto_register=True), reserve=0, n=6,
                         feed=dict(silent={"n0.m1": 6}, joins={14: ["late.z"]})),
}


@pytest.mark.parametrize("case", list(DYNAMIC_CASES))
def test_chunk_stagger_composes_with_membership_as_jax(tmp_path, case):
    spec = DYNAMIC_CASES[case]
    out = {}
    for pkg, loop in (("jax", j_live_loop), ("torch", live_loop)):
        reg = _registry(pkg, ids=IDS[:spec["n"]], reserve=spec["reserve"])
        stats = loop(Feed(reg.dispatch_ids(), **spec["feed"]), reg, n_ticks=TICKS,
                     cadence_s=0.0, alert_path=str(tmp_path / pkg), micro_chunk=3,
                     chunk_stagger=True, **spec["loop"])
        out[pkg] = (stats, reg, _lines(tmp_path / pkg))
    (js, jreg, jlines), (ts, treg, tlines) = out["jax"], out["torch"]
    assert tlines == jlines and len(tlines) > 0
    for key in ("ticks", "scored", "scored_by_group", "auto_registered", "auto_rejected",
                "auto_released", "chunk_stagger"):
        assert ts.get(key) == js.get(key), key
    assert ts["chunk_stagger"] is True
    assert [g.stream_ids for g in treg.groups] == [g.stream_ids for g in jreg.groups]
    for jg, tg in zip(jreg.groups, treg.groups):
        _assert_states_equal(_state("jax", jg), _state("torch", tg))
    if case == "auto-register":
        assert ts["auto_registered"] == 2
    else:
        assert ts["auto_released"] == 1 and ts["auto_registered"] == 1


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_resume_under_stagger_learn_reproduces_phases(tmp_path, writer):
    """A checkpointed staggered serve, resumed by the port with the same
    flags: the same phases, the state of an uninterrupted run. The first
    life is the port's own, or the JAX package's (its orbax save_group,
    imported by load_group)."""
    ck = str(tmp_path / "ck")
    first = _registry(writer)
    loop = live_loop if writer == "torch" else j_live_loop
    loop(Feed(first.dispatch_ids()), first, n_ticks=TICKS // 2, cadence_s=0.0,
         checkpoint_dir=ck, micro_chunk=3, chunk_stagger=True)
    resumed = _registry("torch")
    stats = live_loop(Feed(resumed.dispatch_ids(), base=TICKS // 2), resumed,
                      n_ticks=TICKS // 2, cadence_s=0.0, checkpoint_dir=ck)
    assert stats["resumed_from"] == {f"group{gi}": TICKS // 2 for gi in range(4)}
    assert [g.cfg.learn_phase for g in resumed.groups] == [0, 1, 0, 1]
    ref = _registry("torch")
    live_loop(Feed(ref.dispatch_ids()), ref, n_ticks=TICKS, cadence_s=0.0)
    for rg, g in zip(ref.groups, resumed.groups):
        _assert_states_equal(_state("torch", rg), _state("torch", g))


@pytest.mark.parametrize("kw,needle", [
    (dict(chunk_stagger=True), "chunk_stagger needs micro_chunk >= 2"),
    (dict(dispatch_threads=0), "dispatch_threads must be >= 1; got 0"),
], ids=["chunk_stagger", "dispatch_threads"])
def test_validation_errors_match_jax(kw, needle):
    msgs = []
    for pkg, loop in (("jax", j_live_loop), ("torch", live_loop)):
        reg = _registry(pkg)
        with pytest.raises(ValueError) as e:
            loop(Feed(reg.dispatch_ids()), reg, n_ticks=2, cadence_s=0.0, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == needle


@pytest.mark.parametrize("depth", [1, 2])
def test_alert_cursor_under_chunk_stagger_covers_every_class_unlike_the_reference(
        tmp_path, depth):
    """A journal cursor (t, off) tells a hot standby that every alert line
    of ticks <= t sits below byte off. Under chunk_stagger the phase
    classes emit on their own boundaries: the port names the tick every
    class has collected through; the reference names its loop tick, while
    other classes still hold that tick's rows."""
    from rtap_tpu.resilience import journal as jj
    from rtap_tpu_torch.resilience import journal as tj

    for pkg, loop, mod in (("torch", live_loop, tj), ("jax", j_live_loop, jj)):
        work = tmp_path / pkg
        journal = mod.TickJournal(str(work / "j"))
        reg = _registry(pkg, threshold=0.0, debounce=1)
        try:
            loop(Feed(reg.dispatch_ids()), reg, n_ticks=10, cadence_s=0.0,
                 alert_path=str(work / "alerts.jsonl"), journal=journal, pipeline_depth=depth,
                 micro_chunk=3, chunk_stagger=True)
        finally:
            journal.close()
        cursors = list(mod.TickJournal(str(work / "j")).cursors)
        lines, end = [], 0
        with open(work / "alerts.jsonl", "rb") as f:
            for line in f:
                end += len(line)
                rec = json.loads(line)
                if "alert_id" in rec:
                    lines.append((int(rec["alert_id"].rsplit(":", 1)[1]), end))
        assert cursors and len(lines) == len(IDS) * 10
        covered = all(end <= off for t, off in cursors for tick, end in lines if tick <= t)
        assert covered is (pkg == "torch"), (pkg, cursors)


# ---- counters under threads ----

def test_launch_count_is_exact_under_threads():
    import rtap_tpu_torch.ops.tm_learn as tl

    tl.reset_launches()
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda _: [tl.count_launch() for _ in range(2000)], range(16)))
    assert tl.launches == 16 * 2000
    tl.reset_launches()


def test_learned_group_ticks_equal_launches_from_a_pool(monkeypatch, tmp_path):
    """The loop's learned group-ticks and its kernel-launch count agree
    under dispatch_threads and a cadence, with the plain pass standing in
    for the kernel (it counts a launch as the kernel does on the card)."""
    import rtap_tpu_torch.ops.tm_learn as tl

    plain = tl.tm_learn_plain

    def counted(*a, **k):
        tl.count_launch()
        return plain(*a, **k)

    monkeypatch.setattr(tl, "tm_learn_plain", counted)
    reg = _registry("torch")
    stats = live_loop(Feed(reg.dispatch_ids()), reg, n_ticks=TICKS, cadence_s=0.0,
                      dispatch_threads=4, micro_chunk=3, chunk_stagger=True,
                      pipeline_depth=2)
    assert stats["dispatch_threads"] == 4
    assert stats["kernel_launches"]["tm_learn"] == stats["learned_group_ticks"] \
        == len(reg.groups) * TICKS // 2
    assert sum(stats["schedule"]["kernel_launches"]) == stats["learned_group_ticks"]


def test_a_raising_pool_thread_quarantines_its_group(tmp_path):
    """A dispatch that raises in a pool thread quarantines that group
    (never swallowed); the others score on."""
    from rtap_tpu_torch.service import registry

    reg = _registry("torch")
    bad = reg.groups[2]
    orig = registry.StreamGroup.dispatch_chunk

    def dispatch(self, *a, **k):
        if self is bad and self.ticks >= 6:
            raise RuntimeError("injected")
        return orig(self, *a, **k)

    registry.StreamGroup.dispatch_chunk = dispatch
    try:
        stats = live_loop(Feed(reg.dispatch_ids()), reg, n_ticks=TICKS, cadence_s=0.0,
                          dispatch_threads=4, alert_path=str(tmp_path / "a"))
    finally:
        registry.StreamGroup.dispatch_chunk = orig
    assert stats["quarantined"]["group2"]["phase"] == "dispatch"
    assert "injected" in stats["quarantined"]["group2"]["error"]
    assert stats["scored_by_group"][0] == 2 * TICKS and stats["scored_by_group"][2] < 2 * TICKS


# ---- the serve CLI ----

def _serve_args(main_mod, argv, monkeypatch):
    """The Namespace `main` hands to its serve command for `argv`."""
    got = {}
    monkeypatch.setattr(main_mod, "_cmd_serve", lambda a: got.setdefault("args", a) and 0)
    main_mod.main(["serve", "--streams", "a", *argv])
    return got["args"]


@pytest.mark.parametrize("argv", [[], ["--no-aot-warmup", "--stagger-learn", "--chunk-stagger",
                                       "--micro-chunk", "3", "--dispatch-threads", "4"]],
                         ids=["defaults", "given"])
def test_scheduling_flags_parse_as_jax(monkeypatch, argv):
    import rtap_tpu.__main__ as jmain
    import rtap_tpu_torch.__main__ as tmain

    keys = ("aot_warmup", "stagger_learn", "chunk_stagger", "dispatch_threads", "micro_chunk")
    j = _serve_args(jmain, argv, monkeypatch)
    t = _serve_args(tmain, argv, monkeypatch)
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
    if not argv:
        assert t.aot_warmup is True and t.dispatch_threads == 1


def test_serve_cli_runs_the_scheduling_flags(tmp_path):
    from rtap_tpu_torch.service.sources import send_jsonl

    ids = [f"s{i}" for i in range(6)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams", ",".join(ids),
         "--ticks", "9", "--cadence", "0.1", "--device", "cpu", "--port", "0",
         "--columns", "32", "--group-size", "2", "--stagger-learn", "--learn-every", "2",
         "--learn-full-until", "0", "--chunk-stagger", "--micro-chunk", "3",
         "--dispatch-threads", "2", "--alerts", str(tmp_path / "alerts.jsonl")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port, lines = None, []

    def read_stderr():
        nonlocal port
        for line in proc.stderr:
            lines.append(line)
            if "listening for JSONL records on" in line:
                port = int(line.rsplit(":", 1)[1])

    threading.Thread(target=read_stderr, daemon=True).start()
    deadline = time.time() + 120
    while port is None and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    assert port, (proc.poll(), "".join(lines)[-2000:])
    stop = threading.Event()

    def produce():
        k = 0
        while not stop.is_set():
            send_jsonl(("127.0.0.1", port), [{"id": s, "value": 40.0 + k + i,
                                              "ts": 1_700_000_000 + k}
                                             for i, s in enumerate(ids)])
            k += 1
            time.sleep(0.05)

    threading.Thread(target=produce, daemon=True).start()
    out, _ = proc.communicate(timeout=300)
    stop.set()
    assert proc.returncode == 0, "".join(lines)[-2000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["ticks"] == 9 and stats["scored"] == 9 * len(ids)
    assert stats["chunk_stagger"] is True and stats["dispatch_threads"] == 2
    assert stats["micro_chunk"] == 3 and stats["n_groups"] == 3
    # the warm-up is on by default; on the CPU it has nothing to warm
    assert stats["aot_programs_compiled"] == 0 and stats["aot_kernel_launches"] == 0
    # 3 groups learning every other tick, on their own phases
    assert stats["learned_group_ticks"] == 3 * 9 // 2 + 1
    assert stats["schedule"]["learning_groups"] == [2, 1] * 4 + [2]
