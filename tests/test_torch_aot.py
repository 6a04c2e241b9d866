"""PyTorch port vs the JAX package: the warm-up before tick 0
(rtap_tpu_torch/service/aot.py against rtap_tpu/service/aot.py).

* ``knowable_programs`` returns the JAX function's programs on the same
  groups (the twins in tests/integration/test_aot_serve.py): chunk lengths
  1..M x the distinct configs x the learn flags, learn=False added by a
  degradation ladder.
* ``warm_programs`` runs each program once, and the claim program, on a
  throwaway group of the real G, leaving the serving groups untouched; its
  count is the JAX warm-up's ``aot_programs_compiled`` (the CPU runs the
  plain path, so the test calls it directly: ``prewarm`` skips CPU groups,
  as the JAX package skips its CPU backend).
* With the warm-up in the loop, its kernel launches are reported apart from
  the scored ticks' and the loop dispatches no program it did not warm.

Exact: the program lists, the state after a warm-up.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.service.aot import knowable_programs as j_knowable
from rtap_tpu.service.loop import live_loop as j_live_loop
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.obs import get_registry
from rtap_tpu_torch.service import aot
from rtap_tpu_torch.service.loop import live_loop
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)

GROUP_SIZE = 3
N_STREAMS = 6  # two full groups
MICRO = 2
_J = j_scaled(32)


def _jcfg(learn_every=1):
    return _J.with_learn_every(learn_every, full_until=0) if learn_every > 1 else _J


def _registry(pkg, n=N_STREAMS, stagger=False, learn_every=1, reserve=0, health=False,
              predict=0):
    jcfg = _jcfg(learn_every)
    if pkg == "jax":
        reg = JReg(jcfg, group_size=GROUP_SIZE, backend="tpu", stagger_learn=stagger,
                   health=health, predict=predict)
    else:
        reg = StreamGroupRegistry(ModelConfig.from_dict(jcfg.to_dict()), group_size=GROUP_SIZE,
                                  device="cpu", stagger_learn=stagger, health=health,
                                  predict=predict)
    for i in range(n):
        reg.add_stream(f"a{i}")
    reg.finalize(reserve=reserve)
    return reg


def _feed_for(reg):
    n = len(reg.dispatch_ids())

    def feed(k):
        rng = np.random.Generator(np.random.Philox(key=(41, k)))
        return (30 + 5 * rng.random(n)).astype(np.float32), 1_700_000_000 + k

    return feed


class _Ladder:  # presence alone widens the learn-flag set
    pass


PROGRAM_CASES = {
    "plain": dict(micro=MICRO, stagger=False, learn_every=1, learn=True, ladder=False),
    "stagger": dict(micro=MICRO, stagger=True, learn_every=2, learn=True, ladder=False),
    "ladder": dict(micro=MICRO, stagger=True, learn_every=2, learn=True, ladder=True),
    "micro3-frozen": dict(micro=3, stagger=False, learn_every=1, learn=False, ladder=True),
    "micro1": dict(micro=1, stagger=False, learn_every=1, learn=True, ladder=False),
}


@pytest.mark.parametrize("case", list(PROGRAM_CASES))
def test_knowable_programs_match_jax(case):
    c = PROGRAM_CASES[case]
    got = {}
    for pkg, fn in (("jax", j_knowable), ("torch", aot.knowable_programs)):
        reg = _registry(pkg, stagger=c["stagger"], learn_every=c["learn_every"])
        progs = fn(reg.groups, c["micro"], c["learn"],
                   degradation=_Ladder() if c["ladder"] else None)
        got[pkg] = [(m, cfg.to_dict(), lf) for m, cfg, lf in progs]
    assert got["torch"] == got["jax"]
    n_cfgs = 2 if c["stagger"] else 1
    n_flags = 2 if c["ladder"] and c["learn"] else 1
    assert len(got["torch"]) == c["micro"] * n_cfgs * n_flags


@pytest.mark.parametrize("flags", [dict(), dict(health=True, predict=4)],
                         ids=["plain", "health-predict"])
def test_warm_programs_runs_each_program_and_leaves_the_groups_untouched(flags):
    reg = _registry("torch", stagger=True, learn_every=2, n=5, **flags)
    before = [state_to_numpy(g.state) for g in reg.groups]
    ticks0 = [(g.ticks, g._tick0, g._seq) for g in reg.groups]

    def count():
        return next((m["value"] for m in get_registry().snapshot()["metrics"]
                     if m["name"] == "rtap_obs_aot_programs_compiled_total"), 0)

    c0 = count()
    warmed = aot.warm_programs(reg.groups, MICRO, True, include_claim=True)
    want = aot.knowable_programs(reg.groups, MICRO, True)
    assert warmed == set(want) and len(warmed) == 2 * MICRO
    # each program, and the claim program of each config
    assert count() - c0 == len(warmed) + 2
    assert [(g.ticks, g._tick0, g._seq) for g in reg.groups] == ticks0
    for b, g in zip(before, reg.groups):
        after = state_to_numpy(g.state)
        for k in b:
            assert np.array_equal(b[k], after[k], equal_nan=b[k].dtype.kind == "f"), k


def test_prewarm_skips_cpu_groups():
    """The CPU loads no device modules: nothing is warmed, nothing counted
    (the JAX package's test_cpu_backend_prewarm_is_noop)."""
    reg = _registry("torch")
    assert aot.prewarm(reg.groups, MICRO, True, include_claim=True) == set()


@pytest.mark.parametrize("learn_every,phase,burst,want", [
    (1, 0, 1, 0), (4, 3, 1, 3), (4, 6, 3, 6), (2, 1, 1, 1)])
def test_first_learning_tick_is_on_the_cadence(learn_every, phase, burst, want):
    cfg = dataclasses.replace(
        ModelConfig.from_dict(_J.to_dict()).with_learn_every(learn_every, full_until=0,
                                                              burst=burst),
        learn_phase=phase)
    t = aot._first_learning_tick(cfg)
    assert t == want and bool(cfg.learns_on(t))


def test_loop_warm_up_counts_as_jax_and_launches_apart(monkeypatch):
    """live_loop(aot_warmup=True) with the CPU groups warmed as the card's
    would be (the plain pass counting a launch as the kernel does): its
    program count is the JAX loop's, the warm-up's launches stay out of
    ``kernel_launches``, and no dispatched program was left cold."""
    import rtap_tpu_torch.ops.tm_learn as tl

    plain = tl.tm_learn_plain

    def counted(*a, **k):
        tl.count_launch()
        return plain(*a, **k)

    monkeypatch.setattr(tl, "tm_learn_plain", counted)
    monkeypatch.setattr(aot, "prewarm", aot.warm_programs)
    kw = dict(n_ticks=7, cadence_s=0.0, micro_chunk=MICRO, chunk_stagger=True, aot_warmup=True)
    jreg = _registry("jax", stagger=True, learn_every=2)
    js = j_live_loop(_feed_for(jreg), jreg, **kw)
    reg = _registry("torch", stagger=True, learn_every=2)
    stats = live_loop(_feed_for(reg), reg, **kw)
    assert stats["aot_programs_compiled"] == js["aot_programs_compiled"] == 2 * MICRO
    assert stats["kernel_launches"]["tm_learn"] == stats["learned_group_ticks"]
    # one learning tick in each warmed program (each starts on a learning
    # tick; at learn_every 2 a 2-tick chunk learns once)
    assert stats["aot_kernel_launches"] == 2 * MICRO
    assert stats["aot_warmup_s"] > 0
    for jg, tg in zip(jreg.groups, reg.groups):
        import jax

        a = {k: np.asarray(v) for k, v in jax.device_get(jg.state).items()}
        b = state_to_numpy(tg.state)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
