"""Warm-up before tick 0: run every knowable serve program once on the card.

Port of the JAX package's ``service/aot.py``. The set of programs a serve
loop can dispatch is known at its start:

  chunk lengths   1..micro_chunk (steady-state flushes at M; boundary
                  alignments, the chunk-stagger ramp-in, membership changes
                  and the final tick flush every partial length below it)
  configs         one per distinct group ModelConfig (stagger_learn gives
                  groups distinct learn_phase fields)
  learn flags     the serve learn flag, plus learn=False when a degradation
                  ladder can freeze learning mid-run
  claim program   set_state_row (a dynamic slot claim), when claimable
                  capacity exists

:func:`knowable_programs` enumerates them exactly as the JAX function does.
On the card nothing is compiled ahead of time: eager PyTorch launches its
kernels as it goes. What a first tick pays instead is the CUDA modules the
eager stages and the TM learning kernel load lazily at their first launch,
the caching allocator's growth to the groups' shapes, and the pinned host
blocks the scores come back through. :func:`prewarm` pays all three before
tick 0 by running each program once through the loop's own entry points
(``StreamGroup.dispatch_chunk`` -> ``ops/step.chunk_step``, then
``collect_chunk``; ``set_state_row`` for the claim) on a THROWAWAY group of
the real G, config, health and predict flags. The serving groups' state,
likelihood and counters are untouched.

Exposed metric: rtap_obs_aot_programs_compiled_total, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from rtap_tpu_torch.obs import get_registry


def knowable_programs(groups, micro_chunk: int, learn: bool,
                      degradation=None) -> list[tuple]:
    """The (chunk length m, group config, learn flag) programs a serve loop
    with these parameters can ever dispatch: the loop's own warm-up keys,
    enumerated instead of discovered."""
    learn_flags = {bool(learn)}
    if degradation is not None and learn:
        # the ladder's score_only step (level >= 2) dispatches learn=False
        learn_flags.add(False)
    cfgs = []
    for g in groups:
        if g.cfg not in cfgs:
            cfgs.append(g.cfg)
    return [
        (m, cfg, lf)
        for cfg in cfgs
        for m in range(1, max(1, int(micro_chunk)) + 1)
        for lf in sorted(learn_flags)
    ]


def _first_learning_tick(cfg) -> int:
    """The first tick on which `cfg`'s cadence learns: a warm program with
    learning on starts there, so its TM learning pass really runs."""
    if not cfg.cadence_active:
        return 0
    horizon = cfg.learn_full_until + cfg.learn_every * cfg.learn_burst + cfg.learn_phase
    return next(t for t in range(horizon + 1) if cfg.learns_on(t))


def warm_programs(groups, micro_chunk: int, learn: bool, degradation=None,
                  include_claim: bool = False, seed: int = 0) -> set[tuple]:
    """Run every knowable program of `groups` once on a throwaway group per
    config (the real G, health and predict flags, on the groups' device)
    -> the warmed (m, config, learn) keys. Counts each program, and the
    claim program, in rtap_obs_aot_programs_compiled_total."""
    from rtap_tpu_torch.models.state import init_state
    from rtap_tpu_torch.ops.step import set_state_row
    from rtap_tpu_torch.service.registry import PAD_PREFIX, StreamGroup

    counter = get_registry().counter(
        "rtap_obs_aot_programs_compiled_total",
        "serve programs compiled-or-warmed ahead of tick 0 by the AOT "
        "warm-up (chunk lengths x group configs x learn flags, + claim "
        "programs; a re-warm of an already-cached program counts — the "
        "metric tracks warm-up passes, the jit cache dedupes compiles)")
    programs = knowable_programs(groups, micro_chunk, learn, degradation)
    by_cfg: dict = {}
    for m, cfg, lf in programs:
        by_cfg.setdefault(cfg, []).append((m, lf))
    warmed: set[tuple] = set()
    for cfg, mls in by_cfg.items():
        like = [g for g in groups if g.cfg == cfg]
        # the reducers are flags of the dispatched program and the predictor
        # sizes state leaves: warm what these groups will dispatch
        scratch = StreamGroup(cfg, [f"{PAD_PREFIX}{i}" for i in range(like[0].G)], seed=seed,
                              device=like[0].device,
                              health=any(g.health for g in like),
                              predict=max(g.predict for g in like))
        for m, lf in sorted(mls):
            # learning programs start on a learning tick, so the pass runs
            scratch._tick0 = _first_learning_tick(cfg) if lf else 0
            shape = (m, scratch.G) + ((cfg.n_fields,) if cfg.n_fields > 1 else ())
            scratch.collect_chunk(scratch.dispatch_chunk(
                np.full(shape, np.nan, np.float32), np.zeros((m, scratch.G), np.int64), lf))
            counter.inc()
            warmed.add((m, cfg, lf))
        if include_claim:
            # the claim program (registry.claim_slot -> set_state_row): one
            # row written covers every later claim
            scratch.state = set_state_row(scratch.state,
                                          init_state(cfg, seed, scratch.predict), 0)
            counter.inc()
        if scratch.device.type == "cuda":
            import torch

            torch.cuda.synchronize(scratch.device)
        del scratch
    return warmed


def prewarm(groups, micro_chunk: int, learn: bool, degradation=None,
            include_claim: bool = False, seed: int = 0) -> set[tuple]:
    """Warm every knowable program of the card's groups before tick 0
    (:func:`warm_programs`) -> the warmed key set, which live_loop seeds its
    own bookkeeping with. CPU groups load no device modules and are skipped,
    as the JAX package skips its CPU backend. A failure raises: the serve
    start fails, it never goes lazy quietly."""
    device_groups = [g for g in groups if g.device.type == "cuda"]
    if not device_groups:
        return set()
    return warm_programs(device_groups, micro_chunk, learn, degradation=degradation,
                         include_claim=include_claim, seed=seed)
