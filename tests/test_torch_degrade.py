"""PyTorch port vs the JAX package: the degradation ladder.

The same per-tick miss sequences through the JAX ``DegradationController``
and the port's give the same level trajectory, the same ``learn_allowed``
and ``cadence_scale`` answers and the same events, exactly.
"""

import numpy as np
import pytest

from rtap_tpu.resilience import LADDER as J_LADDER
from rtap_tpu.resilience import DegradationController as JDeg
from rtap_tpu_torch.resilience import LADDER, DegradationController


def _trajectory(cls, misses, **kw):
    events = []
    ctl = cls(event_sink=events.append, **kw)
    rows = []
    for t, m in enumerate(misses):
        level = ctl.observe(t, bool(m))
        rows.append((level, ctl.learn_allowed(t), ctl.cadence_scale))
    return rows, events, ctl.stats()


def _sequences():
    rng = np.random.default_rng(5)
    out = {
        "burst-then-clean": [1] * 12 + [0] * 60,
        "flapping": [1, 0] * 40,
        "sparse": [int(x) for x in rng.random(120) < 0.2],
        "dense": [int(x) for x in rng.random(120) < 0.7],
    }
    for seed in range(4):
        r = np.random.default_rng(seed)
        out[f"seeded-{seed}"] = [int(x) for x in r.random(150) < r.uniform(0.1, 0.6)]
    return out


SEQUENCES = _sequences()
KNOBS = {"default": {}, "tight": dict(window=4, degrade_after=2, recover_after=5,
                                      thin_factor=2, widen_factor=3.0)}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_same_misses_same_levels_and_events(seq, knobs):
    misses = SEQUENCES[seq]
    j = _trajectory(JDeg, misses, **KNOBS[knobs])
    t = _trajectory(DegradationController, misses, **KNOBS[knobs])
    assert t == j


def test_ladder_and_validation_match():
    assert LADDER == J_LADDER
    for bad in (dict(window=0), dict(degrade_after=11), dict(thin_factor=1),
                dict(widen_factor=1.0)):
        with pytest.raises(ValueError) as je:
            JDeg(**bad)
        with pytest.raises(ValueError) as te:
            DegradationController(**bad)
        assert str(te.value) == str(je.value)
