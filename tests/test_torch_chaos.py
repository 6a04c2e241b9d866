"""PyTorch port vs the JAX package: the chaos vocabulary and engine.

* ``ChaosSpec.generate`` gives the JAX package's schedule, fault for fault,
  and the same ``digest()`` for seeds 0-7 (and the supervised/topology
  draws); a spec file written by either package loads in the other.
* Both engines inject at the same ticks under the same routing: every
  source kind, group-targeted ``source_timeout``, ``topology_burst``, the
  group seams, ``proc_exit`` and the (not yet consumed) wire seam.
"""

import dataclasses
import json

import numpy as np
import pytest

from rtap_tpu.resilience import chaos as jchaos
from rtap_tpu_torch.resilience import chaos


def _faults(spec):
    return [dataclasses.asdict(f) for f in spec.faults]


def test_vocabulary_matches():
    for name in ("FAULT_KINDS", "GENERATED_KINDS", "GROUP_KINDS", "PROC_EXIT_CODE"):
        assert getattr(chaos, name) == getattr(jchaos, name), name


SHAPES = [dict(n_ticks=120, n_groups=4, rate=0.08), dict(n_ticks=40, n_groups=3, rate=0.12),
          dict(n_ticks=300, n_groups=8, rate=0.3),
          dict(n_ticks=96, n_groups=2, rate=0.1,
               kinds=("source_timeout", "source_malformed", "alert_sink_oserror")),
          dict(n_ticks=120, n_groups=1, rate=0.08, kinds=("source_timeout",)),
          dict(n_ticks=80, n_groups=2, rate=0.2,
               kinds=("conn_drop", "stall_socket", "corrupt_bytes"))]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("seed", range(8))
def test_generate_matches_jax_schedule_and_digest(seed, shape):
    kw = SHAPES[shape]
    j = jchaos.ChaosSpec.generate(seed=seed, **kw)
    t = chaos.ChaosSpec.generate(seed=seed, **kw)
    assert _faults(t) == _faults(j)
    assert t.to_dict() == j.to_dict()
    assert t.digest() == j.digest()
    for base in (0, 7, kw["n_ticks"] // 2):
        assert t.shifted(base).digest() == j.shifted(base).digest()


def test_spec_files_load_across_packages(tmp_path):
    spec = {"seed": 3, "faults": [
        {"kind": "topology_burst", "tick": 4, "duration": 3, "streams": [0, 1],
         "magnitude": 3.25},
        {"kind": "dispatch_hang", "tick": 2, "group": 1, "seconds": 0.05},
        {"kind": "proc_exit", "tick": 9}]}
    for writer, reader in ((jchaos, chaos), (chaos, jchaos)):
        path = tmp_path / f"{writer.__name__}.json"
        written = writer.ChaosSpec.from_dict(spec)
        path.write_text(json.dumps(written.to_dict()))
        back = reader.ChaosSpec.from_file(str(path))
        assert back.digest() == written.digest()
        assert _faults(back) == _faults(written)
    gen = {"seed": 5, "generate": {"n_ticks": 50, "n_groups": 2, "rate": 0.2}}
    assert chaos.ChaosSpec.from_dict(gen).digest() == jchaos.ChaosSpec.from_dict(gen).digest()


def test_bad_specs_fail_alike():
    for mod in (jchaos, chaos):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.Fault(kind="meteor_strike", tick=0)
        with pytest.raises(ValueError, match="'faults' OR 'generate'"):
            mod.ChaosSpec.from_dict({"faults": [], "generate": {"n_ticks": 1}})
        with pytest.raises(ValueError, match="rate"):
            mod.ChaosSpec.generate(seed=0, n_ticks=5, rate=2.0)


def _drive(mod, faults, routing):
    """Run an engine of `mod` through every seam for ticks 0..11 -> (the
    per-tick observations, the injection log)."""
    eng = mod.ChaosEngine(mod.ChaosSpec(faults=[mod.Fault(**f) for f in faults]))
    if routing is not None:
        eng.set_group_streams(routing)
    src = eng.wrap_source(lambda t: (np.arange(6, dtype=np.float32) + t, 1000 + t))
    seen = []
    for t in range(12):
        eng.set_tick(t)
        row = {}
        try:
            v, ts = src(t)
            row["src"] = (np.where(np.isnan(v), -1.0, v).tolist(), int(ts))
        except Exception as e:  # the raising source kinds
            row["src"] = type(e).__name__
        for seam in ("on_dispatch", "on_collect", "on_checkpoint_save"):
            for g in range(3):
                try:
                    getattr(eng, seam)(g, t)
                except Exception as e:
                    row[f"{seam}{g}"] = type(e).__name__
        try:
            row["wire"] = eng.on_wire(t, b"abcdef").hex()
        except ConnectionResetError as e:
            row["wire"] = type(e).__name__
        seen.append(row)
    return seen, eng.injected


FAULTS = [
    dict(kind="source_timeout", tick=1, group=1),
    dict(kind="source_timeout", tick=2, duration=2, streams=(0, 5)),
    dict(kind="source_malformed", tick=4),
    dict(kind="source_conn_drop", tick=5),
    dict(kind="source_backwards_ts", tick=6, ts_skew_s=100),
    dict(kind="topology_burst", tick=7, duration=2, streams=(2, 3), magnitude=7.5),
    dict(kind="source_timeout", tick=8, streams=(3,)),
    dict(kind="dispatch_exception", tick=3, group=1),
    dict(kind="collect_exception", tick=9),
    dict(kind="dispatch_hang", tick=10, group=2, seconds=0.001),
    dict(kind="checkpoint_oserror", tick=11, group=0),
    dict(kind="corrupt_bytes", tick=2),
    dict(kind="conn_drop", tick=6),
    dict(kind="stall_socket", tick=9, seconds=0.001),
]


@pytest.mark.parametrize("routing", [None, {0: (0, 1), 1: (2, 3), 2: (4, 5)}],
                         ids=["no-routing", "routing"])
def test_engines_inject_alike(routing):
    assert _drive(chaos, FAULTS, routing) == _drive(jchaos, FAULTS, routing)


def test_proc_exit_fires_after_its_tick_only(monkeypatch):
    eng = chaos.ChaosEngine(chaos.ChaosSpec(faults=[chaos.Fault(kind="proc_exit", tick=4)]))
    codes = []
    monkeypatch.setattr("os._exit", codes.append)
    for t in range(6):
        eng.on_tick_ingested(t)
    assert codes == [chaos.PROC_EXIT_CODE]
    assert eng.injected == [{"kind": "proc_exit", "tick": 4}]
    # a restart resuming past the kill drops the fault for good
    assert eng.spec.shifted(5).faults == []
