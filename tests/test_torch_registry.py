"""PyTorch port vs the JAX package: the stream-group registry's membership
surface for the same ids and operations — finalize(reserve), lookup,
dispatch_ids, slot_map, remove_stream, claims and releases, version,
free_slots and n_streams."""

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.service.registry import StreamGroupRegistry as TReg

torch.set_num_threads(1)

JCFG = j_scaled(16)
CFG = ModelConfig.from_dict(JCFG.to_dict())


def _surface(reg):
    return {
        "ids": [list(g.stream_ids) for g in reg.groups],
        "dispatch": reg.dispatch_ids(),
        "slot_map": {k: (v.shard, v.group, v.slot) for k, v in reg.slot_map().items()},
        "live": [g.live_slots().tolist() for g in reg.groups],
        "free": reg.free_slots,
        "n": reg.n_streams,
        "version": reg.version,
        "lookup": {sid: (reg.groups.index(reg.lookup(sid)[0]), reg.lookup(sid)[1])
                   for sid in reg.dispatch_ids()},
    }


def _apply(reg, ops):
    out = []
    for op, arg in ops:
        try:
            if op == "add":
                reg.add_stream(arg)
            elif op == "remove":
                reg.remove_stream(arg)
            elif op == "finalize":
                reg.finalize(reserve=arg)
            out.append((op, arg, "ok", _surface(reg) if reg._finalized else None,
                        arg in reg if isinstance(arg, str) else None))
        except (KeyError, ValueError, RuntimeError) as e:
            out.append((op, arg, type(e).__name__))
    return out


@pytest.mark.parametrize("n_ids,group_size,reserve", [
    (5, 3, 0), (5, 3, 1), (5, 3, 4), (6, 3, 0), (6, 3, 5), (2, 4, 9),
])
def test_registry_surface_matches_jax(n_ids, group_size, reserve):
    ids = [f"n{i // 3}.m{i % 3}" for i in range(n_ids)]
    ops = ([("add", s) for s in ids] + [("add", ids[0]), ("add", "__pad7"),
                                        ("remove", ids[0]), ("finalize", reserve)]
           + [("add", f"late{i}") for i in range(reserve + 2)]
           + [("remove", ids[1]), ("remove", "ghost"), ("add", "again"),
              ("add", ids[1]), ("remove", "late0"), ("add", "late9")])
    j = JReg(JCFG, group_size=group_size, backend="cpu", threshold=0.2)
    t = TReg(CFG, group_size=group_size, device="cpu", threshold=0.2)
    assert _apply(t, ops) == _apply(j, ops)


def test_claims_reset_state_like_jax_claim():
    """A claimed slot's state is re-initialized from the group's seed, as in
    the JAX package (leaf-equal to a fresh stream of that group)."""
    from rtap_tpu_torch.models.state import init_state, state_to_numpy

    t = TReg(CFG, group_size=2, device="cpu", seed=5)
    t.add_stream("a")
    t.finalize(reserve=2)
    assert len(t.groups) == 2
    t.groups[1].run_chunk(np.full((3, 2, 1), 5.0, np.float32),
                          np.full((3, 2), 1_700_000_000, np.int64))
    t.add_stream("b")  # group 0's rounding pad
    t.add_stream("c")  # group 1's first pad
    assert t.lookup("c")[1] == 0 and t.lookup("c")[0] is t.groups[1]
    fresh = init_state(CFG, 6)
    got = state_to_numpy(t.groups[1].state)
    for k, v in fresh.items():
        assert np.array_equal(got[k][0], v), k
