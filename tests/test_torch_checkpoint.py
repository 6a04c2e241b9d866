"""PyTorch port: group checkpoints (numpy leaves + the JAX package's
meta.json and directory protocol).

* A round trip is leaf-equal; a resumed group continues bit-identically to
  an uninterrupted one.
* A port checkpoint and a JAX checkpoint (read with the JAX load_group) of
  the same run at the same tick hold equal leaves and equal meta, and the
  port's import of the JAX checkpoint holds the JAX reading's leaves.
* Atomic overwrite, crash-mid-save residue recovery, loud failures on
  corrupt meta and mismatched resumes (mirroring
  tests/unit/test_checkpoint.py and tests/unit/test_checkpoint_failures.py).
* peek_resume_ticks and the validate_resume refusals.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.service import checkpoint as jck
from rtap_tpu.service.registry import StreamGroup as JStreamGroup
from rtap_tpu_torch.config import ModelConfig, scaled_cluster_preset
from rtap_tpu_torch.models.state import state_to_numpy
from rtap_tpu_torch.obs import get_registry
from rtap_tpu_torch.service.checkpoint import (
    _recover_residue,
    load_group,
    peek_resume_ticks,
    save_group,
    validate_resume,
)
from rtap_tpu_torch.service.registry import StreamGroup

torch.set_num_threads(1)


def _short(cfg):
    return dataclasses.replace(cfg, likelihood=dataclasses.replace(
        cfg.likelihood, learning_period=10, estimation_samples=5))


CFG = _short(scaled_cluster_preset(32))


def _vals(n, g, seed):
    rng = np.random.Generator(np.random.Philox(key=(seed, 11)))
    v = (40 + 8 * rng.random((n, g))).astype(np.float32)
    v[int(n * 0.7), :] += 50
    return v


def _group(ticks=3, cfg=CFG, ids=("a", "b"), **kw):
    grp = StreamGroup(cfg, list(ids), device="cpu", **kw)
    for i in range(ticks):
        grp.tick(np.array([1.0 + i] * len(ids), np.float32) + np.arange(len(ids)),
                 1_700_000_000 + i)
    return grp


def _dir_signature(path):
    return sorted((str(p.relative_to(path)), p.stat().st_mtime_ns) for p in path.rglob("*"))


def _leaves(grp):
    return {**{f"model/{k}": v for k, v in state_to_numpy(grp.state).items()},
            **{f"likelihood/{k}": np.asarray(v) for k, v in grp.likelihood.state_dict().items()},
            "alert_run": np.asarray(grp._alert_run)}


def test_roundtrip_leaf_equal_and_resume_bit_identical(tmp_path):
    ids = ["s0", "s1", "s2", "__pad0"]
    n, cut = 60, 30
    vals = _vals(n, 4, seed=1)
    vals[:, 3] = np.nan
    ref = StreamGroup(CFG, ids, seed=3, device="cpu", threshold=0.05, debounce=2)
    ref.run_chunk(vals[:cut], 1_700_000_000 + np.arange(cut)[:, None] * np.ones((1, 4)))
    save_group(ref, tmp_path / "grp0", alerts_offset=123, journal_tick=456)

    back = load_group(tmp_path / "grp0", device="cpu")
    assert back.stream_ids == ids and back.ticks == cut and back.n_live == 3
    assert (back.threshold, back.debounce, back.cfg) == (0.05, 2, CFG)
    assert (back.resume_alerts_offset, back.resume_journal_tick) == (123, 456)
    a, b = _leaves(ref), _leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k], equal_nan=True), k
    for i in range(cut, n):
        ts = 1_700_000_000 + i
        r_ref, r_res = ref.tick(vals[i], ts), back.tick(vals[i], ts)
        np.testing.assert_array_equal(r_ref.raw, r_res.raw, err_msg=f"tick {i}")
        np.testing.assert_array_equal(r_ref.log_likelihood, r_res.log_likelihood)
        np.testing.assert_array_equal(r_ref.alerts, r_res.alerts)
    meta = json.loads((tmp_path / "grp0" / "meta.json").read_text())
    assert meta["backend"] == "torch" and meta["n_live"] == 3


def test_port_and_jax_checkpoints_hold_equal_leaves(tmp_path):
    """The same run in both packages, saved at the same tick: the JAX
    package's orbax checkpoint (read back with its own load_group) and the
    port's numpy checkpoint hold equal leaves and the same meta keys."""
    import jax

    jcfg = _short(j_scaled(32))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    ids = ["a", "b", "c"]
    vals = _vals(40, 3, seed=2)
    ts = 1_700_000_000 + np.arange(40)[:, None] * np.ones((1, 3))
    jg = JStreamGroup(jcfg, ids, seed=0, backend="tpu", threshold=0.05)
    tg = StreamGroup(cfg, ids, seed=0, device="cpu", threshold=0.05)
    jg.run_chunk(vals, ts)
    tg.run_chunk(vals, ts)
    jck.save_group(jg, tmp_path / "jax", alerts_offset=7, journal_tick=40)
    save_group(tg, tmp_path / "torch", alerts_offset=7, journal_tick=40)
    jb = jck.load_group(tmp_path / "jax")
    tb = load_group(tmp_path / "torch", device="cpu")
    jleaves = {**{f"model/{k}": np.asarray(v) for k, v in jax.device_get(jb.state).items()},
               **{f"likelihood/{k}": np.asarray(v) for k, v in jb.likelihood.state_dict().items()},
               "alert_run": np.asarray(jb._alert_run)}
    tleaves = _leaves(tb)
    assert jleaves.keys() == tleaves.keys()
    for k in jleaves:
        assert jleaves[k].dtype == tleaves[k].dtype, k
        assert np.array_equal(jleaves[k], tleaves[k], equal_nan=True), k
    jm = json.loads((tmp_path / "jax" / "meta.json").read_text())
    tm = json.loads((tmp_path / "torch" / "meta.json").read_text())
    assert jm.keys() == tm.keys()
    assert {k: v for k, v in jm.items() if k != "backend"} == \
        {k: v for k, v in tm.items() if k != "backend"}
    # the port imports the JAX (orbax) checkpoint: its leaves equal the
    # JAX package's own reading of it
    imported = _leaves(load_group(tmp_path / "jax", device="cpu"))
    assert imported.keys() == jleaves.keys()
    for k in jleaves:
        assert imported[k].dtype == jleaves[k].dtype, k
        assert np.array_equal(imported[k], jleaves[k], equal_nan=True), k


def test_checkpoint_overwrite_atomic(tmp_path):
    grp = _group(ticks=1)
    save_group(grp, tmp_path / "g")
    grp.tick(np.array([3.0, 4.0], np.float32), 1_700_000_001)
    save_group(grp, tmp_path / "g")  # overwrite
    assert load_group(tmp_path / "g", device="cpu").ticks == 2
    assert [p.name for p in tmp_path.iterdir() if p.name != "g"] == []


def test_recover_residue_renames_complete_old_sibling(tmp_path):
    save_group(_group(ticks=4), tmp_path / "g")
    (tmp_path / "g").rename(tmp_path / ".g.old-deadbeef")
    back = load_group(tmp_path / "g", device="cpu")
    assert back.ticks == 4
    assert (tmp_path / "g" / "meta.json").exists()
    assert not (tmp_path / ".g.old-deadbeef").exists()


def test_recover_residue_prefers_newest_and_ignores_incomplete(tmp_path):
    grp = _group(ticks=2)
    save_group(grp, tmp_path / "g")
    grp.tick(np.array([9.0, 9.0], np.float32), 1_700_000_099)
    save_group(grp, tmp_path / "g2")
    (tmp_path / ".g.tmp-junk").mkdir()
    (tmp_path / "g2").rename(tmp_path / ".g.old-newer")
    shutil.rmtree(tmp_path / "g")
    assert _recover_residue(tmp_path / "g") == tmp_path / "g"
    assert load_group(tmp_path / "g", device="cpu").ticks == 3
    assert (tmp_path / ".g.tmp-junk").exists()


def test_recover_residue_noop_when_checkpoint_intact(tmp_path):
    save_group(_group(), tmp_path / "g")
    (tmp_path / ".g.old-stale").mkdir()
    sig = _dir_signature(tmp_path / "g")
    assert _recover_residue(tmp_path / "g") == tmp_path / "g"
    assert _dir_signature(tmp_path / "g") == sig


def test_next_save_sweeps_prior_residue_only_after_landing(tmp_path):
    grp = _group()
    save_group(grp, tmp_path / "g")
    (tmp_path / ".g.tmp-crashed").mkdir()
    (tmp_path / ".g.old-crashed").mkdir()
    grp.tick(np.array([3.0, 4.0], np.float32), 1_700_000_050)
    save_group(grp, tmp_path / "g")
    assert [p.name for p in tmp_path.iterdir() if p.name != "g"] == []
    assert load_group(tmp_path / "g", device="cpu").ticks == 4


@pytest.mark.parametrize("damage", ["corrupt", "truncated", "missing"])
def test_bad_meta_fails_loudly_and_good_sibling_untouched(tmp_path, damage):
    grp = _group(ticks=5)
    save_group(grp, tmp_path / "good")
    save_group(grp, tmp_path / "bad")
    meta = tmp_path / "bad" / "meta.json"
    if damage == "missing":
        meta.unlink()
    else:
        meta.write_text("not json {{{" if damage == "corrupt" else meta.read_text()[:40])
    sig = _dir_signature(tmp_path / "good")
    with pytest.raises(FileNotFoundError if damage == "missing" else json.JSONDecodeError):
        load_group(tmp_path / "bad", device="cpu")
    assert _dir_signature(tmp_path / "good") == sig
    assert load_group(tmp_path / "good", device="cpu").ticks == 5


def test_failed_save_leaves_previous_checkpoint_intact(tmp_path, monkeypatch):
    from rtap_tpu_torch.service import checkpoint as ck

    grp = _group(ticks=3)
    save_group(grp, tmp_path / "g")
    sig = _dir_signature(tmp_path / "g")
    failures = get_registry().counter("rtap_obs_checkpoint_save_failures_total")
    before = failures.value
    grp.tick(np.array([7.0, 8.0], np.float32), 1_700_000_060)

    def boom(*a, **kw):
        raise OSError(28, "no space left on device")

    monkeypatch.setattr(ck.np, "save", boom)
    with pytest.raises(OSError):
        save_group(grp, tmp_path / "g")
    monkeypatch.undo()
    assert failures.value - before == 1
    assert _dir_signature(tmp_path / "g") == sig
    assert [p.name for p in tmp_path.iterdir()] == ["g"]
    assert load_group(tmp_path / "g", device="cpu").ticks == 3


@pytest.mark.parametrize("other", [
    dict(cfg=_short(scaled_cluster_preset(16))),
    dict(threshold=0.9),
    dict(debounce=3),
    dict(ids=("a", "c")),
    dict(ids=("a", "b", "c")),
], ids=["config", "threshold", "debounce", "stream-id", "slots"])
def test_validate_resume_refusals(tmp_path, other):
    save_group(_group(ticks=4), tmp_path / "g")
    sig = _dir_signature(tmp_path / "g")
    resumed = load_group(tmp_path / "g", device="cpu")
    kw = {k: v for k, v in other.items() if k != "ids"}
    built = StreamGroup(kw.pop("cfg", CFG), list(other.get("ids", ("a", "b"))),
                        device="cpu", **kw)
    with pytest.raises(ValueError, match="disagrees|refusing to resume"):
        validate_resume(resumed, tmp_path / "g", built)
    assert _dir_signature(tmp_path / "g") == sig


def test_validate_resume_claimed_extras(tmp_path):
    grp = StreamGroup(CFG, ["a", "__pad0"], device="cpu")
    grp.claim_slot("late")
    save_group(grp, tmp_path / "g")
    resumed = load_group(tmp_path / "g", device="cpu")
    built = StreamGroup(CFG, ["a", "__pad0"], device="cpu")
    with pytest.raises(ValueError, match="--auto-register"):
        validate_resume(resumed, tmp_path / "g", built)
    validate_resume(resumed, tmp_path / "g", built, allow_claimed_extras=True)


def test_peek_resume_ticks(tmp_path):
    assert peek_resume_ticks(tmp_path / "absent") == 0
    save_group(_group(ticks=3), tmp_path / "group0000")
    save_group(_group(ticks=5), tmp_path / "group0001")
    (tmp_path / "group0002").mkdir()  # no meta: skipped
    (tmp_path / "other").mkdir()
    assert peek_resume_ticks(tmp_path) == 5
    assert peek_resume_ticks(tmp_path) == jck.peek_resume_ticks(tmp_path)


def test_a_save_swapping_the_dir_under_a_read_is_refused_not_torn(tmp_path, monkeypatch):
    """A standby adopts checkpoints while its leader saves into the same dir.
    A save whose swap lands between load_group's meta read and its state
    read used to pair the old meta (tick 3) with the new leaves (tick 5): the
    standby then re-applied ticks 3-4 on top and its state diverged from the
    fault-free run (the fleet chaos drill, where a warm spare starts reading
    within milliseconds of its shard's takeover checkpoint; ROADMAP.md §C).
    The read now refuses a replaced directory, and a re-read is consistent."""
    import rtap_tpu_torch.service.checkpoint as ck

    grp = _group(ticks=3)
    save_group(grp, tmp_path / "g")
    for i in (3, 4):
        grp.tick(np.array([1.0 + i, 2.0 + i], np.float32), 1_700_000_000 + i)
    real, swapped = ck.read_npy_tree, []

    def read_during_a_save(root):
        if not swapped:  # the leader's next save lands mid-read
            swapped.append(True)
            save_group(grp, tmp_path / "g")
        return real(root)

    monkeypatch.setattr(ck, "read_npy_tree", read_during_a_save)
    with pytest.raises(ck.CheckpointReplaced):
        load_group(tmp_path / "g", device="cpu")
    back = load_group(tmp_path / "g", device="cpu")  # the re-read
    assert back.ticks == 5
    a, b = _leaves(grp), _leaves(back)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
