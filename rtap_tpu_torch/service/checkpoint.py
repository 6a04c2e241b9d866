"""Checkpoint / resume for stream groups.

The port's counterpart of the JAX package's ``service/checkpoint.py``. A
checkpoint is a group's full resume state: the model state (fetched from
the device), the batched-likelihood state, the debounce counters, the
stream ids, the tick count and the model config. The directory protocol
and ``meta.json`` are the JAX package's: the tree and meta are written to a
fresh temp sibling and swapped in with renames, meta last (its presence
marks a checkpoint complete), and a load after a crash mid-save rolls the
newest complete residue sibling into place.

The one difference is the tree's encoding. The JAX package writes it with
orbax, which imports JAX; the port writes one ``.npy`` file per leaf
(``state/model/<leaf>.npy``, ``state/likelihood/<leaf>.npy``,
``state/alert_run.npy``) with numpy, and ``meta.json`` says
``"backend": "torch"``. A resumed group continues bit-identically to an
uninterrupted run.
"""

from __future__ import annotations

import json
import logging
import shutil
import time
import uuid
from pathlib import Path

import numpy as np

from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import state_from_numpy, state_to_numpy
from rtap_tpu_torch.obs import get_registry
from rtap_tpu_torch.service.registry import PAD_PREFIX, StreamGroup

BACKEND = "torch"


def _write_tree(root: Path, tree: dict) -> None:
    root.mkdir(parents=True, exist_ok=True)
    for k, v in tree.items():
        if isinstance(v, dict):
            _write_tree(root / k, v)
        else:
            np.save(root / f"{k}.npy", np.asarray(v), allow_pickle=False)


def _read_tree(root: Path) -> dict:
    out = {}
    for p in sorted(root.iterdir()):
        if p.is_dir():
            out[p.name] = _read_tree(p)
        elif p.suffix == ".npy":
            out[p.stem] = np.load(p, allow_pickle=False)
    return out


def save_group(grp: StreamGroup, path: str | Path,
               alerts_offset: int | None = None,
               journal_tick: int | None = None) -> None:
    """Write one group's resume state to `path` (a directory per group),
    atomically on overwrite.

    `alerts_offset` is the alert sink's byte size at this save instant:
    saves happen with the pipeline drained and the sink flushed, so every
    alert for ticks <= this checkpoint's ``ticks`` sits before the cursor,
    and a resume suppresses exactly the ids past it. `journal_tick` is the
    global journal tick cursor at this instant; the journal replay matches
    rows by it, never by the group's own counter."""
    obs = get_registry()
    t_save = time.perf_counter()
    path = Path(path).absolute()
    tree = {
        "model": state_to_numpy(grp.state),
        "likelihood": grp.likelihood.state_dict(),
        "alert_run": np.asarray(grp._alert_run),
    }
    meta = {
        "backend": BACKEND,
        "stream_ids": grp.stream_ids,
        "ticks": grp.ticks,
        "threshold": grp.threshold,
        "debounce": grp.debounce,
        "predict": grp.predict,
        "n_live": grp.n_live,
        "sharded": False,
        "config": grp.cfg.to_dict(),
        "alert_epoch": 0,
    }
    if alerts_offset is not None:
        meta["alerts_offset"] = int(alerts_offset)
    if journal_tick is not None:
        meta["journal_tick"] = int(journal_tick)
    tmp = path.parent / f".{path.name}.tmp-{uuid.uuid4().hex[:8]}"
    swapped = False
    try:
        tmp.mkdir(parents=True)
        _write_tree(tmp / "state", tree)
        # meta written AFTER the tree: its presence marks the checkpoint complete
        (tmp / "meta.json").write_text(json.dumps(meta))
        if path.exists():
            old = path.parent / f".{path.name}.old-{uuid.uuid4().hex[:8]}"
            path.rename(old)
            try:
                tmp.rename(path)
                swapped = True
            except BaseException:
                old.rename(path)  # roll the previous checkpoint back in place
                raise
            shutil.rmtree(old, ignore_errors=True)
        else:
            tmp.rename(path)
            swapped = True
    except BaseException:
        # the previous checkpoint is intact (the whole write happened in
        # the temp sibling, swept below); the caller decides what to do
        obs.counter(
            "rtap_obs_checkpoint_save_failures_total",
            "group checkpoint saves that raised before landing (previous "
            "checkpoint left intact)").inc()
        raise
    finally:
        if not swapped:
            shutil.rmtree(tmp, ignore_errors=True)
    # sweep residue of PRIOR interrupted saves only after this save landed:
    # a complete residue sibling is load_group's crash fallback until then
    for pattern in (f".{path.name}.tmp-*", f".{path.name}.old-*"):
        for stale in path.parent.glob(pattern):
            if stale != tmp:
                shutil.rmtree(stale, ignore_errors=True)
    obs.counter("rtap_obs_checkpoint_saves_total",
                "atomic per-group checkpoint saves that fully landed").inc()
    obs.histogram("rtap_obs_checkpoint_save_seconds",
                  "wall seconds per group save (state fetch + leaf write + "
                  "swap)").observe(time.perf_counter() - t_save)


def _recover_residue(path: Path) -> Path:
    """If `path` is missing but a complete residue sibling from an
    interrupted save exists (meta.json present), rename the newest into
    place; return `path` either way (a load then fails on what is
    missing)."""
    if (path / "meta.json").exists():
        return path
    candidates = sorted(
        p
        for pattern in (f".{path.name}.old-*", f".{path.name}.tmp-*")
        for p in path.parent.glob(pattern)
        if (p / "meta.json").exists()
    )
    if candidates:
        best = max(candidates, key=lambda p: (p / "meta.json").stat().st_mtime)
        logging.getLogger(__name__).warning(
            "checkpoint %s missing; recovering interrupted-save residue %s", path, best)
        if not path.exists():
            best.rename(path)
    return path


def checkpoint_exists(path: str | Path) -> bool:
    """True if `path` holds a checkpoint to resume from, after rolling the
    residue of a save killed between its two renames into place (the
    group's directory is then missing, and a resume that only looked for
    the directory would restart the group from tick 0)."""
    return _recover_residue(Path(path).absolute()).is_dir()


def load_group(path: str | Path, device=None) -> StreamGroup:
    """Rebuild a StreamGroup from `path` on `device` (``cuda`` unless
    given), its state leaves in their storage dtypes; scoring continues
    bit-identically. As in the JAX package the group is rebuilt with seed
    0: a slot claimed after the resume is initialized from seed 0."""
    path = _recover_residue(Path(path).absolute())
    meta = json.loads((path / "meta.json").read_text())
    if meta.get("backend") != BACKEND:
        raise ValueError(
            f"checkpoint {path} was written by backend {meta.get('backend')!r} "
            "(an orbax tree of the JAX package); rtap_tpu_torch reads its own "
            "numpy-leaf checkpoints only — the importer is not ported yet "
            "(ROADMAP.md, port queue A.7)")
    cfg = ModelConfig.from_dict(meta["config"])
    tree = _read_tree(path / "state")
    grp = StreamGroup(cfg, meta["stream_ids"], device=device, threshold=meta["threshold"],
                      debounce=int(meta.get("debounce", 1)),
                      predict=int(meta.get("predict", 0)))
    model = tree["model"]
    grp.state = state_from_numpy({k: model[k] for k in grp.state}, grp.device)
    grp._tick0 = int(np.asarray(model["tm_iter"]).reshape(-1)[0])
    grp.likelihood.load_state_dict(tree["likelihood"])
    grp._alert_run = np.asarray(tree["alert_run"]).astype(np.int64)
    grp.ticks = int(meta["ticks"])
    grp.resume_alerts_offset = (
        int(meta["alerts_offset"]) if "alerts_offset" in meta else None)
    grp.resume_journal_tick = (
        int(meta["journal_tick"]) if "journal_tick" in meta else None)
    get_registry().counter(
        "rtap_obs_checkpoint_loads_total",
        "group checkpoints restored (service/replay resume)").inc()
    return grp


def peek_resume_ticks(checkpoint_dir: str | Path) -> int:
    """Max recorded tick cursor across a dir's group checkpoints, read
    from meta.json alone — the serve CLI's resume-base probe when a
    journal makes ``--ticks`` a total budget across restarts. 0 for a
    missing, empty or unreadable dir."""
    best = 0
    root = Path(checkpoint_dir)
    if not root.is_dir():
        return 0
    for d in sorted(root.iterdir()):
        if not d.name.startswith("group") or not d.is_dir():
            continue
        try:
            best = max(best, int(json.loads((d / "meta.json").read_text())["ticks"]))
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return best


def validate_resume(resumed: StreamGroup, ck_path, grp: StreamGroup,
                    allow_claimed_extras: bool = False) -> None:
    """The resume-safety gate shared by replay_streams and live_loop: the
    checkpoint must match what this run would have built (slots, stream
    ids, config, threshold, debounce, predict horizon); mismatches are
    errors.

    `allow_claimed_extras` (serve --auto-register or --freeze): slots this
    run built as pads may hold real streams in the checkpoint — they were
    claimed in the prior run and resume live. Every requested stream must
    still match its slot exactly."""
    if len(resumed.stream_ids) != len(grp.stream_ids):
        raise ValueError(
            f"checkpoint {ck_path} has {len(resumed.stream_ids)} slots but "
            f"this group was built with {len(grp.stream_ids)}; refusing to "
            "resume")
    for slot, (ck_id, want_id) in enumerate(zip(resumed.stream_ids, grp.stream_ids)):
        if ck_id == want_id:
            continue
        ck_pad = ck_id.startswith(PAD_PREFIX)
        want_pad = want_id.startswith(PAD_PREFIX)
        if ck_pad and want_pad:
            continue  # pad naming is not load-bearing (released slots)
        if allow_claimed_extras and want_pad and not ck_pad:
            continue  # a previously auto-registered stream resumes live
        raise ValueError(
            f"checkpoint {ck_path} holds {ck_id!r} at slot {slot} but this "
            f"group expects {want_id!r}; refusing to resume"
            + ("" if allow_claimed_extras else
               " (lazily claimed extras resume under serve"
               " --auto-register, or frozen via serve --freeze)"))
    mismatches = [
        f"{name}: checkpoint={a!r} vs requested={b!r}"
        for name, a, b in (
            ("config", resumed.cfg, grp.cfg),
            ("threshold", resumed.threshold, grp.threshold),
            ("debounce", resumed.debounce, grp.debounce),
            # the predictor leaves live inside the state tree: resuming
            # across a horizon change would need a migration, not a blend
            ("predict", resumed.predict, grp.predict),
        )
        if a != b
    ]
    if mismatches:
        raise ValueError(
            f"checkpoint {ck_path} disagrees with this run's parameters "
            f"({'; '.join(mismatches)}); rerun with the checkpointed "
            "settings or use a fresh checkpoint dir")
