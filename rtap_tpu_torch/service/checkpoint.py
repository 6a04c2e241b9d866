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
uninterrupted run. ``load_group`` also imports the JAX package's orbax
checkpoints (``"backend": "tpu"``) through ``ckpt_import``, so every resume
path (serve, replay, the quarantine restore, the standby's adoption) takes
a JAX deployment's checkpoint directory as it stands.
"""

from __future__ import annotations

import json
import logging
import shutil
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from rtap_tpu_torch.ckpt_import.orbax_tree import ImportStats, read_tree
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.migrate import sparse_pool_width, sparsify_config, sparsify_sp_state
from rtap_tpu_torch.models.state import state_from_numpy, state_to_numpy
from rtap_tpu_torch.obs import get_registry
from rtap_tpu_torch.service.ckpt_tree import read_npy_tree
from rtap_tpu_torch.service.registry import PAD_PREFIX, StreamGroup

BACKEND = "torch"


def _write_tree(root: Path, tree: dict) -> None:
    root.mkdir(parents=True, exist_ok=True)
    for k, v in tree.items():
        if isinstance(v, dict):
            _write_tree(root / k, v)
        else:
            np.save(root / f"{k}.npy", np.asarray(v), allow_pickle=False)


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
        "alert_epoch": int(grp.alert_epoch),
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


def _read_jax_tree(path: Path, meta: dict, stats: ImportStats) -> dict:
    """The JAX package's batched orbax tree (``"backend": "tpu"``), read
    without orbax, as the JAX ``load_group`` holds it: the forward-index
    leaves dropped (derived state; the port has no forward index), and a
    checkpoint saved sharded over a mesh restored on one device."""
    if meta.get("sharded"):
        logging.getLogger(__name__).warning(
            "checkpoint %s was saved sharded over a mesh; resuming on one device "
            "(its state is topology-independent)", path)
    tree = read_tree(path / "state", stats)
    tree["model"] = {k: v for k, v in tree["model"].items() if not k.startswith("fwd_")}
    return tree


class CheckpointReplaced(OSError):
    """A concurrent save swapped the checkpoint directory during a read; a
    re-read gets one save's meta and leaves together."""


def load_group(path: str | Path, device=None, sparsify: bool = False) -> StreamGroup:
    """Rebuild a StreamGroup from `path` on `device` (``cuda`` unless
    given), its state leaves in their stored dtypes; scoring continues
    bit-identically. As in the JAX package the group is rebuilt with seed
    0: a slot claimed after the resume is initialized from seed 0.

    It reads the port's own checkpoints (``"backend": "torch"``) and
    imports the JAX package's batched orbax checkpoints (``"tpu"``) one way,
    through ``ckpt_import`` (no orbax, tensorstore or zstd library); the
    import's seconds and bytes land in the group's ``import_stats``. The
    JAX CPU oracle's per-stream checkpoints (``"cpu"``) are refused: that
    backend is not ported, by choice.

    `sparsify` migrates a dense-layout SP pool into the sparse member-index
    layout on the way in (models/migrate.py): the config gains
    ``sparse_pool=True`` with the migration's exact pool width pinned as
    ``pool_members``, and scoring continues bit-identically to the dense
    run. Sparse checkpoints are untouched."""
    path = _recover_residue(Path(path).absolute())
    # a standby adopts checkpoints while its leader saves into the same dir:
    # a save that swaps the directory between the meta and the state reads
    # would pair one save's meta with another's leaves, so the read must
    # end in the directory it started in
    dir_ino = path.stat().st_ino
    meta = json.loads((path / "meta.json").read_text())
    backend = meta.get("backend")
    stats = None
    if backend == BACKEND:
        tree = read_npy_tree(path / "state")
    elif backend == "tpu":
        stats = ImportStats()
        tree = _read_jax_tree(path, meta, stats)
    elif backend == "cpu":
        raise ValueError(
            f"checkpoint {path} was written by the JAX package's CPU oracle backend "
            "(per-stream state dicts); that backend is not ported, by choice "
            "(ROADMAP.md, not ported on purpose), so its checkpoints cannot be "
            "imported — resave the group from the JAX batched backend")
    else:
        raise ValueError(f"checkpoint {path} names an unknown backend {backend!r}")
    if path.stat().st_ino != dir_ino:
        raise CheckpointReplaced(f"checkpoint {path} was replaced by a save while it was read")
    cfg = ModelConfig.from_dict(meta["config"])
    if sparsify and not cfg.sp.sparse_pool:
        model = {k: np.asarray(v) for k, v in tree["model"].items()}
        P = sparse_pool_width(model["potential"])
        tree["model"] = sparsify_sp_state(model, P)
        cfg = sparsify_config(cfg, P)
    grp = StreamGroup(cfg, meta["stream_ids"], device=device, threshold=meta["threshold"],
                      debounce=int(meta.get("debounce", 1)),
                      predict=int(meta.get("predict", 0)))
    model = tree["model"]
    if backend != BACKEND:
        _check_leaves(path, model, grp.state)
    t0 = time.perf_counter()
    grp.state = state_from_numpy({k: model[k] for k in grp.state}, grp.device)
    if stats is not None:
        if grp.device.type == "cuda":
            torch.cuda.synchronize(grp.device)
        stats.device_s = time.perf_counter() - t0
    grp.import_stats = stats.as_dict() if stats is not None else None
    grp._tick0 = int(np.asarray(model["tm_iter"]).reshape(-1)[0])
    grp.likelihood.load_state_dict(tree["likelihood"])
    grp._alert_run = np.asarray(tree["alert_run"]).astype(np.int64)
    grp.ticks = int(meta["ticks"])
    grp.resume_alerts_offset = (
        int(meta["alerts_offset"]) if "alerts_offset" in meta else None)
    grp.resume_journal_tick = (
        int(meta["journal_tick"]) if "journal_tick" in meta else None)
    # the alert-id epoch a quarantine restore bumped (a rewound tick counter)
    grp.alert_epoch = int(meta.get("alert_epoch", 0))
    get_registry().counter(
        "rtap_obs_checkpoint_loads_total",
        "group checkpoints restored (service/replay resume)").inc()
    return grp


def _check_leaves(path: Path, model: dict, fresh: dict) -> None:
    """An imported tree must hold exactly the leaves this build's group
    holds, in the same shapes and dtypes: nothing is dropped or cast
    silently."""
    if set(model) != set(fresh):
        raise ValueError(
            f"checkpoint {path} model leaves differ from this build's: missing "
            f"{sorted(set(fresh) - set(model))}, extra {sorted(set(model) - set(fresh))}")
    for k, t in fresh.items():
        v = np.asarray(model[k])
        want = torch.empty(0, dtype=t.dtype).numpy().dtype
        if tuple(v.shape) != tuple(t.shape) or v.dtype != want:
            raise ValueError(
                f"checkpoint {path} leaf {k} is {v.dtype}{list(v.shape)}; this build "
                f"holds {want}{list(t.shape)}")


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
