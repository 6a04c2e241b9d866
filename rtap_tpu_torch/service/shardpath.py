"""Shard-qualified resource paths — the one place that spells them.

The port's copy of the JAX package's ``service/shardpath.py`` (the names
both packages agree on). Shard 0 is byte-identical to the unsharded paths;
nonzero shards qualify the base name itself (``journal.shard001/``). The
port serves shard 0 only (multi-device sharding is not ported).
"""

from __future__ import annotations

import os

__all__ = ["shard_scoped_path", "group_checkpoint_path"]


def shard_scoped_path(base: str, shard: int) -> str:
    """Qualify an operator-provided resource path with the mesh shard:
    shard 0 returns `base` unchanged, nonzero shards suffix the base
    (``<base>.shard<NNN>``, a trailing separator stripped first)."""
    if not 0 <= int(shard) <= 999:
        raise ValueError(f"shard must be in [0, 999]; got {shard!r}")
    if shard == 0:
        return base
    return f"{base.rstrip('/' + os.sep)}.shard{int(shard):03d}"


def group_checkpoint_path(checkpoint_dir: str, gi: int) -> str:
    """The per-group checkpoint directory inside a checkpoint dir —
    ``<dir>/group<NNNN>``, the name save_group/load_group and every resume
    scan agree on."""
    return os.path.join(checkpoint_dir, f"group{int(gi):04d}")
