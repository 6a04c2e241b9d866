"""Shard-qualified resource paths — the one place that spells them.

The port's copy of the JAX package's ``service/shardpath.py`` (the names
both packages agree on). Shard 0 is byte-identical to the unsharded paths;
nonzero shards qualify the base name itself (``journal.shard001/``). The
port serves shard 0 only (multi-device sharding is not ported).
"""

from __future__ import annotations

import os

__all__ = ["SIDECAR_KINDS", "alert_sidecar_path", "group_checkpoint_path",
           "shard_scoped_path"]

#: the sidecar files that live beside an alert sink (alert_sidecar_path)
SIDECAR_KINDS = ("corr", "epoch")


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


def alert_sidecar_path(alert_path: str, kind: str) -> str:
    """A sidecar beside an alert sink: ``<alerts>.corr`` (the incident
    correlator's resume floor) or ``<alerts>.epoch`` (the run epoch)."""
    if kind not in SIDECAR_KINDS:
        raise ValueError(f"unknown sidecar kind {kind!r}; valid: {SIDECAR_KINDS}")
    return f"{alert_path}.{kind}"
