"""A checkpoint's state tree on disk (``state/<tree>/<leaf>.npy``), read back
with numpy alone: no torch import, so a verdict that compares checkpoints
(the soaks' orchestrators) starts without one."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_npy_tree(root: str | Path) -> dict:
    """Every ``.npy`` under `root` as nested dicts keyed by directory and
    file stem."""
    out = {}
    for p in sorted(Path(root).iterdir()):
        if p.is_dir():
            out[p.name] = read_npy_tree(p)
        elif p.suffix == ".npy":
            out[p.stem] = np.load(p, allow_pickle=False)
    return out
