"""Model state: initialization and the numpy <-> torch bridge.

:func:`init_state` and :func:`state_nbytes` are copies of the JAX package's
``models/state.py`` (same ``np.random.Philox`` draws, so the same seed gives
the same bits), minus the forward-index leaves (the port has no forward
index) and the predictive-horizon leaves (no predict reducer yet).

Layout (single stream; stream groups add a leading G axis) — the public
layout both packages share:

SP:  sparse ``members`` i16/i32 [C, P] (-1 = empty) + ``perm`` [C, P], or
     dense ``potential`` bool [C, n_in] + ``perm`` [C, n_in]; ``boost``,
     ``overlap_duty``, ``active_duty`` f32 [C]; ``sp_iter`` i32 [].
TM:  ``presyn`` i16/i32 [C, K, S, M] (-1 = empty), ``syn_perm`` [C, K, S, M],
     ``seg_last`` i32 [C, K, S] (-1 = free), ``active_seg``/``matching_seg``
     bool [C, K, S], ``seg_pot`` i16 [C, K, S], ``prev_active``/
     ``prev_winner`` bool [C, K], ``tm_iter`` i32 [], ``tm_overflow`` i32 [].
Encoder: ``enc_offset`` f32 [F], ``enc_bound`` bool [F], ``enc_resolution``
     f32 [F] (+ ``enc_prev`` for composite delta fields).

Permanences are stored in their domain's dtype (models/perm.py): f32, or
uint16/uint8 quanta. The port keeps those storage dtypes on the device, so
its bytes per stream equal :func:`state_nbytes`.
"""

from __future__ import annotations

import numpy as np
import torch

from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.perm import sp_domain, tm_domain


def presyn_dtype(cfg: ModelConfig):
    """int16 whenever every cell id (< num_cells) fits, else int32. The -1
    empty-slot sentinel needs a signed type either way."""
    return np.int16 if cfg.num_cells <= (1 << 15) - 1 else np.int32


def members_dtype(cfg: ModelConfig):
    """Sparse SP member-index dtype: int16 whenever every input index
    (< input_size) fits, else int32."""
    return np.int16 if cfg.input_size <= (1 << 15) - 1 else np.int32


def init_state(cfg: ModelConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Build the full per-stream state dict (numpy, host side). Bit-identical
    to the JAX package's ``init_state(cfg, seed, include_fwd=False)``."""
    rng = np.random.Generator(np.random.Philox(key=(seed, 0xC0FFEE)))
    C, n_in = cfg.sp.columns, cfg.input_size
    K, S, M = cfg.tm.cells_per_column, cfg.tm.max_segments_per_cell, cfg.tm.max_synapses_per_segment

    if cfg.sp.sparse_pool:
        # exactly P distinct input indices per column (a uniform P-subset via
        # argsort of iid uniforms), stored ascending
        P = cfg.sp_members
        sel = np.argsort(rng.random((C, n_in)), axis=1, kind="stable")[:, :P]
        # permanences seeded around the connected threshold so ~half the
        # pool starts connected (NuPIC's init strategy)
        perm = np.clip(
            cfg.sp.syn_perm_connected + (rng.random((C, P)) - 0.5) * 0.1, 0.0, 1.0
        ).astype(np.float32)
        sp_pool = {
            "members": np.sort(sel, axis=1).astype(members_dtype(cfg)),
            "perm": sp_domain(cfg.sp).quantize_init(perm),
        }
    else:
        potential = rng.random((C, n_in)) < cfg.sp.potential_pct
        perm = np.where(
            potential,
            np.clip(cfg.sp.syn_perm_connected + (rng.random((C, n_in)) - 0.5) * 0.1, 0.0, 1.0),
            0.0,
        ).astype(np.float32)
        sp_pool = {
            "potential": np.asarray(potential),
            "perm": sp_domain(cfg.sp).quantize_init(perm),
        }

    return {
        **sp_pool,
        "boost": np.ones(C, np.float32),
        "overlap_duty": np.zeros(C, np.float32),
        "active_duty": np.zeros(C, np.float32),
        "sp_iter": np.int32(0),
        "presyn": np.full((C, K, S, M), -1, presyn_dtype(cfg)),
        "syn_perm": np.zeros((C, K, S, M), tm_domain(cfg.tm).dtype),
        "seg_last": np.full((C, K, S), -1, np.int32),
        "active_seg": np.zeros((C, K, S), bool),
        "matching_seg": np.zeros((C, K, S), bool),
        "seg_pot": np.zeros((C, K, S), np.int16),
        "prev_active": np.zeros((C, K), bool),
        "prev_winner": np.zeros((C, K), bool),
        "tm_iter": np.int32(0),
        "tm_overflow": np.int32(0),
        "enc_offset": np.zeros(cfg.n_fields, np.float32),
        "enc_bound": np.zeros(cfg.n_fields, bool),
        "enc_resolution": np.asarray(cfg.field_resolutions(), np.float32),
        **({"enc_prev": np.full(cfg.n_fields, np.nan, np.float32)}
           if cfg.composite is not None and cfg.composite.has_delta else {}),
        **(
            {
                "cls_w": np.zeros((C * K, cfg.classifier.buckets), np.float32),
                "cls_val": np.zeros(cfg.classifier.buckets, np.float32),
                "cls_cnt": np.zeros(cfg.classifier.buckets, np.int32),
            }
            if cfg.classifier.enabled
            else {}
        ),
    }


def state_nbytes(cfg: ModelConfig, seed: int = 0) -> dict[str, int]:
    """Per-stream state byte budget: sums the actual arrays of one stream's
    state. Returns {"total": bytes, "<key>": bytes, ...} sorted descending."""
    st = init_state(cfg, seed)
    per = {k: int(np.asarray(v).nbytes) for k, v in st.items()}
    out = {"total": sum(per.values())}
    out.update(sorted(per.items(), key=lambda kv: -kv[1]))
    return out


def state_from_numpy(np_state: dict, device) -> dict[str, torch.Tensor]:
    """The JAX package's state (single-stream or grouped ``[G, ...]``, public
    ``[C, K, S, M]`` layout, storage dtypes) -> the port's state on `device`.

    This is the system's weight transfer: a live or checkpointed JAX group
    state becomes a port state that computes the same thing. Dtypes and
    shapes are kept exactly (int16 presyn, uint16/uint8/f32 perms, int16
    seg_pot, bool masks, 0-d scalars stay 0-d)."""
    dev = torch.device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in np_state.items()}


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """The port's state -> numpy arrays in the shared public layout."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
