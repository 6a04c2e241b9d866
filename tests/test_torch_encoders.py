"""PyTorch port vs the JAX package: hashing and the record encoder.

The port computes fmix32 in int64 masked to 32 bits; these tests hold it to
the JAX uint32 version on edge keys, and hold the port's batched encoder
(bind_offsets + encode over a G axis) to ``jax.vmap(encode_device)``, bit for
bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtap_tpu.config import DateConfig, ModelConfig, RDSEConfig, cluster_preset
from rtap_tpu.ops.encoders_tpu import bind_offsets as j_bind_offsets
from rtap_tpu.ops.encoders_tpu import encode_device
from rtap_tpu.ops.hashing_tpu import hash_bits as j_hash_bits
from rtap_tpu.ops.hashing_tpu import hash_u32 as j_hash_u32
from rtap_tpu_torch import config as pconfig
from rtap_tpu_torch.ops.encoders import bind_offsets, encode
from rtap_tpu_torch.ops.hashing import hash_bits, hash_u32
from rtap_tpu_torch.utils.hashing import hash_bits_np

# xdist workers share the host's cores with each other and with JAX: one
# intra-op thread per worker keeps torch's OpenMP pool from oversubscribing them
torch.set_num_threads(1)

EDGE_KEYS = np.array(
    [0, 1, -1, 2, -2, 1 << 30, -(1 << 30), (1 << 30) + 20, -(1 << 30) - 20,
     (1 << 31) - 1, -(1 << 31), (1 << 31) - 21, 12345, -98765], np.int64)


@pytest.mark.parametrize("seed", [0, 42, 0x1000 * 3 + 42, 0xDEADBEEF, 0xFFFFFFFF])
def test_hash_u32_matches_jax_on_edge_keys(seed):
    keys = np.concatenate([EDGE_KEYS, np.arange(-300, 300)])
    want = np.asarray(jax.jit(lambda k: j_hash_u32(k, jnp.uint32(seed)))(
        jnp.asarray(keys, jnp.int32))).astype(np.int64)
    got = hash_u32(torch.from_numpy(keys.astype(np.int32)), seed).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [128, 400, 7])
def test_hash_bits_matches_jax_and_numpy(n):
    keys = np.concatenate([EDGE_KEYS, np.arange(-200, 200)])
    want = np.asarray(j_hash_bits(jnp.asarray(keys, jnp.int32), 42, n))
    got = hash_bits(torch.from_numpy(keys), 42, n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hash_bits_np(keys, 42, n))


def _encode_both(jcfg, values, ts, offsets, bound, resolution):
    """values [T, G, F]; runs bind + encode per tick on both sides."""
    cfg = pconfig.ModelConfig.from_dict(jcfg.to_dict())

    def jstep(v, t, o, b, r):
        o, b = j_bind_offsets(v, o, b)
        return encode_device(jcfg, v, t, o, r), o, b

    jenc = jax.jit(jax.vmap(jstep))
    jo, jb = jnp.asarray(offsets), jnp.asarray(bound)
    to, tb = torch.from_numpy(offsets), torch.from_numpy(bound)
    res = torch.from_numpy(resolution)
    for i in range(values.shape[0]):
        want, jo, jb = jenc(jnp.asarray(values[i]), jnp.asarray(ts[i]), jo, jb,
                            jnp.asarray(resolution))
        v = torch.from_numpy(values[i])
        to, tb = bind_offsets(v, to, tb)
        got = encode(cfg, v, torch.from_numpy(ts[i]), to, res)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"tick {i}")
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=f"offset {i}")
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb), err_msg=f"bound {i}")


@pytest.mark.parametrize("n_fields", [1, 3])
def test_encode_matches_vmapped_jax_with_dates_and_gaps(n_fields):
    """Date ring + weekend bits, a leading NaN (offset must not bind to
    it), a NaN gap, and values past the 2^30 bucket clamp."""
    jcfg = ModelConfig(
        rdse=RDSEConfig(size=100, active_bits=7, resolution=0.5),
        date=DateConfig(time_of_day_width=5, time_of_day_size=13, weekend_width=3),
        n_fields=n_fields,
    )
    rng = np.random.default_rng(n_fields)
    T, G = 24, 4
    values = (rng.normal(size=(T, G, n_fields)) * 10).astype(np.float32)
    values[0, 0, :] = np.nan  # leading NaN
    values[5:8, 1, 0] = np.nan  # NaN gap
    values[10, 2, 0] = 3e9
    values[11, 2, 0] = -1e30
    values[12, 3, -1] = 3.4e38
    values[13, 3, 0] = np.inf
    ts = rng.integers(0, 2_000_000_000, (T, G)).astype(np.int32)
    ts[:, 0] = 1_700_000_000 + 3600 * np.arange(T)  # walks the ring and a weekend
    _encode_both(jcfg, values, ts, np.zeros((G, n_fields), np.float32),
                 np.zeros((G, n_fields), bool),
                 np.full((G, n_fields), 0.5, np.float32))


def test_encode_cluster_preset_per_stream_resolution():
    """The cluster preset's encoder (no date bits) with per-stream runtime
    resolutions, as a batched NAB corpus run carries them."""
    jcfg = cluster_preset()
    rng = np.random.default_rng(5)
    T, G = 16, 5
    values = (50 + rng.normal(size=(T, G, 1)) * 20).astype(np.float32)
    values[0, 4, 0] = np.nan
    resolution = rng.uniform(0.1, 3.0, (G, 1)).astype(np.float32)
    _encode_both(jcfg, values, np.full((T, G), 1_700_000_000, np.int32),
                 np.zeros((G, 1), np.float32), np.zeros((G, 1), bool), resolution)


def test_unported_encoders_raise():
    """The composite and classic-scalar families, refused before they were
    ported, now encode those same records as the JAX package does (their
    full parity suite is tests/test_torch_composite.py)."""
    from rtap_tpu.config import ScalarEncoderConfig, composite_preset

    for jcfg, F in ((composite_preset(), 3),
                    (dataclasses.replace(cluster_preset(), scalar=ScalarEncoderConfig()), 1)):
        _encode_both(jcfg, np.zeros((1, 1, F), np.float32), np.zeros((1, 1), np.int32),
                     np.zeros((1, F), np.float32), np.zeros((1, F), bool),
                     np.asarray(jcfg.field_resolutions(), np.float32)[None])
