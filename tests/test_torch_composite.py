"""PyTorch port vs the JAX package: the scalar encoder and the composite
encoder family (rdse / delta / categorical fields).

The port's batched encoder against ``jax.vmap(encode_device)`` for the
composite, categorical and node presets and a classic-scalar config, with
NaN, +-inf and values at the bucket and category clamps, bit for bit (the
delta predecessor advanced as the step advances it); ``init_state`` leaf
for leaf, ``enc_prev`` included; and the composite and categorical chunk
steps over 64 learning ticks at G = 4: raw and every state leaf equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtap_tpu import config as jconfig
from rtap_tpu.models.state import init_state as j_init_state
from rtap_tpu.ops.encoders_tpu import bind_offsets as j_bind_offsets
from rtap_tpu.ops.encoders_tpu import encode_device
from rtap_tpu.ops.step import chunk_step as j_chunk_step
from rtap_tpu.ops.step import replicate_state
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.models.state import init_state, state_from_numpy, state_to_numpy
from rtap_tpu_torch.ops.encoders import bind_offsets, encode
from rtap_tpu_torch.ops.step import chunk_step

# xdist workers share the host's cores with each other and with JAX: one
# intra-op thread per worker keeps torch's OpenMP pool from oversubscribing them
torch.set_num_threads(1)

CLAMP = 1 << 30


def _scalar_config():
    return dataclasses.replace(
        jconfig.cluster_preset(), n_fields=2,
        scalar=jconfig.ScalarEncoderConfig(size=128, width=11, min_val=-5.0, max_val=95.5))


CONFIGS = {
    "composite": jconfig.composite_preset,
    "categorical": jconfig.categorical_preset,
    "node": jconfig.node_preset,
    "scalar": _scalar_config,
}


def _values(jcfg, T, G, seed, fields=None):
    """[T, G, F] f32 with gaps, infinities and clamp-edge values."""
    F = jcfg.n_fields if fields is None else fields
    rng = np.random.default_rng(seed)
    v = (40 + 10 * rng.normal(size=(T, G, F))).astype(np.float32)
    if jcfg.composite is not None:
        for f, spec in enumerate(jcfg.composite.fields[:F]):
            if spec.kind == "categorical":  # small ids, rounded from floats
                v[:, :, f] = rng.integers(-3, 12, (T, G)) + rng.uniform(-0.49, 0.49, (T, G))
    v[0, 0, :] = np.nan  # leading NaN: no offset, no predecessor
    v[3:6, 1, 0] = np.nan  # a gap: the delta baseline must hold across it
    v[7, 2, :] = np.inf
    v[8, 2, :] = -np.inf
    v[9, 3, 0] = 3.4e38
    v[10, 3, :] = -3e9
    v[11, 0, :] = np.float32(CLAMP) * 0.5  # category id past the 2^30 / w clamp
    v[12, 0, :] = -np.float32(CLAMP) * 4  # past the bucket clamp
    v[13, 1, :] = 0.5  # round-half-even ties
    v[14, 1, :] = 1.5
    v[15, 1, :] = -2.5
    return v


def _ts(T, G):
    return (1_700_000_000 + 3000 * np.arange(T)[:, None] + 7 * np.arange(G)[None]).astype(np.int32)


def _encode_both(jcfg, values, ts):
    """Bind + encode (+ the predecessor's advance) per tick on both sides."""
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    G = values.shape[1]
    F = jcfg.n_fields
    delta = jcfg.composite is not None and jcfg.composite.has_delta
    res = np.asarray(jcfg.field_resolutions(), np.float32)[None].repeat(G, 0)

    def jstep(v, t, o, b, p, r):
        o, b = j_bind_offsets(v, o, b)
        sdr = encode_device(jcfg, v, t, o, r, p if delta else None)
        return sdr, o, b, jnp.where(jnp.isfinite(v), v, p)

    jenc = jax.jit(jax.vmap(jstep))
    jo, jb = jnp.zeros((G, F), jnp.float32), jnp.zeros((G, F), bool)
    jp = jnp.full((G, F), jnp.nan, jnp.float32)
    to, tb = torch.zeros((G, F)), torch.zeros((G, F), dtype=torch.bool)
    tp = torch.full((G, F), float("nan"))
    for i in range(values.shape[0]):
        want, jo, jb, jp = jenc(jnp.asarray(values[i]), jnp.asarray(ts[i]), jo, jb, jp,
                                jnp.asarray(res))
        v = torch.from_numpy(values[i])
        to, tb = bind_offsets(v, to, tb)
        got = encode(cfg, v, torch.from_numpy(ts[i]), to, torch.from_numpy(res),
                     tp if delta else None)
        tp = torch.where(torch.isfinite(v), v, tp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"tick {i}")
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=f"offset {i}")
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=f"prev {i}")
        # a stream with a finite field sets that field's bits
        assert got[np.isfinite(values[i]).any(1)].any(1).all(), f"empty SDR at tick {i}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_matches_vmapped_jax(name):
    jcfg = CONFIGS[name]()
    T, G = 20, 4
    _encode_both(jcfg, _values(jcfg, T, G, seed=len(name)), _ts(T, G))


@pytest.mark.parametrize("name", ["composite", "node"])
def test_encode_one_value_column_reads_it_for_every_field(name):
    """A serve source delivers one value per stream: the reference's
    clamped gather reads that column for every field of the config."""
    jcfg = CONFIGS[name]()
    T, G = 16, 4
    _encode_both(jcfg, _values(jcfg, T, G, seed=3, fields=1), _ts(T, G))


def test_categorical_ids_clamp_per_field():
    """Ids past a field's categorical bound share the bound's code, on both
    sides; ids inside it keep disjoint key ranges."""
    jcfg = jconfig.categorical_preset()
    bound = jcfg.composite.fields[0].categorical_clamp()
    vals = np.array([[bound], [bound + 64], [-bound - 64], [-bound], [bound - 1]],
                    np.float32)[None]
    _encode_both(jcfg, vals, _ts(1, 5))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    sdr = encode(cfg, torch.from_numpy(vals[0]), torch.from_numpy(_ts(1, 5)[0]),
                 torch.zeros((5, 1)), torch.ones((5, 1)))
    assert torch.equal(sdr[0], sdr[1]) and torch.equal(sdr[2], sdr[3])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_state_matches_jax(name):
    jcfg = CONFIGS[name]()
    want = j_init_state(jcfg, seed=5, include_fwd=False)
    got = init_state(ModelConfig.from_dict(jcfg.to_dict()), seed=5)
    assert sorted(got) == sorted(want)
    assert ("enc_prev" in got) == (name == "composite")
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["composite", "categorical"])
def test_chunk_step_matches_jax(name):
    """64 learning ticks at G = 4 in two chunks: raw and every state leaf
    (the delta predecessor included) bit for bit."""
    jcfg = CONFIGS[name]()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    T, G = 64, 4
    vals = _values(jcfg, T, G, seed=11)
    vals[16:, :, :] = np.nan_to_num(vals[16:], nan=20.0, posinf=60.0, neginf=-10.0)
    vals[40:43, 2, :] = np.nan  # a gap after the model has learned
    ts = _ts(T, G)
    st_np = replicate_state(j_init_state(jcfg, seed=2, include_fwd=False), G)
    js = {k: jnp.asarray(v) for k, v in st_np.items()}
    st = state_from_numpy(st_np, "cpu")
    for sl in (slice(0, 32), slice(32, 64)):
        js, jraw = j_chunk_step(js, jnp.asarray(vals[sl]), jnp.asarray(ts[sl]), jcfg)
        st, raw = chunk_step(st, torch.from_numpy(vals[sl]), torch.from_numpy(ts[sl]), cfg)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw), err_msg=f"raw {sl}")
    got = state_to_numpy(st)
    assert sorted(got) == sorted(js)
    for k, v in js.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not got["tm_overflow"].any()
