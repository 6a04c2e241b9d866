"""PyTorch port vs the JAX package: config, state init and the state bridge.

The port keeps its own copies of config.py, models/perm.py and init_state;
these tests hold each copy to the JAX package's, leaf for leaf (dtype and
value), and round-trip a grouped state through state_from_numpy /
state_to_numpy.
"""

import numpy as np
import pytest

from rtap_tpu import config as jconfig
from rtap_tpu.models.state import init_state as j_init_state
from rtap_tpu.models.state import state_nbytes as j_state_nbytes
from rtap_tpu.ops.step import replicate_state as j_replicate_state
from rtap_tpu_torch import config as pconfig
from rtap_tpu_torch.models.state import (
    init_state,
    state_from_numpy,
    state_nbytes,
    state_to_numpy,
)

PRESETS = {
    "cluster": lambda m: m.cluster_preset(),
    "cluster_q8": lambda m: m.cluster_preset(perm_bits=8),
    "dense_cluster": lambda m: m.dense_cluster_preset(),
    "nab256": lambda m: m.scaled_nab_preset(256),
}


def _pair(name):
    jcfg = PRESETS[name](jconfig)
    cfg = pconfig.ModelConfig.from_dict(jcfg.to_dict())
    return jcfg, cfg


@pytest.mark.parametrize("name", list(PRESETS))
def test_config_round_trips_and_presets_agree(name):
    jcfg, cfg = _pair(name)
    assert cfg.to_json() == jcfg.to_json()
    assert PRESETS[name](pconfig).to_json() == jcfg.to_json()


@pytest.mark.parametrize("name", list(PRESETS))
def test_init_state_matches_jax(name):
    jcfg, cfg = _pair(name)
    want = j_init_state(jcfg, seed=3, include_fwd=False)
    got = init_state(cfg, seed=3)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", list(PRESETS))
def test_state_nbytes_matches_jax(name):
    jcfg, cfg = _pair(name)
    assert state_nbytes(cfg) == j_state_nbytes(jcfg)


def test_cluster_preset_bytes_per_stream():
    _, cfg = _pair("cluster")
    assert state_nbytes(cfg)["total"] == 302_101


@pytest.mark.parametrize("grouped", [False, True])
def test_state_bridge_round_trip(grouped):
    jcfg, _ = _pair("cluster")
    st = j_init_state(jcfg, seed=1, include_fwd=False)
    if grouped:
        st = j_replicate_state(st, 3)
        st["presyn"][1, 0, 0, 0, 0] = 17  # rows differ
        st["syn_perm"][2, 5, 1, 1, 3] = 65535
    dev = state_from_numpy(st, "cpu")
    back = state_to_numpy(dev)
    for k, v in st.items():
        v = np.asarray(v)
        assert dev[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # device state holds the storage dtypes: bytes per stream = state_nbytes
    nbytes = sum(t.numel() * t.element_size() for t in dev.values())
    assert nbytes == (3 if grouped else 1) * j_state_nbytes(jcfg)["total"]
