"""PyTorch port vs the JAX package's TM megakernel mode.

The branch-coverage sequences of tests/parity/test_pallas_tm.py, with JAX
under ``set_scatter_mode("pallas")`` (a runtime override; its learning pass
is then the Pallas megakernel in interpret mode) and the port's tm_step,
whose learning pass is the counterpart of that kernel. Every TM leaf is
compared every step, bit for bit.
"""

import pytest

import rtap_tpu.ops.tm_tpu as jtm
from tests.test_torch_tm import SEQS, run_tm_steps


@pytest.fixture
def pallas_scatter():
    jtm.set_scatter_mode("pallas")
    yield
    jtm.set_scatter_mode(None)


@pytest.mark.parametrize("seq", list(SEQS))
def test_tm_step_matches_jax_megakernel_mode(seq, pallas_scatter):
    run_tm_steps(*SEQS[seq]())
