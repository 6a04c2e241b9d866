"""The CUDA learning-pass kernel against its plain PyTorch version, on the
card. Needs an NVIDIA GPU with nvcc; skips without one (the check runs in
the test, never at import). On the card: ``python -m pytest --noconftest
tests/test_torch_cuda.py -q`` (``--noconftest``: tests/conftest.py imports
jax, which a card machine need not have); ``python3 chip_smoke.py`` holds
the kernel to the same standard at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from rtap_tpu_torch.ops.tm_learn import LearnConsts, tm_learn_kernel, tm_learn_plain

pytestmark = pytest.mark.cuda

# (p_inc, p_dec, p_init, p_one, p_zero, p_thr, pdec) per permanence domain
DOMAIN_CONSTS = {
    torch.float32: (0.1, 0.05, 0.21, 1.0, 0.0, 0.5, 0.025),
    torch.uint16: (6554.0, 3277.0, 13763.0, 65535.0, 0.0, 32768.0, 1638.0),
    torch.uint8: (26.0, 13.0, 54.0, 255.0, 0.0, 128.0, 6.0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _random_pass_inputs(rng, G, R, M, K, C, Ac, W, perm_dtype, col0):
    N = C * K
    presyn = rng.integers(0, N, (G, R, M))
    presyn[rng.random((G, R, M)) < 0.35] = -1
    if col0:
        presyn[:, ::3, : M // 2] = -1
    one = {torch.float32: 1.0, torch.uint16: 65535, torch.uint8: 255}[perm_dtype]
    if perm_dtype == torch.float32:
        perm = rng.choice(np.linspace(0, 1, 41, dtype=np.float32), (G, R, M))
    else:
        perm = rng.integers(0, one + 1, (G, R, M))
        perm[rng.random(perm.shape) < 0.2] = one // 2
    perm = np.where(presyn >= 0, perm, 0)
    flags = rng.random((G, R, 4)) < np.array([0.2, 0.05, 0.15, 0.1])
    n_grow = rng.integers(-2, M + 3, (G, R)).clip(min=0)
    meta = (flags * np.array([1, 2, 4, 8])).sum(-1) | (n_grow << 4)

    def packed():
        ids = np.full((G, Ac), C)
        masks = np.zeros((G, Ac), np.int64)
        for g in range(G):
            n = rng.integers(1, Ac + 1)
            cols = np.sort(rng.choice(C, n, replace=False))
            if col0:
                cols[0] = 0
            ids[g, :n] = cols
            masks[g, :n] = rng.integers(1, 1 << K, n)
            if K == 32:
                masks[g, 0] |= 1 << 31
        masks = np.where(masks >= 1 << 31, masks - (1 << 32), masks)
        return ids, masks

    pids, pmasks = packed()
    aids, amasks = packed()
    wids = np.full((G, W), N)
    for g in range(G):
        w = np.sort(rng.choice(N, rng.integers(0, W + 1), replace=False))
        wids[g, : len(w)] = w
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(torch.int32)
    return [torch.from_numpy(presyn).to(torch.int16),
            torch.from_numpy(np.asarray(perm)).to(perm_dtype),
            i32(meta), i32(pids), i32(pmasks), i32(wids), i32(aids), i32(amasks)], N


@pytest.mark.parametrize("perm_dtype", [torch.float32, torch.uint16, torch.uint8])
@pytest.mark.parametrize("K,M,Ac,col0", [(8, 12, 10, True), (32, 32, 4, True), (4, 6, 5, False)])
def test_kernel_matches_plain(cuda, perm_dtype, K, M, Ac, col0):
    import rtap_tpu_torch.ops.tm_learn as tl

    rng = np.random.default_rng(K * M + Ac)
    C, G, R = 64, 5, 300
    args, N = _random_pass_inputs(rng, G, R, M, K, C, Ac, Ac * K, perm_dtype, col0)
    cs = LearnConsts(*DOMAIN_CONSTS[perm_dtype])
    dev_args = [a.to(cuda) for a in args]
    tl.reset_launches()
    got = tm_learn_kernel(*dev_args, cs, K, N)
    torch.cuda.synchronize()
    assert tl.launches == 1
    ref = [a.clone() for a in args]
    want = tm_learn_plain(*ref, cs, K, N)
    for name, a, b in zip(("nsyn", "conn", "pot"), got, want):
        assert torch.equal(a.cpu(), b), name
    assert torch.equal(dev_args[0].cpu(), ref[0]), "presyn"
    assert torch.equal(dev_args[1].cpu(), ref[1]), "perm"
