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

from rtap_tpu_torch.ops.tm_learn import LearnConsts, as_bits, tm_learn_kernel, tm_learn_plain

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


FLAG_P = (0.2, 0.05, 0.15, 0.1)  # learn, alloc, grow, punish


def _random_pass_inputs(rng, G, R, M, K, C, Ac, W, perm_dtype, col0, flag_p=FLAG_P,
                        presyn_dtype=torch.int16, edit=None):
    """Random pass inputs; `edit(rng, presyn, perm, meta)` may rework the
    numpy pools and meta in place before they become tensors."""
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
    flags = rng.random((G, R, 4)) < np.array(flag_p)
    n_grow = rng.integers(-2, M + 3, (G, R)).clip(min=0)
    meta = (flags * np.array([1, 2, 4, 8])).sum(-1) | (n_grow << 4)
    if edit is not None:
        edit(rng, presyn, perm, meta)

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
    return [torch.from_numpy(presyn).to(presyn_dtype),
            torch.from_numpy(np.asarray(perm)).to(perm_dtype),
            i32(meta), i32(pids), i32(pmasks), i32(wids), i32(aids), i32(amasks)], N


def _dead_flagless(rng, presyn, perm, meta):
    """Half the rows carry no flag, and a third of all live synapses sit
    at permanence 0: death must rewrite those rows though meta says nothing."""
    meta[rng.random(meta.shape) < 0.5] = 0
    perm[(presyn >= 0) & (rng.random(perm.shape) < 0.33)] = 0


def _f32_clip(rng, presyn, perm, meta):
    """Learning rows whose empty slots hold permanences outside [0, 1] or
    -0.0: the clip must rewrite them, and reinforce turns -0.0 into +0.0.
    Some live synapses sit at +inf: the clip brings them to one on learning
    rows; elsewhere eviction ranks them level with the free slots."""
    meta[rng.random(meta.shape) < 0.5] |= 1
    odd = np.float32([-0.0, -0.5, 1.5, 3.0, np.inf, -np.inf])
    perm[...] = np.where(presyn < 0, rng.choice(odd, perm.shape), perm)
    perm[(presyn >= 0) & (rng.random(perm.shape) < 0.05)] = np.inf


# (perm dtype, K, M, Ac, col0) with G = 5 streams of R = 300 rows, C = 64,
# W = Ac * K; then the shapes the kernel's separate paths need
CASES = [pytest.param(dict(perm_dtype=p, K=K, M=M, Ac=Ac, col0=col0),
                      id=f"{str(p)[6:]}-K{K}-M{M}-Ac{Ac}-col0{int(col0)}")
         for p in (torch.float32, torch.uint16, torch.uint8)
         for K, M, Ac, col0 in ((8, 12, 10, True), (32, 32, 4, True), (4, 6, 5, False))] + [
    # a NAB-like winner list (W = 1280) with many growing rows, int32 presyn
    pytest.param(dict(perm_dtype=torch.float32, K=32, M=32, Ac=40, col0=False, G=2, R=512,
                      presyn_dtype=torch.int32, flag_p=(0.6, 0.05, 0.6, 0.1)), id="nab-like-W1280"),
    # 10-byte rows and a ragged last tile: the tiles the block copies itself
    pytest.param(dict(perm_dtype=torch.uint16, K=8, M=5, Ac=10, col0=True, R=301), id="rows10B-R301"),
    # more streams than a grid's y extent holds, walked by persistent blocks
    pytest.param(dict(perm_dtype=torch.uint8, K=4, M=4, Ac=3, col0=False, G=65543, R=8, C=8),
                 id="G65543"),
    pytest.param(dict(perm_dtype=torch.uint16, K=8, M=12, Ac=10, col0=False, edit=_dead_flagless),
                 id="flagless-death"),
    pytest.param(dict(perm_dtype=torch.float32, K=8, M=12, Ac=10, col0=False, edit=_f32_clip),
                 id="f32-clip-empty"),
    # winner lists in no order, fills (ids >= N) between valid ids
    pytest.param(dict(perm_dtype=torch.uint16, K=8, M=12, Ac=10, col0=True, shuffle_wids=True,
                      flag_p=(0.5, 0.05, 0.5, 0.1)), id="winners-unordered"),
]


def _case_inputs(case):
    c = {"G": 5, "R": 300, "C": 64, **case}
    rng = np.random.default_rng(c["K"] * c["M"] + c["Ac"])
    extra = {k: c[k] for k in ("flag_p", "presyn_dtype", "edit") if k in c}
    args, N = _random_pass_inputs(rng, c["G"], c["R"], c["M"], c["K"], c["C"], c["Ac"],
                                  c["Ac"] * c["K"], c["perm_dtype"], c["col0"], **extra)
    if c.get("shuffle_wids"):
        args[5] = torch.from_numpy(rng.permuted(args[5].numpy(), axis=1))
    return args, LearnConsts(*DOMAIN_CONSTS[c["perm_dtype"]]), c["K"], N


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda, case):
    import rtap_tpu_torch.ops.tm_learn as tl

    args, cs, K, N = _case_inputs(case)
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
    # perm bit for bit: torch.equal holds -0.0 equal to +0.0
    assert torch.equal(as_bits(dev_args[1].cpu()), as_bits(ref[1])), "perm"
