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
    # the plain version on card tensors (chip_smoke times it there): the same
    tl.reset_launches()
    on_card = [a.to(cuda) for a in args]
    for name, a, b in zip(("nsyn", "conn", "pot"), tm_learn_plain(*on_card, cs, K, N), want):
        assert torch.equal(a.cpu(), b), f"plain on the card: {name}"
    assert tl.launches == 0
    assert torch.equal(on_card[0].cpu(), ref[0]), "plain on the card: presyn"
    assert torch.equal(as_bits(on_card[1].cpu()), as_bits(ref[1])), "plain on the card: perm"


def test_live_loop_on_card_matches_cpu(cuda, tmp_path):
    """The serve loop on the card (the learning kernel) and on the CPU
    (its plain version): the same alert bytes and state leaves, and one
    kernel launch per group per learning tick on the card."""
    import dataclasses

    from rtap_tpu_torch.config import scaled_cluster_preset
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    cfg = scaled_cluster_preset(32)
    cfg = dataclasses.replace(cfg, likelihood=dataclasses.replace(
        cfg.likelihood, learning_period=10, estimation_samples=5))
    ids = [f"n{i // 3}.m{i % 3}" for i in range(6)]

    def source(k):
        rng = np.random.Generator(np.random.Philox(key=(5, k)))
        v = (30 + 8 * np.sin(k / 3.0 + np.arange(6)) + rng.normal(0, 0.5, 6)).astype(np.float32)
        return v, 1_700_000_000 + k

    out = {}
    for dev in ("cuda", "cpu"):
        reg = StreamGroupRegistry(cfg, group_size=3, device=dev, threshold=0.007, debounce=2)
        for sid in ids:
            reg.add_stream(sid)
        reg.finalize()
        stats = live_loop(source, reg, n_ticks=40, cadence_s=0.0, pipeline_depth=2,
                          alert_path=str(tmp_path / dev))
        out[dev] = (stats, [state_to_numpy(g.state) for g in reg.groups],
                    [ln for ln in open(tmp_path / dev) if not ln.startswith('{"event"')])
    (cs, cstate, clines), (ps, pstate, plines) = out["cuda"], out["cpu"]
    assert clines == plines and len(clines) > 0
    for a, b in zip(cstate, pstate):
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k
    assert cs["kernel_launches"] == {"tm_learn": 2 * 40} and ps["kernel_launches"] == {"tm_learn": 0}
    assert cs["hbm_peak_bytes_in_use"] > 0 and "hbm_bytes_in_use" not in ps


@pytest.mark.parametrize("bits", [16, 0, 8])
def test_reducer_leaves_on_card_match_cpu(cuda, bits):
    """The model-side reducers on the card and on the CPU, on the same
    group ticked by the same chunks: the predict leaves and the state bit
    for bit; the health leaf's integer fields exact and its f32 fields at
    rtol=1e-5, atol=1e-6 (the sums' order differs)."""
    from rtap_tpu_torch.config import scaled_cluster_preset
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.service.registry import StreamGroup

    cfg = scaled_cluster_preset(32, perm_bits=bits) if bits != 16 else scaled_cluster_preset(32)
    G, T = 8, 48
    rng = np.random.default_rng(bits)
    v = (30 + 8 * np.sin(np.arange(T) / 3.0)[:, None] + rng.normal(0, 2.0, (T, G))).astype(np.float32)
    v[20:30] += 40.0 * (rng.random((10, G)) < 0.3)
    v[:, 6:] = np.nan  # a half-live group
    ts = (1_700_000_000 + np.arange(T))[:, None].repeat(G, 1)
    out = {}
    for dev in ("cuda", "cpu"):
        g = StreamGroup(cfg, [f"s{i}" for i in range(G)], device=dev, health=True, predict=4)
        leaves = []
        for lo in range(0, T, 8):
            g.run_chunk(v[lo:lo + 8], ts[lo:lo + 8])
            leaves.append((g.last_health, g.last_predict))
        out[dev] = (leaves, state_to_numpy(g.state))
    (cl, cs), (pl, ps) = out["cuda"], out["cpu"]
    for (ch, cp), (ph, pp) in zip(cl, pl):
        for k in pp:
            assert cp[k].dtype == pp[k].dtype and np.array_equal(cp[k], pp[k], equal_nan=True), k
        for k in ph:
            if ph[k].dtype.kind == "i":
                assert np.array_equal(ch[k], ph[k]), k
            else:
                np.testing.assert_allclose(ch[k], ph[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ps:
        assert np.array_equal(cs[k], ps[k], equal_nan=True), k
    assert pl[-1][1]["scored"][:, :6].all() and not pl[-1][1]["scored"][:, 6:].any()


def test_kernel_matches_plain_at_nab_corpus_group(cuda):
    """nab_preset at G = 8 (the batched corpus group: W = 1,280 winners, f32
    permanences, int32 presyn) after 40 learning ticks: the next learning
    pass, kernel against plain, bit for bit."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.config import nab_preset
    from rtap_tpu_torch.models.state import init_state
    from rtap_tpu_torch.ops.step import chunk_step, next_learn_pass, replicate_state_device

    cfg = nab_preset()
    G, T = 8, 40
    rng = np.random.default_rng(3)
    v = (50 + 10 * np.sin(np.arange(T + 1) / 5.0)[:, None] + rng.normal(0, 2, (T + 1, G)))
    v = torch.from_numpy(v.astype(np.float32)[:, :, None]).to(cuda)
    ts = torch.from_numpy((1_700_000_000 + 300 * np.arange(T + 1))[:, None].repeat(G, 1)
                          .astype(np.int32)).to(cuda)
    st = replicate_state_device(init_state(cfg, 0), G, cuda)
    st, _ = chunk_step(st, v[:T], ts[:T], cfg)
    lp = next_learn_pass(cfg, st, v[T], ts[T])
    args = lp.args
    assert args[5].shape[1] == 1280 and args[1].dtype == torch.float32
    k_pools = [a.clone() for a in args[:2]]
    p_pools = [a.clone() for a in args[:2]]
    tl.reset_launches()
    got = tl.tm_learn_kernel(*k_pools, *args[2:], lp.consts, lp.K, lp.N)
    want = tl.tm_learn_plain(*p_pools, *args[2:], lp.consts, lp.K, lp.N)
    torch.cuda.synchronize()
    assert tl.launches == 1
    for a, b in zip([*k_pools, *got], [*p_pools, *want]):
        assert torch.equal(as_bits(a), as_bits(b))


@pytest.mark.parametrize("preset", ["composite", "categorical", "classifier"])
def test_presets_on_card_match_cpu(cuda, preset):
    """The composite and categorical presets (the delta predecessor
    included) and cluster_preset with the SDR classifier, 40 learning ticks
    of 16 streams on the card and on the CPU: raw and every model leaf bit
    for bit; the classifier's weights at rtol 1e-5 / atol 1e-6 and its
    predictions and probabilities within 1e-4 (its product and exp are not
    bit-exact across devices)."""
    import dataclasses

    from rtap_tpu_torch import config as C
    from rtap_tpu_torch.models.state import init_state, state_to_numpy
    from rtap_tpu_torch.ops.step import chunk_step, replicate_state_device

    cfg = {"composite": C.composite_preset(), "categorical": C.categorical_preset(),
           "classifier": dataclasses.replace(
               C.cluster_preset(), classifier=C.ClassifierConfig(enabled=True))}[preset]
    G, T = 16, 40
    rng = np.random.default_rng(1)
    v = (30 + 8 * np.sin(np.arange(T) / 3.0)[:, None] + rng.normal(0, 1.0, (T, G)))
    v = v.astype(np.float32)[:, :, None]
    v[10:13, 3] = np.nan
    ts = (1_700_000_000 + 60 * np.arange(T))[:, None].repeat(G, 1).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        st = replicate_state_device(init_state(cfg, 2), G, dev)
        st, o = chunk_step(st, torch.from_numpy(v).to(dev), torch.from_numpy(ts).to(dev), cfg)
        o = o if isinstance(o, tuple) else (o,)
        out[dev] = ([x.cpu().numpy() for x in o], state_to_numpy(st))
    (co, cs), (po, ps) = out["cuda"], out["cpu"]
    assert np.array_equal(co[0], po[0])
    for k in ps:
        if k in ("cls_w", "cls_val"):
            np.testing.assert_allclose(cs[k], ps[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(cs[k], ps[k], equal_nan=True), k
    for a, b in zip(co[1:], po[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert ("enc_prev" in ps) == (preset == "composite")


def test_htm_model_golden_on_card(cuda):
    """HTMModel on the card reproduces tests/golden/golden_config1.npz (raw
    equal, loglik within 1e-12), the golden the JAX package holds itself to."""
    from pathlib import Path

    from rtap_tpu_torch.config import ModelConfig
    from rtap_tpu_torch.data.nab_corpus import load_corpus
    from rtap_tpu_torch.models import AnomalyDetector
    from tests.golden.generate_golden import golden_config  # imports no jax

    root = Path(__file__).resolve().parent.parent
    nf = next(f for f in load_corpus(root / "data" / "nab") if "5f5533" in f.name)
    golden = np.load(root / "tests" / "golden" / "golden_config1.npz")
    det = AnomalyDetector(ModelConfig.from_dict(golden_config().to_dict()), seed=0, device=cuda)
    res = [det.model.run(int(nf.timestamps[i]), float(nf.values[i])) for i in range(400)]
    np.testing.assert_array_equal([r.raw_score for r in res], golden["raw"])
    np.testing.assert_allclose([r.log_likelihood for r in res], golden["loglik"], rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("entry", ["fault_eval", "log_template", "node_eval"])
def test_eval_entry_points_on_card_match_cpu(cuda, entry):
    """The evals on the card and on the CPU at a small shape (the 32-column
    cluster family with a 40-tick probation; node_preset(3) with a 60-tick
    one): the same reports but for wall-clock entries; the node eval's raw
    and loglik equal."""
    import dataclasses

    from rtap_tpu_torch.config import node_preset
    from rtap_tpu_torch.eval import fault_eval, node_eval, workload_eval

    cat, tiny, _ = workload_eval.tiny_eval_configs()
    out = {}
    for dev in ("cuda", "cpu"):
        if entry == "fault_eval":
            out[dev] = dataclasses.asdict(fault_eval.run_fault_eval(
                n_streams=6, length=400, cfg=tiny, device=dev, chunk_ticks=128))
        elif entry == "log_template":
            out[dev] = workload_eval.run_log_template_eval(n_streams=4, length=360, cfg=cat,
                                                           device=dev)
        else:
            cfg = node_preset(3)
            cfg = dataclasses.replace(cfg, likelihood=dataclasses.replace(
                cfg.likelihood, learning_period=60, estimation_samples=40))
            out[dev] = node_eval.run_node_eval(3, 400, device=dev, cfg=cfg)
    a, b = out["cuda"], out["cpu"]
    for k in ("raw", "loglik"):
        if k in a:
            assert np.array_equal(a.pop(k), b.pop(k)), k
    for r in (a, b):
        r.pop("device", None)
        r.pop("wall_s", None)
        for k in ("elapsed_s", "metrics_per_sec"):
            r.get("throughput", {}).pop(k, None)
    assert a == b


def _chaos_registry(dev, cfg, ids, group_size):
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    reg = StreamGroupRegistry(cfg, group_size=group_size, device=dev, threshold=-1e9,
                              debounce=1)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()
    return reg


def test_restore_on_card_frees_the_old_group_and_matches_cpu(cuda, tmp_path):
    """A quarantine restore on the card: the restored group lands on the
    card, the old group's device state is released (allocated memory after
    the run is the live groups' state and no more), and the run equals the
    same run on the CPU — alert bytes and state leaves."""
    import gc

    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, Fault
    from rtap_tpu_torch.service.loop import live_loop

    cfg = cluster_preset()
    ids = [f"n{i // 3}.m{i % 3}" for i in range(512)]

    def source(k):
        rng = np.random.Generator(np.random.Philox(key=(9, k)))
        return (30 + 5 * rng.random(len(ids))).astype(np.float32), 1_700_000_000 + k

    out = {}
    for dev in ("cuda", "cpu"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        reg = _chaos_registry(dev, cfg, ids, 256)
        spec = ChaosSpec(faults=[Fault(kind="collect_exception", tick=6, group=1)])
        stats = live_loop(source, reg, n_ticks=16, cadence_s=0.0, pipeline_depth=2,
                          alert_path=str(tmp_path / f"{dev}.jsonl"),
                          checkpoint_dir=str(tmp_path / f"ck-{dev}"), checkpoint_every=4,
                          quarantine_restore_after=3, chaos=ChaosEngine(spec))
        assert [e["event"] for e in stats["quarantine_log"]] == ["group_quarantined",
                                                                 "group_restored"]
        assert reg.groups[1].alert_epoch == 1 and reg.groups[1].device.type == dev
        if dev == "cuda":
            gc.collect()
            torch.cuda.synchronize()
            live = sum(t.numel() * t.element_size() for g in reg.groups
                       for t in g.state.values())
            held = torch.cuda.memory_allocated() - base
            # one group of 256 streams is ~77 MB: a lingering old group would
            # show as a whole group's worth above the live state
            assert held < live + live // 4, (held, live)
            assert stats["kernel_launches"]["tm_learn"] == stats["learned_group_ticks"]
        out[dev] = (stats, [state_to_numpy(g.state) for g in reg.groups],
                    open(tmp_path / f"{dev}.jsonl").read().splitlines())
        del reg
    (cs, cst, clines), (ps, pst, plines) = out["cuda"], out["cpu"]
    alerts = lambda lines: [ln for ln in lines if not ln.startswith('{"event"')]  # noqa: E731
    assert alerts(clines) == alerts(plines) and len(alerts(clines)) > 0
    assert cs["quarantine_log"] == ps["quarantine_log"]
    assert cs["scored_by_group"] == ps["scored_by_group"]
    for a, b in zip(cst, pst):
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k


class _Watched:
    """A group proxy that records every dispatched handle and wraps its
    completion event, so the test sees which handles were waited on."""

    def __init__(self, inner):
        self._inner = inner
        self.handles = []
        self.collected = []

    def dispatch_chunk(self, *a, **kw):
        h = self._inner.dispatch_chunk(*a, **kw)
        waited = []
        ev = h["done"]

        class _Event:
            def synchronize(self):
                waited.append(True)
                ev.synchronize()

        h["done"] = _Event()
        self.handles.append((h["seq"], waited))
        return h

    def collect_chunk(self, h):
        self.collected.append(h["seq"])
        return self._inner.collect_chunk(h)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_quarantined_groups_in_flight_handle_is_dropped_without_a_wait(cuda, tmp_path):
    """Pipeline depth 2 on the card: a collect fault quarantines the group
    while its next chunk is in flight; that handle is never collected and
    its event never waited on, and the other group keeps every tick."""
    from rtap_tpu_torch.config import scaled_cluster_preset
    from rtap_tpu_torch.resilience import ChaosEngine, ChaosSpec, Fault
    from rtap_tpu_torch.service.loop import live_loop

    ids = [f"s{i}" for i in range(8)]
    reg = _chaos_registry("cuda", scaled_cluster_preset(64), ids, 4)
    watched = _Watched(reg.groups[1])
    reg.groups[1] = watched
    stats = live_loop(lambda k: (np.full(8, 30.0 + k % 5, np.float32), 1_700_000_000 + k),
                      reg, n_ticks=10, cadence_s=0.0, pipeline_depth=2,
                      alert_path=str(tmp_path / "a.jsonl"),
                      chaos=ChaosEngine(ChaosSpec(faults=[
                          Fault(kind="collect_exception", tick=4, group=1)])))
    assert stats["quarantine_log"][0]["phase"] == "collect"
    dropped = [(seq, waited) for seq, waited in watched.handles
               if seq not in watched.collected]
    # the chunk dispatched at tick 4 was in flight when tick 3's collect
    # raised at tick 4: never collected, never waited on
    assert dropped and all(not waited for _, waited in dropped)
    assert stats["scored_by_group"][0] == 4 * 10
