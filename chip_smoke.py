"""Drive the PyTorch port's replay path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed S] [--streams G] [--ticks T]

Phases, one JSON line each; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit (also printed raw).
2. build: the TM learning kernel, rtap_tpu_torch/csrc/tm_learn.cu, with nvcc
   for sm_90a.
3. kernel vs plain: the TM learning-pass kernel against its plain PyTorch
   version on states that went through a few hundred real learning ticks
   (cluster preset, G = 64, u16 and f32 domains; NAB preset geometry,
   G = 1, W = 1280), bit for bit, with CUDA-event times and the byte bounds
   (``ops/tm_learn.pass_bytes``: what these inputs need, and every row in
   full); then the same on a dense random state at the main path's
   per-stream shape (n_seg = 4096, M = 12, int16/u16, G = 2,048).
4. the slice: ``replay_streams`` on cuda, cluster preset, G streams in one
   group, T ticks in chunks of 64 with learning, synthetic cluster data from
   --seed. The kernel's launch count must equal the learning ticks, raw must
   be finite in [0, 1] and tm_overflow 0. Then the kernel and the plain
   version are timed and compared on the group's own state at that shape.
5. card vs CPU: a G = 8 group, 64 learning ticks, on cuda (kernel) and on
   the CPU (plain): same raw scores and state, bit for bit.

Then the kernels line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM 32-bit non-tensor peak (NVIDIA data sheet)
KERNEL_SOURCE = "rtap_tpu_torch/csrc/tm_learn.cu"
KERNEL_REPLACES = "rtap_tpu/ops/pallas_tm.py:86"
DENSE_STREAMS = 2048  # the dense row's G: the plain version finishes it in seconds


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int, before=None) -> float:
    """Median CUDA-event time of fn() over `reps` runs; `before()` runs
    between them, outside the timed window. A spin kernel ahead of
    the window keeps the stream busy while the host enqueues fn()'s work,
    so the window holds device time, not the wrapper's host time."""
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def pass_ops(args, Ac: int, N: int) -> int:
    """32-bit ops the pass needs on these inputs: the two packed-membership
    probes of every slot, and on each growing row one membership compare of
    every slot with each valid winner of its stream."""
    presyn, meta, wids = args[0], args[2], args[5]
    G, R, M = presyn.shape
    grow_rows = (((meta >> 2) & 1) > 0).sum(1, dtype=torch.int64)  # [G]
    valid_winners = (wids < N).sum(1, dtype=torch.int64)  # [G]
    return G * R * M * 2 * Ac + int((grow_rows * valid_winners).sum()) * M


def learned_state(cfg, G: int, ticks: int, seed: int):
    """The next tick's learning pass for a [G, ...] state after `ticks`
    real learning ticks on synthetic cluster data."""
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.models.state import init_state
    from rtap_tpu_torch.ops.step import chunk_step, next_learn_pass, replicate_state_device

    streams = cluster_streams(G, ticks + 1, seed, n_anomalies=0)
    vals = torch.from_numpy(np.stack([s.values for s in streams], 1)[:, :, None]).cuda()
    ts = torch.from_numpy(np.stack([s.timestamps for s in streams], 1).astype(np.int32)).cuda()
    st = replicate_state_device(init_state(cfg, seed), G, "cuda")
    st, _ = chunk_step(st, vals[:ticks], ts[:ticks], cfg)
    return next_learn_pass(cfg, st, vals[ticks], ts[ticks])


def compare_pass(name, lp, kernel_reps=20, plain_reps=3) -> dict:
    """Kernel vs plain on one learning pass's inputs (each on its own copy
    of the pools): bit-equal outputs, CUDA-event medians, the bound."""
    import rtap_tpu_torch.ops.tm_learn as tl

    args, cs, K, N = lp.args, lp.consts, lp.K, lp.N
    base = [a.clone() for a in args[:2]]
    k_pools = [a.clone() for a in base]
    p_pools = [a.clone() for a in base]
    before = tl.launches
    got = tl.tm_learn_kernel(*k_pools, *args[2:], cs, K, N)
    want = tl.tm_learn_plain(*p_pools, *args[2:], cs, K, N)
    torch.cuda.synchronize()
    names = ("presyn", "perm", "nsyn", "conn", "pot")
    pairs = list(zip(names, [*k_pools, *got], [*p_pools, *want]))
    errs = {n: (a.to(torch.float64) - b.to(torch.float64)).abs().max().item() for n, a, b in pairs}
    bad = [n for n, a, b in pairs if not torch.equal(tl.as_bits(a), tl.as_bits(b))]
    if bad:  # the tolerance is bit-equality (an f32 -0.0 is not +0.0)
        raise AssertionError(f"{name}: kernel and plain differ in {bad} (max abs error {errs})")

    def restore(pools):
        return lambda: [p.copy_(b) for p, b in zip(pools, base)]

    kernel_ms = cuda_ms(lambda: tl.tm_learn_kernel(*k_pools, *args[2:], cs, K, N),
                        kernel_reps, restore(k_pools))
    plain_ms = cuda_ms(lambda: tl.tm_learn_plain(*p_pools, *args[2:], cs, K, N),
                       plain_reps, restore(p_pools))
    nbytes, nbytes_full = tl.pass_bytes(args, *p_pools)
    occupancy = tl.pass_occupancy(args, *p_pools)
    ops = pass_ops(args, args[3].shape[1], N)
    byte_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    full_ms = nbytes_full / HBM_BYTES_PER_S * 1e3
    G, R, M = args[0].shape
    return dict(
        shape=name, G=G, n_seg=R, M=M, K=K, W=args[5].shape[1], Ac=args[3].shape[1],
        presyn_dtype=str(args[0].dtype), perm_dtype=str(args[1].dtype),
        equal=True, max_abs_err=max(errs.values()), kernel_ms=kernel_ms, plain_ms=plain_ms,
        bytes=nbytes, bytes_full=nbytes_full, ops=ops, bound_ms=max(byte_ms, ops_ms),
        bound_by="bytes" if byte_ms >= ops_ms else "operations",
        bound_full_ms=max(full_ms, ops_ms),
        grow_rows=int((((args[2] >> 2) & 1) > 0).sum()), **occupancy,
        kernel_launches_in_compare=tl.launches - before)


def dense_pass(cfg, G: int, seed: int):
    """A learning pass at the main path's per-stream shape on random,
    densely filled pools, made on the card from `seed`: about 65% of slots
    hold a synapse (some at permanence 0, which death kills), and each row
    carries each of the learn/alloc/grow/punish flags with probability
    0.2/0.05/0.15/0.1, n_grow in [0, M + 2]. The state a long-lived
    deployment's pools approach, where most rows need their perm."""
    from types import SimpleNamespace

    from rtap_tpu_torch.models.perm import tm_domain
    from rtap_tpu_torch.ops.tm_learn import LearnConsts

    tm = cfg.tm
    C, K, S, M, Ac = cfg.sp.columns, tm.cells_per_column, tm.max_segments_per_cell, \
        tm.max_synapses_per_segment, tm.col_cap
    N, R, W = C * K, C * K * S, Ac * K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    presyn = randint(0, N, G, R, M)
    presyn[rand(G, R, M) < 0.35] = -1
    perm = randint(0, 65536, G, R, M)
    perm[rand(G, R, M) < 0.2] = 32767  # ties for the eviction rank
    perm = torch.where(presyn >= 0, perm, 0)
    flags = (rand(G, R, 4) < torch.tensor([0.2, 0.05, 0.15, 0.1], device=dev)).to(torch.int32)
    n_grow = randint(-2, M + 3, G, R).clamp(min=0)
    meta = (flags * torch.tensor([1, 2, 4, 8], device=dev, dtype=torch.int32)).sum(-1) | (n_grow << 4)

    def packed():  # Ac ascending column ids (fills C), K-bit masks (fills 0)
        n = randint(1, Ac + 1, G, 1)
        ids = rand(G, C).argsort(1)[:, :Ac]
        keep = torch.arange(Ac, device=dev) < n
        ids = torch.where(keep, ids, C).sort(1).values
        masks = torch.where(ids < C, randint(1, 1 << K, G, Ac), 0)
        return ids, masks

    pids, pmasks = packed()
    aids, amasks = packed()
    n_w = randint(0, W + 1, G, 1)
    wids = rand(G, N).argsort(1)[:, :W]
    wids = torch.where(torch.arange(W, device=dev) < n_w, wids, N).sort(1).values
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = (presyn.to(torch.int16), perm.to(torch.int32).to(torch.uint16), i32(meta),
            i32(pids), i32(pmasks), i32(wids), i32(aids), i32(amasks))
    return SimpleNamespace(args=args, consts=LearnConsts.from_config(tm, tm_domain(tm)), K=K, N=N)


def phase_dense(G: int, seed: int, card) -> dict:
    from rtap_tpu_torch.config import cluster_preset

    t0 = time.perf_counter()
    row = compare_pass("cluster_u16_dense", dense_pass(cluster_preset(), G, seed),
                       kernel_reps=10, plain_reps=2)
    row.update(setup_s=time.perf_counter() - t0, card=card)
    emit("kernel_vs_plain", **row)
    return row


def phase_compare(label, cfg, G, warm_ticks, seed, card) -> dict:
    t0 = time.perf_counter()
    row = compare_pass(label, learned_state(cfg, G, warm_ticks, seed))
    row.update(warm_ticks=warm_ticks, setup_s=time.perf_counter() - t0, card=card)
    emit("kernel_vs_plain", **row)
    return row


def phase_slice(G: int, T: int, seed: int, card):
    """replay_streams at full width; then kernel vs plain on the replayed
    group's own state -> (kernel launches in the replay, compare row)."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.models.state import state_nbytes
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.ops.step import next_learn_pass
    from rtap_tpu_torch.service.replay import replay_streams

    cfg = cluster_preset()
    t0 = time.perf_counter()
    streams = cluster_streams(G, T, seed, anomaly_magnitude=6.0, inject_after_frac=0.25)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tl.reset_launches()
    res = replay_streams(streams, cfg, device="cuda", chunk_ticks=64)
    torch.cuda.synchronize()
    launches = tl.launches
    assert launches == T, f"kernel launched {launches} times for {T} learning ticks"
    raw = res.raw
    assert raw.shape == (T, G) and np.isfinite(raw).all(), "raw has non-finite values"
    assert ((raw >= 0) & (raw <= 1)).all(), "raw outside [0, 1]"
    assert res.throughput["tm_overflow_total"] == 0, res.throughput
    el = res.throughput["elapsed_s"]
    emit("slice", preset="cluster_preset", streams=G, ticks=T, chunk_ticks=64, learn=True,
         groups=len(res.registry.groups), kernel_launches=launches, learning_ticks=T,
         elapsed_s=el, ticks_per_s=T / el, stream_ticks_per_s=G * T / el,
         state_bytes_per_stream=state_nbytes(cfg)["total"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         raw_mean=float(raw.mean()), alerts=res.throughput["alerts"], data_gen_s=gen_s,
         card=card)

    st = res.registry.groups[0].state
    values = torch.from_numpy(np.stack([s.values[-1:] for s in streams], 0)).cuda()
    ts = torch.from_numpy(np.array([s.timestamps[-1] + 1 for s in streams], np.int32)).cuda()
    lp = next_learn_pass(cfg, st, values, ts)
    del res, st
    row = compare_pass("cluster_u16_main_path", lp, kernel_reps=10, plain_reps=2)
    row.update(card=card)
    emit("kernel_vs_plain", **row)
    return launches, row


def phase_card_vs_cpu(seed: int, G: int = 8, T: int = 64) -> None:
    """The same group on the card (kernel) and on the CPU (plain): raw,
    log-likelihood and every state leaf bit-equal."""
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.service.registry import StreamGroup

    small = cluster_streams(G, T, seed + 1, n_anomalies=0)
    sv = np.stack([s.values for s in small], 1)
    sts = np.stack([s.timestamps for s in small], 1)
    out = {}
    for dev in ("cuda", "cpu"):
        g = StreamGroup(cluster_preset(), [s.stream_id for s in small], seed=seed, device=dev)
        r, ll, _ = g.run_chunk(sv, sts)
        out[dev] = (r, ll, state_to_numpy(g.state))
    (rc, llc, sc), (rp, llp, sp) = out["cuda"], out["cpu"]
    assert np.array_equal(rc, rp), "raw differs between card and CPU"
    assert np.array_equal(llc, llp), "log-likelihood differs between card and CPU"
    leaf_diff = [k for k in sc if not np.array_equal(sc[k], sp[k], equal_nan=True)]
    assert not leaf_diff, f"state differs between card and CPU: {leaf_diff}"
    emit("card_vs_cpu", streams=G, ticks=T, raw_equal=True, loglik_equal=True,
         state_leaves=len(sc), state_equal=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", type=int, default=32768)
    ap.add_argument("--ticks", type=int, default=128)
    ap.add_argument("--warm-ticks", type=int, default=300,
                    help="learning ticks before the kernel-vs-plain comparisons")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rtap_tpu_torch.config import cluster_preset, nab_preset
    from rtap_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit("card", **card)

    # 2. build the kernel from its source
    lib, out, secs = _build.build("tm_learn", force=True)
    emit("build", kernel="tm_learn", seconds=secs,
         lib=str(lib.relative_to(_build.PKG_DIR.parent)),
         instantiations=sum("Compiling entry function" in ln for ln in out.splitlines()),
         # ptxas -v per instantiation, deduplicated: registers, shared memory, stack; spills
         ptxas=sorted({ln.split("Used", 1)[1].strip() for ln in out.splitlines() if "Used" in ln}
                      | {ln.strip() for ln in out.splitlines()
                         if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln}))

    # 3. kernel vs plain on learned states
    cmp_rows = [phase_compare(label, cfg, G, args.warm_ticks, args.seed, smi)
                for label, cfg, G in (("cluster_u16", cluster_preset(), 64),
                                      ("cluster_f32", cluster_preset(perm_bits=0), 64),
                                      ("nab", nab_preset(), 1))]
    cmp_rows.append(phase_dense(DENSE_STREAMS, args.seed, smi))
    # 4. the slice, then the kernel at the main path's own shape
    launches, main_row = phase_slice(args.streams, args.ticks, args.seed, smi)
    # 5. card vs CPU
    phase_card_vs_cpu(args.seed)

    kern = {
        "name": "tm_learn", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cmp_rows + [main_row]),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_full_ms": main_row["bound_full_ms"],
        "library_ms": None,
    }
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
