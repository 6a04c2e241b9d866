"""Drive the PyTorch port's replay, serve, NAB, model and eval paths on one NVIDIA GPU and check them.

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
   per-stream shape (n_seg = 4096, M = 12, int16/u16, G = 2,048); then
   learned states at the group sizes of phases 6 and 7 (G = 4,096 and
   1,024), at the shapes of phases 11 and 14 (nab_preset at G = 8,
   composite and categorical presets at G = 64), and at the evals' (one
   group of 1,000 cluster streams; node_preset(3), the dense S = 4
   geometry, at G = 12 on fused node data).
4. the slice: ``replay_streams`` on cuda, cluster preset, G streams in one
   group, T ticks in chunks of 64 with learning, synthetic cluster data from
   --seed. The kernel's launch count must equal the learning ticks, raw must
   be finite in [0, 1] and tm_overflow 0. Then the kernel and the plain
   version are timed and compared on the group's own state at that shape.
5. card vs CPU: a G = 8 group, 64 learning ticks, on cuda (kernel) and on
   the CPU (plain): same raw scores and state, bit for bit.
6. serve: ``python -m rtap_tpu_torch serve`` as a child process, cluster
   preset at full width, 32,768 stream ids (``--streams @file``) in groups
   of 4,096, pipeline depth 2, 1 s cadence, 40 ticks learning every tick,
   alerts, the write-ahead journal and checkpoints (a save round at tick
   20 and on exit) on; a feeder here pushes one tick of seeded synthetic
   cluster values over TCP (``send_jsonl``) each time the child journals a
   tick, so every tick after the first polls one whole fed tick. The child
   must exit 0 with every tick scored for every stream, no value missing
   past tick 0, every record sent parsed, no parse errors or unknown ids, no
   capacity overflow, both checkpoint rounds saved, its telemetry registry
   agreeing with its stats, and one kernel launch per group per tick (the
   child's own counts, from 0). Only tick 0 and the two save ticks (19 and
   39) may miss the 1 s deadline: the missed_tick events are read from the
   child's alert stream and each is gated, its phase split reported. Tick
   latency, per-phase ms, seconds per group save, parse rate and peak
   device memory are reported, not gated.
7. kill -9 drill: this script's hidden ``--child`` mode runs the port's
   ``live_loop`` (2,048 streams in 2 groups, 96 ticks at cadence 0,
   checkpoints every 16 ticks, journal on, a seeded source keyed by the
   global tick, every stream alerting every tick) once without faults, then
   again with SIGKILLs at two journal-observed ticks off the save grid,
   restarted until its tick budget is done: final checkpoint leaves
   bit-equal to the fault-free run, every alert id exactly once with equal
   record bytes, both kills rc -9, and the fault-free child's launches
   equal to groups x learning ticks.
8. serve with the model-side flags: phase 6's serve (32,768 streams in 8
   groups of 4,096, depth 2, 1 s cadence, 40 learning ticks, the journal,
   the tick-gated feeder) with ``--health --predict --topology infer``, ids
   renamed ``svc<s>-<n>.<metric>`` so the inferred topology groups them
   (128 services), timestamps anchored ahead of the wall clock, and no
   checkpoint dir. Gates: exit 0, every tick scored, one kernel launch per
   group per tick, 8 x 40 health and predict folds, a finite fleet miss
   EWMA, the trackers armed, ``<alerts>.epoch`` at 1. Latency, per-phase ms
   and peak memory are reported beside phase 6's.
9. flags on vs off: the drill's shape (2 groups of 1,024, 96 ticks at
   cadence 0, every stream alerting every tick) through ``live_loop`` on
   the card with health + predict 8 and the trackers, and without: every
   model leaf (the predictor's own aside) bit-equal, the raw scores bit
   for bit and the alert lines byte for byte; launches equal; every scored
   stream's miss EWMA finite. Then one learning tick of a 64-stream slice of
   that state on the card and on the CPU with both reducers: predict leaves,
   raw and state bit for bit, health integers exact and floats at
   rtol=1e-5, atol=1e-6.
10. the cascade eval: ``python -m rtap_tpu_torch.predict_eval`` at the JAX
   script's defaults on the card (win, blast covered, 0 false precursors)
   and on this machine's CPU (the same page tick and first-precursor
   ticks); then on the card with ``--workdir``, killed with SIGKILL once
   its first precursor is on the alert stream and resumed from its
   checkpoint and journal: every precursor, predicted_incident and
   incident id exactly once, the page tick unchanged.
11. the NAB corpus: ``python -m rtap_tpu_torch nab`` as a child on the card
   over data/nab (8 files, 32,256 records, nab_preset, every file one stream
   of one group): the JAX package's quality floors for this corpus, finite
   per-file scores, one kernel launch per learning tick; wall time,
   records/s and peak device memory reported, the scores beside the JAX
   package's TPU run of the same corpus (quality only). The group's final
   state, saved by the child, holds the kernel to its plain version after
   4,032 learning ticks. Then card == CPU on the first NAB_CPU_ROWS rows of
   one file (raw equal, loglik within 1e-12, scores equal): past the
   likelihood probation and through a labelled window, what the CPU runs in
   about a minute at this width.
12. ``AnomalyDetector`` on the card over golden_config1's stream: raw equal
   to tests/golden/golden_config1.npz, loglik within 1e-12; saved at row
   200, loaded and continued: the same rows.
13. the SDR classifier: cluster_preset + classifier at G = 64 over 64
   learning ticks on the card and the CPU: raw, the model leaves and
   cls_cnt bit for bit, cls_w at rtol 1e-5 / atol 1e-6, predictions and
   probabilities within 1e-4.
14. ``serve --preset nab`` (64 streams in one group, 30 ticks),
   ``--preset composite`` and ``--preset categorical`` (4,096 streams in one
   group, 20 ticks each) fed by phase 6's tick-gated TCP feeder at 1 s
   cadence: every tick after tick 0 under 1 s, values missing only at tick
   0, well-formed alert lines, one launch per group per learning tick; peak
   device memory reported.
15. ``python -m rtap_tpu_torch eval`` (its main, in this process) on the
   card: (a) tests/integration/test_fault_eval.py's fixture shape, 40 x
   1,000, window, streaming and streaming with learn-every 2, each held to
   that file's floors and to one launch per learning tick; (b) 12 streams x
   1,000 on the card and the CPU, reports equal but for wall-clock
   entries; (c) the committed artifacts' shape, 120 x 1,500, streaming and
   window: the per-kind and overall event counts equal
   reports/fault_eval.json / _window.json's (quality printed beside them);
   (d) BASELINE config 3, 1,000 streams x 1,500 in one group, streaming:
   1,500,000 scored, 1,500 launches, the floors; wall, replay and sweep
   seconds, metrics/s and peak device memory reported.
16. ``python -m rtap_tpu_torch.eval.workload_eval`` on the card at 12
   streams x 900 (seed 11): exit 0 with the composite gate held, 4 x 900
   launches, every modality's at_best beside reports/workloads_r09.json;
   the log-template modality at 4 streams on the card and the CPU: equal.
17. ``python -m rtap_tpu_torch.eval.node_eval`` on the card at 12 nodes x
   1,400: the coupled and single event counts equal
   reports/multivariate_node.json's, 1,400 launches; 2 nodes x 400 on the
   card and the CPU: raw and loglik equal. One held-out cell
   (preset_256col, magnitude 6, seed 11, 40 x 1,000): its events the
   generator's, 1,000 launches.
18. ``python -m rtap_tpu_torch report`` on the card with 15(c)'s streaming
   report: both PNGs written. Where matplotlib is not installed, a line
   says so and the report's replay runs on the card and the CPU instead:
   raw and loglik equal. 900 launches either way.

Then the kernels line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM 32-bit non-tensor peak (NVIDIA data sheet)
KERNEL_SOURCE = "rtap_tpu_torch/csrc/tm_learn.cu"
KERNEL_REPLACES = "rtap_tpu/ops/pallas_tm.py:86"
DENSE_STREAMS = 2048  # the dense row's G: the plain version finishes it in seconds
SERVE_STREAMS, SERVE_GROUP, SERVE_TICKS = 32768, 4096, 40  # phase 6
SERVE_CHECKPOINT_EVERY = 20  # one save round mid-run, one on exit
DRILL_STREAMS, DRILL_GROUP, DRILL_TICKS = 2048, 1024, 96  # phase 7: 2 groups
DRILL_CHECKPOINT_EVERY = 16
DRILL_KILLS = (40, 70)  # journal ticks to SIGKILL at, off the 16-tick save grid
NAB_RECORDS = 32256  # data/nab: 8 files of 4,032 rows
NAB_ROWS = 4032  # learning ticks of the batched corpus run (the longest file)
# the JAX package's quality floors for this corpus
# (tests/integration/test_nab_run.py::test_committed_corpus_artifact_floors)
NAB_FLOORS = {"standard": 6.0, "reward_low_FN": 15.0, "reward_low_FP": 2.0}
# card == CPU on a prefix of one file: past the 388-row likelihood probation
# and through the file's first labelled window (rows 1,117-1,185), about a
# minute of the CPU's plain path at this width
NAB_CPU_SUBSET, NAB_CPU_ROWS = "realAWSCloudwatch/ec2_cpu_utilization_5f5533", 1200
GOLDEN_ROWS, GOLDEN_SAVE_AT = 400, 200  # phase 12
CLS_STREAMS, CLS_TICKS = 64, 64  # phase 13
# phase 14: (preset, streams, group size, ticks)
PRESET_SERVES = (("nab", 64, 64, 30), ("composite", 4096, 4096, 20),
                 ("categorical", 4096, 4096, 20))
EVAL_1K_STREAMS, NODE_STREAMS = 1000, 12  # phase 3's eval and node rows
# phase 15: (streams, ticks) of tests/integration/test_fault_eval.py's
# fixture, of reports/fault_eval*.json, and of BASELINE config 3
EVAL_FIXTURE, EVAL_ARTIFACT, EVAL_1K = (40, 1000), (120, 1500), (EVAL_1K_STREAMS, 1500)
EVAL_CPU_STREAMS = 12
# tests/integration/test_fault_eval.py's floors
WINDOW_FLOORS = {"at_best": {"f1": 0.60, "recall": 0.80, "precision": 0.50},
                 "at_default": {"f1": 0.55, "recall": 0.70}}
MAX_MEDIAN_LATENCY_S = 10.0  # at_best, with WINDOW_FLOORS
STREAMING_FLOORS = {"at_best": {"f1": 0.80, "recall": 0.82, "precision": 0.77},
                    "at_default": {"precision": 0.85, "recall": 0.45}}
K2_FLOORS = {"at_best": {"f1": 0.78, "recall": 0.76, "precision": 0.79}}
# 1,000 streams, streaming. At the F1-optimal point: the window fixture's
# f1 floor and test_fault_eval.py's target for the artifact's scale
# (precision >= 0.70 at recall >= 0.75; the window fixture's recall 0.80 is
# a 40-stream floor, and the JAX package itself gives 0.798 here). At the
# service default, the streaming fixture's floors (a streaming run leans
# precision-first there: the 120-stream artifact's default recall is 0.575).
EVAL_1K_FLOORS = {"at_best": {"f1": WINDOW_FLOORS["at_best"]["f1"], "recall": 0.75,
                              "precision": 0.70},
                  "at_default": STREAMING_FLOORS["at_default"]}
WALL_CLOCK = ("elapsed_s", "metrics_per_sec")
WORKLOAD_SHAPE = (12, 900, 11)  # phase 16: reports/workloads_r09.json's
NODE_SHAPE, NODE_CPU = (12, 1400), (2, 400)  # phase 17
HELDOUT_CELL = ("preset_256col", 6.0, 11, 40, 1000)  # variant, magnitude, seed, streams, ticks
REPORT_TICKS = 900  # phase 18: the report's replay, one group


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
    real learning ticks on synthetic cluster data (fused cpu/mem/net nodes
    for a multivariate node config; a composite config reads one wire value
    per stream, as serve feeds it)."""
    from rtap_tpu_torch.data.synthetic import SyntheticStreamConfig, cluster_streams, generate_node
    from rtap_tpu_torch.models.state import init_state
    from rtap_tpu_torch.ops.step import chunk_step, next_learn_pass, replicate_state_device

    if cfg.n_fields == 1 or cfg.composite is not None:
        streams = cluster_streams(G, ticks + 1, seed, n_anomalies=0)
        values = np.stack([s.values for s in streams], 1)[:, :, None]
    else:
        scfg = SyntheticStreamConfig(length=ticks + 1, n_anomalies=0, noise_phi=0.97,
                                     noise_scale=0.5)
        streams = [generate_node(f"node{i:05d}", scfg, seed=seed + i) for i in range(G)]
        values = np.stack([s.values for s in streams], 1)
    vals = torch.from_numpy(values).cuda()
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


def parse_capacity(records: list[dict], ids: list[str]) -> float:
    """Records per second one TcpJsonlSource parses on this host with
    nothing else running: one tick's records, encoded ahead, pushed over
    loopback; the clock runs from the first byte sent to the last record
    counted (the serve child parses on its listener threads, beside the
    loop)."""
    from rtap_tpu_torch.service.sources import TcpJsonlSource

    payload = "".join(json.dumps(r) + "\n" for r in records).encode()
    with TcpJsonlSource(ids) as src:
        t0 = time.perf_counter()
        with socket.create_connection(src.address) as conn:
            conn.sendall(payload)
        deadline = time.time() + 60
        while src.records_parsed < len(records) and time.time() < deadline:
            time.sleep(0.001)
        seconds = time.perf_counter() - t0
        if src.records_parsed != len(records) or src.parse_errors:
            raise AssertionError(f"parsed {src.records_parsed} of {len(records)} records, "
                                 f"{src.parse_errors} parse errors")
    return len(records) / seconds


def _telemetry(stats: dict) -> dict:
    """The serve child's telemetry registry (its stats line's snapshot),
    unlabelled instruments by name."""
    return {m["name"]: m["value"] for m in stats["telemetry"]["metrics"] if "labels" not in m}


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _serve_child(ids: list[str], ticks: list[list[dict]], work: str, extra: list[str],
                 group: int = SERVE_GROUP, n_ticks: int = SERVE_TICKS) -> tuple:
    """`python -m rtap_tpu_torch serve` on cuda over `ids` (groups of
    `group`, depth 2, 1 s cadence, `n_ticks` ticks, alerts and the journal
    in `work`, plus `extra` flags), fed over TCP by this process: tick
    t + 1's records when the child journals tick t -> (stats, records sent,
    stderr)."""
    from rtap_tpu_torch.resilience.journal import last_journal_tick
    from rtap_tpu_torch.service.sources import send_jsonl

    with open(os.path.join(work, "ids.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    journal_dir = os.path.join(work, "journal")
    cmd = [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams",
           "@" + os.path.join(work, "ids.txt"), "--device", "cuda",
           "--group-size", str(group), "--pipeline-depth", "2", "--cadence", "1.0",
           "--ticks", str(n_ticks), "--port", "0",
           "--alerts", os.path.join(work, "alerts.jsonl"), "--journal-dir", journal_dir, *extra]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err_lines: list[str] = []
    port: list[int] = []

    def read_stderr():
        for line in proc.stderr:
            err_lines.append(line)
            if "listening for JSONL records on" in line:
                port.append(int(line.rsplit(":", 1)[1]))

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        deadline = time.time() + 300
        while not port and proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if not port:
            raise AssertionError(f"serve never listened (rc {proc.poll()}):\n"
                                 + "".join(err_lines)[-3000:])
        sent = 0
        for t, records in enumerate(ticks):
            # the child journals tick t's polled row before scoring it: from
            # then on, what arrives is what tick t + 1 polls
            deadline = time.time() + 300
            while last_journal_tick(journal_dir) < t and proc.poll() is None \
                    and time.time() < deadline:
                time.sleep(0.002)
            if proc.poll() is not None or last_journal_tick(journal_dir) < t:
                break
            sent += send_jsonl(("127.0.0.1", port[0]), records)
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"serve exited {proc.returncode}:\n"
                                 + "".join(err_lines)[-3000:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    return json.loads(out.strip().splitlines()[-1]), sent, "".join(err_lines)


def _missed_ticks(alerts_path: str) -> list[tuple[int, float]]:
    """(tick, elapsed_s) of every missed_tick event on an alert stream."""
    missed = []
    with open(alerts_path) as f:
        for line in f:
            if line.startswith('{"event"'):
                ev = json.loads(line)
                if ev["event"] == "missed_tick":
                    missed.append((ev["tick"], ev["elapsed_s"]))
    return missed


def _serve_feed(seed: int, ts0: int | None = None, n_streams: int = SERVE_STREAMS,
                n_ticks: int = SERVE_TICKS, value=float):
    """Seeded synthetic cluster values for `n_streams` streams -> (their
    stream ids, one record list per fed tick 1..n_ticks-1, seconds).
    `ts0` re-anchors the timestamps (tick 0 at ts0); `value` maps each
    synthetic value to the wire value."""
    from rtap_tpu_torch.data.synthetic import cluster_streams

    t0 = time.perf_counter()
    # tick 0 polls before anything is sent; ticks 1.. get one fed tick each
    streams = cluster_streams(n_streams, n_ticks - 1, seed, n_anomalies=0)
    ids = [s.stream_id for s in streams]
    shift = 0 if ts0 is None else ts0 + 1 - int(streams[0].timestamps[0])
    ticks = [[{"id": sid, "value": value(s.values[t]), "ts": int(s.timestamps[t]) + shift}
              for sid, s in zip(ids, streams)] for t in range(n_ticks - 1)]
    return ids, ticks, time.perf_counter() - t0


def phase_serve(seed: int, card: str) -> dict:
    """`python -m rtap_tpu_torch serve` at full width in a child process,
    fed over TCP by this process in step with the child's ticks; checks
    its stats line."""
    work = tempfile.mkdtemp(prefix="rtap-serve-")
    ids, ticks, gen_s = _serve_feed(seed)
    parse_rate = parse_capacity(ticks[0], ids)
    ck_dir = os.path.join(work, "ck")
    try:
        stats, sent, _ = _serve_child(ids, ticks, work, [
            "--checkpoint-dir", ck_dir, "--checkpoint-every", str(SERVE_CHECKPOINT_EVERY)])
        ck_bytes = _tree_bytes(ck_dir)
        missed = _missed_ticks(os.path.join(work, "alerts.jsonl"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tel = _telemetry(stats)
    groups = SERVE_STREAMS // SERVE_GROUP
    # tick k saves when k + 1 is a multiple of SERVE_CHECKPOINT_EVERY (19, 39)
    save_ticks = {k for k in range(SERVE_TICKS) if (k + 1) % SERVE_CHECKPOINT_EVERY == 0}
    checks = {
        "ticks": stats["ticks"] == SERVE_TICKS,
        "scored": stats["scored"] == SERVE_TICKS * SERVE_STREAMS,
        # every fed tick was polled whole: only tick 0, polled before the
        # first push, lacks values
        "missing_values": stats["missing_values"] == SERVE_STREAMS,
        "records_sent": sent == (SERVE_TICKS - 1) * SERVE_STREAMS,
        "records_parsed": stats["records_parsed"] == sent,
        "parse_errors": stats["parse_errors"] == 0,
        "unknown_ids": stats["unknown_ids"] == 0,
        "tm_overflow_total": stats["tm_overflow_total"] == 0,
        # the round at SERVE_CHECKPOINT_EVERY and the final save on exit
        "checkpoints_saved": stats.get("checkpoints_saved") == 2,
        # the source syncs its ingest tallies into the registry at each poll,
        # and the last record is parsed before the last poll
        "telemetry": (tel["rtap_obs_ticks_total"], tel["rtap_obs_scored_total"],
                      tel["rtap_obs_ingest_records_total"])
                     == (stats["ticks"], stats["scored"], stats["records_parsed"]),
        # the child's own launch count, from 0 in that fresh process
        "kernel_launches": stats["kernel_launches"]["tm_learn"] == groups * SERVE_TICKS,
        # only tick 0 (module loading, first allocations) and the save ticks
        # may miss the 1 s deadline; the stats' count agrees with the events
        "missed_ticks": all(t == 0 or t in save_ticks for t, _ in missed)
                        and len(missed) == stats["missed_deadlines"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serve checks failed {bad} (records sent {sent}, missed {missed}, "
                             f"their phase ms {stats.get('missed_tick_phase_ms')}): "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }")
    row = dict(preset="cluster_preset", streams=SERVE_STREAMS, group_size=SERVE_GROUP,
               groups=groups, ticks=stats["ticks"], cadence_s=stats["cadence_s"],
               pipeline_depth=stats["pipeline_depth"], learn_every=1,
               scored=stats["scored"], missing_values=stats["missing_values"],
               alerts=stats["alerts"],
               latency_p50_ms=stats["latency_p50_ms"], latency_p90_ms=stats["latency_p90_ms"],
               latency_p99_ms=stats["latency_p99_ms"], latency_max_ms=stats["latency_max_ms"],
               missed_deadlines=stats["missed_deadlines"], missed_ticks=missed,
               missed_tick_phase_ms=stats["missed_tick_phase_ms"], save_ticks=sorted(save_ticks),
               phase_ms_per_tick=stats["phase_ms_per_tick"],
               checkpoint_every=SERVE_CHECKPOINT_EVERY,
               checkpoints_saved=stats["checkpoints_saved"],
               group_save_s_mean=stats["group_save_s_mean"], checkpoint_bytes=ck_bytes,
               journal_append_ms_per_tick=stats["journal"]["append_ms_per_tick"],
               records_sent=sent, records_parsed=stats["records_parsed"],
               parse_records_per_s_alone=parse_rate,
               records_parsed_per_s=stats["records_parsed"] / stats["elapsed_s"],
               elapsed_s=stats["elapsed_s"],
               hbm_peak_bytes_in_use=stats["hbm_peak_bytes_in_use"],
               kernel_launches=stats["kernel_launches"]["tm_learn"],
               feed_gen_s=gen_s, card=card)
    emit("serve", **row)
    return row


def service_ids(ids: list[str]) -> list[str]:
    """Rename cluster_streams' ``node<i>.<metric>`` ids to a shape that
    ``TopologyMap.infer`` groups: ``svc<s>-<n>.<metric>``, 64 nodes per
    service (128 services at 32,768 streams)."""
    out = []
    for i, sid in enumerate(ids):
        node = int(sid.split(".", 1)[0][4:])
        out.append(f"svc{node // 64:03d}-{node % 64:02d}.{sid.split('.', 1)[1]}")
    assert len(set(out)) == len(out)
    return out


def phase_serve_model_side(seed: int, card: str, serve_row: dict) -> dict:
    """Phase 6's serve with --health, --predict and --topology infer, no
    checkpoint dir; its latency and per-phase ms beside phase 6's."""
    work = tempfile.mkdtemp(prefix="rtap-serve-ms-")
    # anchored at wall-clock time plus a margin: a fed ts in the past would
    # be clamped up to the wall clock and freeze the correlation clock
    ids, ticks, gen_s = _serve_feed(seed, ts0=int(time.time()) + 3600)
    ids = service_ids(ids)
    for records in ticks:
        for r, sid in zip(records, ids):
            r["id"] = sid
    try:
        stats, sent, err = _serve_child(ids, ticks, work,
                                        ["--health", "--predict", "--topology", "infer"])
        epoch_file = os.path.join(work, "alerts.jsonl.epoch")
        epoch = json.loads(open(epoch_file).read())["epoch"] if os.path.exists(epoch_file) else None
        events: dict = {}
        missed = []  # (tick, seconds) of each missed deadline
        for line in open(os.path.join(work, "alerts.jsonl")):
            if line.startswith('{"event"'):
                ev = json.loads(line)
                events[ev["event"]] = events.get(ev["event"], 0) + 1
                if ev["event"] == "missed_tick":
                    missed.append((ev["tick"], ev["elapsed_s"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    groups = SERVE_STREAMS // SERVE_GROUP
    health, predict = stats.get("health", {}), stats.get("predict", {})
    ewma_max = predict.get("miss_ewma_max")
    checks = {
        "ticks": stats["ticks"] == SERVE_TICKS,
        "scored": stats["scored"] == SERVE_TICKS * SERVE_STREAMS,
        "missing_values": stats["missing_values"] == SERVE_STREAMS,
        "records_parsed": stats["records_parsed"] == sent == (SERVE_TICKS - 1) * SERVE_STREAMS,
        "kernel_launches": stats["kernel_launches"]["tm_learn"] == groups * SERVE_TICKS,
        "health_folds": health.get("groups") == groups
                        and health.get("ticks_folded") == groups * SERVE_TICKS,
        # the predictor folds every group tick of every group
        "predict_folds": predict.get("groups") == groups
                         and predict.get("ticks_folded") == groups * SERVE_TICKS,
        # streams scored from tick k on: the fleet's worst EWMA is a number
        "miss_ewma_finite": ewma_max is not None and 0.0 <= ewma_max <= 1.0,
        "incidents_stats": "incidents" in stats,
        "run_epoch": epoch == 1,
        "armed": all(a in err for a in ("model-health reducers armed",
                                        "predictive horizon armed (k=8 ticks",
                                        "incident correlation armed (inferred")),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serve --health --predict --topology checks failed {bad}: "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }")
    row = dict(streams=SERVE_STREAMS, group_size=SERVE_GROUP, groups=groups,
               ticks=stats["ticks"], flags=["--health", "--predict", "--topology infer"],
               scored=stats["scored"], alerts=stats["alerts"],
               latency_p50_ms=stats["latency_p50_ms"], latency_p90_ms=stats["latency_p90_ms"],
               latency_p99_ms=stats["latency_p99_ms"], latency_max_ms=stats["latency_max_ms"],
               missed_deadlines=stats["missed_deadlines"], missed_ticks=missed,
               phase_ms_per_tick=stats["phase_ms_per_tick"],
               phase6_latency_p50_ms=serve_row["latency_p50_ms"],
               phase6_latency_p99_ms=serve_row["latency_p99_ms"],
               phase6_phase_ms_per_tick=serve_row["phase_ms_per_tick"],
               health=health, predict=predict, incidents=stats["incidents"],
               events_on_stream=events, run_epoch=epoch,
               hbm_peak_bytes_in_use=stats["hbm_peak_bytes_in_use"],
               phase6_hbm_peak_bytes_in_use=serve_row["hbm_peak_bytes_in_use"],
               kernel_launches=stats["kernel_launches"]["tm_learn"], feed_gen_s=gen_s, card=card)
    emit("serve_model_side", **row)
    return row


def run_drill_child(args) -> int:
    """One serve lifetime of the kill drill (``--child``): recover the
    journal, resume the checkpoints, replay, then run the rest of the
    DRILL_TICKS budget over a seeded source keyed by the global tick."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.resilience.journal import TickJournal
    from rtap_tpu_torch.service.checkpoint import peek_resume_ticks
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    w = args.workdir
    journal = TickJournal(os.path.join(w, "journal"))
    ckdir = os.path.join(w, "ck")
    base = max(journal.next_tick, peek_resume_ticks(ckdir))
    ids = [f"n{i // 3}.m{i % 3}" for i in range(DRILL_STREAMS)]
    # threshold 0: every stream alerts every tick, so exactly-once is
    # checked on every (stream, tick)
    reg = StreamGroupRegistry(cluster_preset(), group_size=DRILL_GROUP, device="cuda",
                              threshold=0.0, debounce=1)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()

    def source(k):
        g = base + k  # the feed depends only on the GLOBAL tick
        rng = np.random.Generator(np.random.Philox(key=(args.seed, g)))
        v = (30 + 5 * rng.random(len(ids))).astype(np.float32)
        v[g % len(ids)] += 30.0
        return v, 1_700_000_000 + g

    stats = live_loop(source, reg, n_ticks=max(0, DRILL_TICKS - base), cadence_s=0.0,
                      alert_path=os.path.join(w, "alerts.jsonl"), checkpoint_dir=ckdir,
                      checkpoint_every=DRILL_CHECKPOINT_EVERY, pipeline_depth=2,
                      journal=journal)
    journal.close()
    print(json.dumps({"base": base, "ran": stats["ticks"], "alerts": stats["alerts"],
                      "kernel_launches": stats["kernel_launches"]["tm_learn"],
                      "group_save_s_mean": stats.get("group_save_s_mean"),
                      "checkpoints_saved": stats["checkpoints_saved"],
                      "phase_ms_per_tick": stats.get("phase_ms_per_tick"),
                      "journal": stats["journal"]}), flush=True)
    return 0


def _drill_records(path: str) -> tuple[dict, list, int]:
    """Alert lines by alert_id, duplicated ids, torn fragments."""
    by_id, dup, torn = {}, [], 0
    with open(path) as f:
        for line in f:
            if line.startswith('{"event"'):
                continue
            try:
                aid = json.loads(line)["alert_id"]
            except (ValueError, KeyError):
                torn += 1
                continue
            if aid in by_id:
                dup.append(aid)
            by_id[aid] = line
    return by_id, dup, torn


def _drill_checkpoints(ckdir: str) -> dict:
    from rtap_tpu_torch.service.checkpoint import _read_tree

    out = {}
    for name in sorted(os.listdir(ckdir)):
        if name.startswith("group"):
            meta = json.loads(open(os.path.join(ckdir, name, "meta.json")).read())
            out[name] = (meta["ticks"], _read_tree(Path(ckdir, name, "state")))
    return out


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def phase_kill_drill(seed: int, card: str) -> dict:
    root = tempfile.mkdtemp(prefix="rtap-drill-")
    children: list[subprocess.Popen] = []
    try:
        return _kill_drill(root, children, seed, card)
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


def _kill_drill(root: str, children: list, seed: int, card: str) -> dict:
    from rtap_tpu_torch.resilience.journal import last_journal_tick

    me = os.path.abspath(__file__)

    def child(work):
        children.append(subprocess.Popen([sys.executable, me, "--child", "--workdir", work,
                                          "--seed", str(seed)], stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True))
        return children[-1]

    t0 = time.perf_counter()
    ref, crash = os.path.join(root, "ref"), os.path.join(root, "crash")
    p = child(ref)
    out, err = p.communicate(timeout=900)
    if p.returncode != 0:
        raise AssertionError(f"fault-free drill child exited {p.returncode}:\n{err[-3000:]}")
    ref_stats = json.loads(out.strip().splitlines()[-1])
    ref_s = time.perf_counter() - t0
    kills, lives = [], []
    targets = list(DRILL_KILLS)
    while True:
        p = child(crash)
        kill = None
        if targets:
            target = targets.pop(0)
            deadline = time.monotonic() + 600
            while p.poll() is None and time.monotonic() < deadline:
                seen = last_journal_tick(os.path.join(crash, "journal"))
                if seen >= target:
                    p.send_signal(signal.SIGKILL)  # no cleanup, no flush
                    kill = {"target": target, "journal_tick": seen}
                    break
                time.sleep(0.005)
        out, err = p.communicate(timeout=900)
        lives.append(p.returncode)
        if kill is not None:
            kill["rc"] = p.returncode
            kills.append(kill)
            continue
        if p.returncode != 0:
            raise AssertionError(f"drill child exited {p.returncode}:\n{err[-3000:]}")
        last_stats = json.loads(out.strip().splitlines()[-1])
        break
    failures = []
    if len(kills) != len(DRILL_KILLS) or any(k.get("rc") != -signal.SIGKILL for k in kills):
        failures.append(f"kills did not all land with rc -9: {kills}")
    groups = DRILL_STREAMS // DRILL_GROUP
    if ref_stats["kernel_launches"] != groups * DRILL_TICKS:
        failures.append(f"fault-free launches {ref_stats['kernel_launches']} != "
                        f"{groups} groups x {DRILL_TICKS} learning ticks")
    want, ref_dup, _ = _drill_records(os.path.join(ref, "alerts.jsonl"))
    got, dup, torn = _drill_records(os.path.join(crash, "alerts.jsonl"))
    if ref_dup or dup:
        failures.append(f"duplicated alert ids: {len(dup)} (fault-free {len(ref_dup)})")
    if got.keys() != want.keys():
        failures.append(f"alert ids differ: {len(want.keys() - got.keys())} lost, "
                        f"{len(got.keys() - want.keys())} extra")
    elif any(got[k] != want[k] for k in want):
        failures.append("alert record bytes differ from the fault-free run")
    if len(want) != DRILL_STREAMS * DRILL_TICKS:
        failures.append(f"fault-free run has {len(want)} alert ids, expected "
                        f"{DRILL_STREAMS * DRILL_TICKS}")
    ref_ck, got_ck = _drill_checkpoints(os.path.join(ref, "ck")), \
        _drill_checkpoints(os.path.join(crash, "ck"))
    leaves = 0
    if ref_ck.keys() != got_ck.keys():
        failures.append(f"checkpoint groups differ: {sorted(ref_ck)} vs {sorted(got_ck)}")
    for name in sorted(ref_ck.keys() & got_ck.keys()):
        (rt, rtree), (gt, gtree) = ref_ck[name], got_ck[name]
        if rt != gt or rt != DRILL_TICKS:
            failures.append(f"{name}: final ticks {gt} vs fault-free {rt}")
        rl, gl = dict(_flat(rtree)), dict(_flat(gtree))
        if rl.keys() != gl.keys():
            failures.append(f"{name}: state leaves differ")
            continue
        for k in rl:
            leaves += 1
            a, b = rl[k], gl[k]
            if a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
                failures.append(f"{name}/{k}: diverges from the fault-free run")
    if failures:
        raise AssertionError(f"kill drill failed: {failures}")
    row = dict(streams=DRILL_STREAMS, groups=groups, ticks=DRILL_TICKS,
               checkpoint_every=DRILL_CHECKPOINT_EVERY, kills=kills, lifetimes=len(lives),
               alert_ids=len(want), duplicated=0, lost=0, torn_fragments=torn,
               state_leaves_equal=leaves, fault_free_kernel_launches=ref_stats["kernel_launches"],
               group_save_s_mean=ref_stats["group_save_s_mean"],
               fault_free_phase_ms_per_tick=ref_stats["phase_ms_per_tick"],
               fault_free_s=ref_s, last_life=last_stats, seconds=time.perf_counter() - t0,
               card=card)
    emit("kill_drill", **row)
    return row


def phase_flags_on_off(seed: int, card: str) -> dict:
    """The drill's shape (2 groups of 1,024, 96 ticks at cadence 0, every
    stream alerting every tick) through live_loop on the card twice: with
    --health and --predict 8 (trackers on) and without. Then one learning
    tick of a 64-stream slice of the flags-on state with both reducers on
    the card and on the CPU."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.obs.health import HealthTracker
    from rtap_tpu_torch.obs.metrics import TelemetryRegistry
    from rtap_tpu_torch.ops.step import chunk_step
    from rtap_tpu_torch.predict import PredictTracker
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    cfg = cluster_preset()
    ids = [f"n{i // 3}.m{i % 3}" for i in range(DRILL_STREAMS)]

    def source(k):
        rng = np.random.Generator(np.random.Philox(key=(seed, k)))
        v = (30 + 5 * rng.random(len(ids))).astype(np.float32)
        v[k % len(ids)] += 30.0
        return v, 1_700_000_000 + k

    work = tempfile.mkdtemp(prefix="rtap-onoff-")
    runs = {}
    try:
        for name, on in (("on", True), ("off", False)):
            reg = StreamGroupRegistry(cfg, group_size=DRILL_GROUP, device="cuda", threshold=0.0,
                                      debounce=1, health=on, predict=8 if on else 0)
            for sid in ids:
                reg.add_stream(sid)
            reg.finalize()
            trackers = dict(health=HealthTracker(cfg, registry=TelemetryRegistry()),
                            predictor=PredictTracker(8, registry=TelemetryRegistry())) if on else {}
            path = os.path.join(work, f"{name}.jsonl")
            tl.reset_launches()
            t0 = time.perf_counter()
            stats = live_loop(source, reg, n_ticks=DRILL_TICKS, cadence_s=0.0, alert_path=path,
                              pipeline_depth=2, **trackers)
            torch.cuda.synchronize()
            runs[name] = dict(reg=reg, stats=stats, launches=tl.launches,
                              seconds=time.perf_counter() - t0,
                              lines=[ln for ln in open(path) if not ln.startswith('{"event"')])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    on, off = runs["on"], runs["off"]
    pred_leaves = {"pred_ring", "pred_miss_ewma", "pred_tick0"}
    leaf_diff, compared = [], 0
    for gon, goff in zip(on["reg"].groups, off["reg"].groups):
        son, soff = state_to_numpy(gon.state), state_to_numpy(goff.state)
        if set(son) - set(soff) != pred_leaves:
            leaf_diff.append(f"leaf sets differ: {sorted(set(son) ^ set(soff))}")
        for k in soff:
            compared += 1
            if not np.array_equal(son[k], soff[k], equal_nan=True):
                leaf_diff.append(k)

    def raws(lines):
        return np.array([json.loads(ln)["raw_score"] for ln in lines], np.float32)

    scored = [g.last_predict["scored"] for g in on["reg"].groups]
    ewma = [g.last_predict["miss_ewma"] for g in on["reg"].groups]
    checks = {
        "model_leaves_equal": not leaf_diff,
        "alert_lines_equal": on["lines"] == off["lines"],
        "alert_lines": len(on["lines"]) == DRILL_STREAMS * DRILL_TICKS,
        "raw_bits_equal": np.array_equal(raws(on["lines"]).view(np.uint32),
                                         raws(off["lines"]).view(np.uint32)),
        "launches": on["launches"] == off["launches"] == 2 * DRILL_TICKS,
        "health_folds": on["stats"]["health"]["ticks_folded"] == 2 * DRILL_TICKS,
        "predict_folds": on["stats"]["predict"]["ticks_folded"] == 2 * DRILL_TICKS,
        # every stream scores past the horizon; each scored EWMA is a number
        "scored_all": all(s[-1].all() for s in scored),
        "miss_ewma_finite": all(np.isfinite(e[s]).all() for e, s in zip(ewma, scored)),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"flags on vs off failed {bad}; leaves {leaf_diff[:8]}")

    # one learning tick of a 64-stream slice: card vs CPU
    grp = on["reg"].groups[0]
    n = 64
    sub = {k: v[:n].contiguous() for k, v in grp.state.items()}
    vals, ts = source(DRILL_TICKS)
    v1 = torch.from_numpy(vals[:n].reshape(1, n, 1))
    t1 = torch.full((1, n), ts, dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        st = {k: x.to(dev).clone() for k, x in sub.items()}
        st, ((raw, hleaf), pleaf) = chunk_step(st, v1.to(dev), t1.to(dev), cfg,
                                               tick0=grp._tick0, health=True, predict=True)
        out[dev] = (raw.cpu().numpy(), {k: x.cpu().numpy() for k, x in hleaf.items()},
                    {k: x.cpu().numpy() for k, x in pleaf.items()}, state_to_numpy(st))
    (rc, hc, pc, sc), (rp, hp, pp, sp) = out["cuda"], out["cpu"]
    health_err = {}
    for k in hp:
        if hp[k].dtype.kind == "i":
            if not np.array_equal(hc[k], hp[k]):
                raise AssertionError(f"health leaf {k} differs between card and CPU")
        else:
            np.testing.assert_allclose(hc[k], hp[k], rtol=1e-5, atol=1e-6, err_msg=k)
            health_err[k] = float(np.abs(hc[k].astype(np.float64) - hp[k]).max())
    pred_bad = [k for k in pp if not np.array_equal(pc[k], pp[k], equal_nan=True)]
    state_bad = [k for k in sp if not np.array_equal(sc[k], sp[k], equal_nan=True)]
    if pred_bad or state_bad or not np.array_equal(rc, rp):
        raise AssertionError(f"card vs CPU: predict leaves {pred_bad}, state {state_bad}, "
                             f"raw equal {np.array_equal(rc, rp)}")
    row = dict(streams=DRILL_STREAMS, groups=2, ticks=DRILL_TICKS, horizon=8,
               model_leaves_compared=compared, alert_lines=len(on["lines"]),
               launches_on=on["launches"], launches_off=off["launches"],
               seconds_on=on["seconds"], seconds_off=off["seconds"],
               phase_ms_per_tick_on=on["stats"]["phase_ms_per_tick"],
               phase_ms_per_tick_off=off["stats"]["phase_ms_per_tick"],
               health=on["stats"]["health"], predict=on["stats"]["predict"],
               card_vs_cpu=dict(streams=n, tick=grp._tick0, predict_leaves_bit_equal=True,
                                state_bit_equal=True, raw_bit_equal=True,
                                health_ints_exact=True, health_float_max_abs_err=health_err),
               card=card)
    emit("flags_on_vs_off", **row)
    return row


def _eval_cmd(device: str, *extra: str) -> list[str]:
    return [sys.executable, "-m", "rtap_tpu_torch.predict_eval", "--device", device, *extra]


def _event_ids(path: str) -> list[str]:
    """precursor / predicted_incident / incident ids on an alert stream."""
    ids = []
    for line in open(path):
        if line.startswith('{"event"'):
            ev = json.loads(line)
            if ev["event"] in ("precursor", "predicted_incident"):
                ids.append(ev["alert_id"])
            elif ev["event"] == "incident":
                ids.append(ev["incident_id"])
    return ids


def phase_cascade(card: str) -> dict:
    """``python -m rtap_tpu_torch.predict_eval`` at the JAX script's defaults
    on the card and on this machine's CPU (same page tick and first-precursor
    ticks), then on the card as a restartable serve (``--workdir``) killed
    with SIGKILL after its first precursor and resumed from its checkpoint
    and journal: every event id once, the page tick unchanged."""
    root = Path(os.path.dirname(os.path.abspath(__file__)))
    work = tempfile.mkdtemp(prefix="rtap-cascade-")
    procs: list[subprocess.Popen] = []

    def start(cmd):
        procs.append(subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        return procs[-1]

    def finish(p, ok=(0,)):
        out, err = p.communicate(timeout=900)
        if p.returncode not in ok:
            raise AssertionError(f"predict_eval exited {p.returncode}:\n{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1]) if out.strip() else None

    t0 = time.perf_counter()
    try:
        # one after the other: the CPU run's threads would slow the card run's host
        card_res = finish(start(_eval_cmd("cuda")))
        cuda_s = time.perf_counter() - t0
        cpu_res = finish(start(_eval_cmd("cpu")))
        score, cpu_score = card_res["score"], cpu_res["score"]
        checks = {
            "verified": card_res["verified"] and score["win"] and score["blast_covered"]
                        and score["false_precursors"] == 0,
            "device": card_res["device"].startswith("cuda") and cpu_res["device"] == "cpu",
            "page_tick_as_cpu": score["page_tick"] == cpu_score["page_tick"],
            "first_precursors_as_cpu": score["first_precursor_by_node"]
                                       == cpu_score["first_precursor_by_node"],
            "blast_as_cpu": score["predicted_incident"] == cpu_score["predicted_incident"],
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"cascade eval failed {bad}: card {score} cpu {cpu_score}")

        # the kill drill: SIGKILL after the first precursor reaches the stream
        wd = os.path.join(work, "w")
        alerts = os.path.join(wd, "alerts.jsonl")
        cmd = _eval_cmd("cuda", "--workdir", wd, "--cadence", "0.02")
        p = start(cmd)
        kill, seen, pos = None, "", 0
        deadline = time.monotonic() + 600
        while p.poll() is None and time.monotonic() < deadline:
            if os.path.exists(alerts):
                with open(alerts) as f:
                    f.seek(pos)
                    chunk = f.read()
                pos += len(chunk.encode())
                seen = (seen + chunk)[-4096:]
                if '{"event": "precursor"' in seen:
                    p.send_signal(signal.SIGKILL)  # no cleanup, no flush
                    kill = {"events_before": len(_event_ids(alerts))}
                    break
            time.sleep(0.005)
        p.communicate(timeout=900)
        if kill is None:
            raise AssertionError(f"the first precursor never reached the stream (rc {p.returncode})")
        kill["rc"] = p.returncode
        final = finish(start(cmd))
        ids = _event_ids(alerts)
        dup = sorted({i for i in ids if ids.count(i) > 1})
        fscore = final["score"]
        checks = {
            "killed": kill["rc"] == -signal.SIGKILL,
            "resumed": final["resumed_at_tick"] > 0,
            "event_ids_once": not dup,
            "page_tick_unchanged": fscore["page_tick"] == score["page_tick"],
            "blast_unchanged": fscore["predicted_incident"] == score["predicted_incident"],
            "verified": final["verified"],
            "incident_lines": any(i.startswith("inc-") for i in ids),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"cascade kill drill failed {bad}: kill {kill}, duplicated "
                                 f"{dup[:5]}, final {fscore}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    row = dict(scenario=card_res["scenario"], predictor=card_res["predictor"], score=score,
               card_elapsed_s=card_res["elapsed_s"], cpu_elapsed_s=cpu_res["elapsed_s"],
               card_wall_s=cuda_s, page_tick_equal_cpu=True, first_precursors_equal_cpu=True,
               kill=kill, resumed_at_tick=final["resumed_at_tick"], event_ids=len(ids),
               event_ids_duplicated=0, final_score=fscore, incidents=final.get("incidents"),
               seconds=time.perf_counter() - t0, card=card)
    emit("cascade", **row)
    return row

def _nab_run(device: str, work: str, tag: str, *extra: str) -> tuple[dict, dict]:
    """`python -m rtap_tpu_torch nab` on data/nab as a child -> (its report,
    its per-row detections by key)."""
    out, det = os.path.join(work, f"{tag}.json"), os.path.join(work, f"{tag}.npz")
    cmd = [sys.executable, "-m", "rtap_tpu_torch", "nab", "--device", device,
           "--out", out, "--detections", det, *extra]
    p = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=1200)
    if p.returncode != 0:
        raise AssertionError(f"nab {tag} exited {p.returncode}:\n{p.stderr[-3000:]}")
    with open(out) as f:
        rep = json.load(f)
    with np.load(det) as z:
        return rep, {k: z[k] for k in z.files}


def _nab_same(a: tuple[dict, dict], b: tuple[dict, dict]) -> dict:
    """Two nab runs of one corpus: raw equal, loglik within 1e-12, the exact
    scores equal -> the largest loglik difference, or raise."""
    (ra, da), (rb, db) = a, b
    if sorted(da) != sorted(db):
        raise AssertionError(f"detections differ in keys: {sorted(set(da) ^ set(db))}")
    raw_bad = [k for k in da if k.startswith("raw/") and not np.array_equal(da[k], db[k])]
    ll_err = max(float(np.abs(da[k] - db[k]).max()) for k in da if k.startswith("loglik/"))
    if raw_bad or ll_err > 1e-12 or ra["scores_exact"] != rb["scores_exact"]:
        raise AssertionError(f"card vs CPU: raw differs in {raw_bad}, loglik max error "
                             f"{ll_err}, scores {ra['scores_exact']} vs {rb['scores_exact']}")
    return dict(files=len(ra["files"]), records=ra["records"], raw_equal=True,
                loglik_max_abs_err=ll_err, scores_equal=True, scores=ra["scores_exact"],
                card_wall_s=ra["wall_s_exact"], cpu_wall_s=rb["wall_s_exact"])


def phase_nab_corpus(card: str) -> tuple[dict, dict]:
    """`nab` over the whole stand-in corpus on the card (8 files in one
    group, nab_preset); the kernel against its plain version on the group's
    final state; then card == CPU on a prefix -> (row, kernel row)."""
    from rtap_tpu_torch.data.nab_corpus import load_corpus
    from rtap_tpu_torch.ops.step import next_learn_pass
    from rtap_tpu_torch.service.checkpoint import load_group

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="rtap-nab-")
    try:
        t0 = time.perf_counter()
        rep, det = _nab_run("cuda", work, "card", "--save-group", os.path.join(work, "grp"))
        run_s = time.perf_counter() - t0
        # the kernel after NAB_ROWS learning ticks at the corpus group's shape
        grp = load_group(os.path.join(work, "grp"), device="cuda")
        files = load_corpus(os.path.join(here, "data", "nab"))
        values = torch.from_numpy(np.array([[f.values[-1]] for f in files], np.float32)).cuda()
        ts = torch.from_numpy(np.array([f.timestamps[-1] + 300 for f in files], np.int32)).cuda()
        lp = next_learn_pass(grp.cfg, grp.state, values, ts)
        del grp
        krow = compare_pass("nab_corpus_group_final", lp, kernel_reps=20, plain_reps=3)
        krow.update(learning_ticks_before=NAB_ROWS, card=card)
        emit("kernel_vs_plain", **krow)
        del lp
        torch.cuda.empty_cache()
        # card == CPU on a prefix of one file, at full width
        extra = ("--rows", str(NAB_CPU_ROWS), "--subset", NAB_CPU_SUBSET)
        prefix = dict(args=list(extra), **_nab_same(_nab_run("cuda", work, "prefix_card", *extra),
                                                    _nab_run("cpu", work, "prefix_cpu", *extra)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    scores = {k: v["score"] for k, v in rep["scores_exact"].items()}
    finite = all(np.isfinite(v).all() for k, v in det.items())
    checks = {
        "records": rep["records"] == NAB_RECORDS and len(rep["files"]) == 8,
        "floors": all(scores[k] >= v for k, v in NAB_FLOORS.items()),
        "finite": finite and len(det) == 16,
        "kernel_launches": rep["kernel_launches"]["tm_learn"] == NAB_ROWS,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"nab corpus checks failed {bad}: {rep}")
    with open(os.path.join(here, "reports", "nab_standin.json")) as f:
        standin = json.load(f)  # a TPU run of the JAX package: quality only
    row = dict(preset="nab_preset", files=len(rep["files"]), records=rep["records"],
               group_size=len(rep["files"]), learning_ticks=NAB_ROWS,
               wall_s=rep["wall_s_exact"], records_per_s=rep["records"] / rep["wall_s_exact"],
               child_s=run_s, kernel_launches=rep["kernel_launches"]["tm_learn"],
               kernel_ms_per_launch=krow["kernel_ms"], kernel_bound_ms=krow["bound_ms"],
               kernel_bound_full_ms=krow["bound_full_ms"],
               max_memory_allocated=rep.get("max_memory_allocated"),
               scores=scores, thresholds={k: v["threshold"] for k, v in rep["scores_exact"].items()},
               floors=NAB_FLOORS,
               reference_scores_tpu_run={k: v["score"] for k, v in standin["scores"].items()},
               card_vs_cpu=prefix, card=card)
    emit("nab_corpus", **row)
    return row, krow


def golden_config():
    """The model of tests/golden/golden_config1.npz, in the port's terms."""
    from rtap_tpu_torch.config import (DateConfig, LikelihoodConfig, ModelConfig,
                                       RDSEConfig, SPConfig, TMConfig)

    return ModelConfig(
        rdse=RDSEConfig(size=200, active_bits=11, resolution=0.9),
        date=DateConfig(time_of_day_width=11, time_of_day_size=32),
        sp=SPConfig(columns=512, num_active_columns=20),
        tm=TMConfig(cells_per_column=8, activation_threshold=9, min_threshold=6,
                    max_segments_per_cell=8, max_synapses_per_segment=16,
                    new_synapse_count=12),
        likelihood=LikelihoodConfig(learning_period=60, estimation_samples=30,
                                    reestimation_period=20, averaging_window=5),
    )


def phase_golden(card: str) -> dict:
    """AnomalyDetector on the card over golden_config1's stream (the
    stand-in file ...5f5533, 400 rows): raw equal to the golden, loglik
    within 1e-12; saved at row 200, loaded and continued: the same rows."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.data.nab_corpus import load_corpus
    from rtap_tpu_torch.models import AnomalyDetector, HTMModel

    here = os.path.dirname(os.path.abspath(__file__))
    nf = next(f for f in load_corpus(os.path.join(here, "data", "nab")) if "5f5533" in f.name)
    golden = np.load(os.path.join(here, "tests", "golden", "golden_config1.npz"))

    def run(model, lo, hi):
        out = [model.run(int(nf.timestamps[i]), float(nf.values[i])) for i in range(lo, hi)]
        return np.array([r.raw_score for r in out]), np.array([r.log_likelihood for r in out])

    det = AnomalyDetector(golden_config(), seed=0, device="cuda")
    tl.reset_launches()
    t0 = time.perf_counter()
    raw, loglik = run(det.model, 0, GOLDEN_ROWS)
    seconds = time.perf_counter() - t0
    launches = tl.launches
    ll_err = float(np.abs(loglik - golden["loglik"]).max())
    work = tempfile.mkdtemp(prefix="rtap-golden-")
    try:
        first = AnomalyDetector(golden_config(), seed=0, device="cuda").model
        run(first, 0, GOLDEN_SAVE_AT)
        path = os.path.join(work, "model.npz")
        first.save(path)
        resumed = HTMModel.load(path, device="cuda")
        raw2, ll2 = run(resumed, GOLDEN_SAVE_AT, GOLDEN_ROWS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    checks = {
        "raw_equal": np.array_equal(raw, golden["raw"]),
        "loglik_1e-12": ll_err <= 1e-12,
        "launches": launches == GOLDEN_ROWS,
        "resumed_raw_equal": np.array_equal(raw2, raw[GOLDEN_SAVE_AT:]),
        "resumed_loglik_equal": np.array_equal(ll2, loglik[GOLDEN_SAVE_AT:]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        where = np.nonzero(raw != golden["raw"])[0]
        raise AssertionError(f"golden on the card failed {bad}: first raw mismatch at "
                             f"{where[:5]}, loglik max error {ll_err}")
    row = dict(golden="tests/golden/golden_config1.npz", rows=GOLDEN_ROWS, raw_equal=True,
               loglik_max_abs_err=ll_err, kernel_launches=launches, seconds=seconds,
               ms_per_record=seconds / GOLDEN_ROWS * 1e3, saved_at=GOLDEN_SAVE_AT,
               resumed_equal=True, card=card)
    emit("htm_model_golden", **row)
    return row


def phase_classifier(seed: int, card: str) -> dict:
    """cluster_preset with the SDR classifier at G = 64 over 64 learning
    ticks on the card and on the CPU: raw, every other leaf and cls_cnt bit
    for bit, cls_w at rtol 1e-5 / atol 1e-6, predictions and probabilities
    within 1e-4."""
    import dataclasses

    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.config import ClassifierConfig, cluster_preset
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.models.state import init_state, state_nbytes, state_to_numpy
    from rtap_tpu_torch.ops.step import chunk_step, replicate_state_device

    cfg = dataclasses.replace(cluster_preset(), classifier=ClassifierConfig(enabled=True))
    streams = cluster_streams(CLS_STREAMS, CLS_TICKS, seed + 2, n_anomalies=0)
    vals = torch.from_numpy(np.stack([s.values for s in streams], 1)[:, :, None])
    ts = torch.from_numpy(np.stack([s.timestamps for s in streams], 1).astype(np.int32))
    out = {}
    for dev in ("cuda", "cpu"):
        st = replicate_state_device(init_state(cfg, seed), CLS_STREAMS, dev)
        tl.reset_launches()
        t0 = time.perf_counter()
        st, (raw, pred, prob) = chunk_step(st, vals.to(dev), ts.to(dev), cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = dict(raw=raw.cpu().numpy(), pred=pred.cpu().numpy(), prob=prob.cpu().numpy(),
                        state=state_to_numpy(st), launches=tl.launches,
                        seconds=time.perf_counter() - t0)
    c, p = out["cuda"], out["cpu"]
    leaf_bad = [k for k in p["state"] if k not in ("cls_w", "cls_val")
                and not np.array_equal(c["state"][k], p["state"][k], equal_nan=True)]
    errs = {k: float(np.abs(c[k].astype(np.float64) - p[k]).max()) for k in ("pred", "prob")}
    for k in ("cls_w", "cls_val"):
        errs[k] = float(np.abs(c["state"][k].astype(np.float64) - p["state"][k]).max())
    cls_ok = all(np.allclose(c["state"][k], p["state"][k], rtol=1e-5, atol=1e-6)
                 for k in ("cls_w", "cls_val"))
    checks = {
        "raw_equal": np.array_equal(c["raw"], p["raw"]),
        "leaves_equal": not leaf_bad,
        "cls_w": cls_ok,
        "pred_prob_1e-4": errs["pred"] <= 1e-4 and errs["prob"] <= 1e-4,
        "launches": c["launches"] == CLS_TICKS,
        "finite": np.isfinite(c["pred"]).all() and np.isfinite(c["prob"]).all(),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"classifier card vs CPU failed {bad}: leaves {leaf_bad}, {errs}")
    row = dict(preset="cluster_preset + classifier", buckets=cfg.classifier.buckets,
               streams=CLS_STREAMS, ticks=CLS_TICKS,
               state_bytes_per_stream=state_nbytes(cfg)["total"],
               classifier_bytes_per_stream=sum(v for k, v in state_nbytes(cfg).items()
                                               if k.startswith("cls_")),
               leaves_bit_equal=len(p["state"]) - 2, max_abs_err=errs,
               kernel_launches=c["launches"], card_s=c["seconds"], cpu_s=p["seconds"],
               card=card)
    emit("classifier", **row)
    return row


def phase_serve_presets(seed: int, card: str) -> dict:
    """`serve --preset nab|composite|categorical` on the card, fed by the
    tick-gated TCP feeder at 1 s cadence -> {preset: row}."""
    rows = {}
    for preset, n_streams, group, n_ticks in PRESET_SERVES:
        # the categorical preset reads the wire value as a category id
        value = (lambda v: float(np.floor(v / 9.0))) if preset == "categorical" else float
        ids, ticks, gen_s = _serve_feed(seed, n_streams=n_streams, n_ticks=n_ticks,
                                        value=value)
        work = tempfile.mkdtemp(prefix=f"rtap-serve-{preset}-")
        try:
            stats, sent, _ = _serve_child(ids, ticks, work, ["--preset", preset],
                                          group=group, n_ticks=n_ticks)
            missed, alert_lines, events, malformed = [], 0, {}, 0
            for line in open(os.path.join(work, "alerts.jsonl")):
                try:
                    rec = json.loads(line)
                except ValueError:
                    malformed += 1
                    continue
                if "event" in rec:
                    events[rec["event"]] = events.get(rec["event"], 0) + 1
                    if rec["event"] == "missed_tick":
                        missed.append((rec["tick"], rec["elapsed_s"]))
                elif {"alert_id", "raw_score"} <= rec.keys():
                    alert_lines += 1
                else:
                    malformed += 1
        finally:
            shutil.rmtree(work, ignore_errors=True)
        groups = -(-n_streams // group)
        checks = {
            "preset": stats.get("preset") == preset,
            "ticks": stats["ticks"] == n_ticks,
            "scored": stats["scored"] == n_ticks * n_streams,
            # only tick 0, polled before the first push, lacks values
            "missing_values": stats["missing_values"] == n_streams,
            "records_parsed": stats["records_parsed"] == sent == (n_ticks - 1) * n_streams,
            "parse_errors": stats["parse_errors"] == 0 and stats["unknown_ids"] == 0,
            "tm_overflow_total": stats["tm_overflow_total"] == 0,
            "under_1s_after_tick_0": all(t == 0 for t, _ in missed),
            "alert_lines_well_formed": malformed == 0,
            "kernel_launches": stats["kernel_launches"]["tm_learn"] == groups * n_ticks,
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"serve --preset {preset} checks failed {bad}: missed {missed}, "
                                 f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }")
        rows[preset] = dict(preset=preset, streams=n_streams, group_size=group, groups=groups,
                            ticks=stats["ticks"], scored=stats["scored"],
                            missing_values=stats["missing_values"], alerts=alert_lines,
                            events_on_stream=events,
                            latency_p50_ms=stats["latency_p50_ms"],
                            latency_p99_ms=stats["latency_p99_ms"],
                            latency_max_ms=stats["latency_max_ms"],
                            missed_deadlines=stats["missed_deadlines"], missed_ticks=missed,
                            phase_ms_per_tick=stats["phase_ms_per_tick"],
                            hbm_peak_bytes_in_use=stats["hbm_peak_bytes_in_use"],
                            kernel_launches=stats["kernel_launches"]["tm_learn"],
                            feed_gen_s=gen_s, card=card)
        emit("serve_preset", **rows[preset])
    return rows


def _in_process(fn, argv: list[str]) -> tuple[float, int]:
    """An entry point's ``main(argv)`` in this process, its stdout (the
    report) kept off this script's -> (seconds, TM learning-kernel launches
    from 0); raises unless it returns 0."""
    import contextlib
    import io

    import rtap_tpu_torch.ops.tm_learn as tl

    buf = io.StringIO()
    tl.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"{getattr(fn, '__module__', fn)} {argv} returned {rc}")
    return time.perf_counter() - t0, tl.launches


def _learning_ticks(cfg, T: int) -> int:
    """Ticks of a T-tick replay on which the TM learns (one kernel launch
    per group each)."""
    return sum(bool(cfg.learns_on(t)) for t in range(T)) if cfg.cadence_active else T


def _below(rep: dict, floors: dict, max_latency_s: float | None = None) -> list[str]:
    """Each `floors` entry {operating point: {metric: floor}} the report is
    under, and an at_best median latency above `max_latency_s`."""
    bad = [f"{op}.{k} {rep[op][k]} < {v}" for op, fl in floors.items()
           for k, v in fl.items() if rep[op][k] < v]
    lat = rep["at_best"]["median_latency_s"]
    if max_latency_s is not None and (lat is None or lat > max_latency_s):
        bad.append(f"at_best.median_latency_s {lat} > {max_latency_s}")
    return bad


def _per_kind_below(rep: dict) -> list[str]:
    """test_fault_eval.py::test_per_kind_recall_and_lead: each kind covered
    by 10 events, recall 0.70, alerts before its window closes."""
    return [f"per_kind {kind} {v}" for kind, v in rep["per_kind"].items()
            if v["events"] < 10 or v["recall"] < 0.70 or not (v["median_lead_s"] or 0) > 0]


def _strip_wall_clock(rep):
    """A report with every throughput's wall-clock entries dropped."""
    if isinstance(rep, dict):
        return {k: ({kk: vv for kk, vv in v.items() if kk not in WALL_CLOCK}
                    if k == "throughput" else _strip_wall_clock(v)) for k, v in rep.items()}
    return rep


def _event_counts(streams) -> dict:
    """Injected fault events by kind, counted from the generator's streams."""
    out: dict = {}
    for s in streams:
        for ev in s.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
    return out


def phase_eval(card: str, work: str) -> dict:
    """``python -m rtap_tpu_torch eval`` (its main, in this process) on the
    card: (a) tests/integration/test_fault_eval.py's fixture shape and floors,
    (b) card == CPU at 12 streams, (c) the committed artifacts' shape, their
    event counts a gate, (d) BASELINE config 3's 1,000 streams."""
    from rtap_tpu_torch.__main__ import main as cli
    from rtap_tpu_torch.eval.fault_eval import eval_config, fault_streams

    here = os.path.dirname(os.path.abspath(__file__))

    def run(tag, streams, length, *flags, device="cuda"):
        out = os.path.join(work, f"eval_{tag}.json")
        secs, launches = _in_process(cli, ["eval", "--device", device, "--streams", str(streams),
                                           "--length", str(length), "--out", out, *flags])
        with open(out) as f:
            return json.load(f), secs, launches, out

    def headline(rep):
        b = rep["at_best"]
        return dict(f1=b["f1"], precision=b["precision"], recall=b["recall"],
                    best_threshold=rep["best_threshold"], best_debounce=rep["best_debounce"],
                    tm_overflow_total=rep["throughput"]["tm_overflow_total"])

    row: dict = {}
    launches_by = {"eval_fixture": 0, "eval_artifact": 0}
    # (a) the fixture: 40 x 1,000, window and streaming, and k = 2
    streams, length = EVAL_FIXTURE
    fixture, failed = {}, {}
    for tag, mode, k, floors in (("window", "window", 1, WINDOW_FLOORS),
                                 ("streaming", "streaming", 1, STREAMING_FLOORS),
                                 ("streaming_k2", "streaming", 2, K2_FLOORS)):
        rep, secs, launches, _ = run(tag, streams, length, "--likelihood", mode,
                                     "--learn-every", str(k))
        bad = _below(rep, floors, MAX_MEDIAN_LATENCY_S if tag == "window" else None)
        if tag == "window":
            bad += _per_kind_below(rep)
        want = _learning_ticks(eval_config(likelihood=mode, learn_every=k), length)
        if launches != want:
            bad.append(f"launches {launches} != {want} learning ticks")
        if rep["throughput"]["scored"] != streams * length:
            bad.append(f"scored {rep['throughput']['scored']}")
        if bad:
            failed[tag] = bad
        fixture[tag] = dict(headline(rep), at_default=rep["at_default"], seconds=secs,
                            launches=launches, metrics_per_sec=rep["throughput"]["metrics_per_sec"],
                            per_kind=rep["per_kind"])
        launches_by["eval_fixture"] += launches
    if not fixture["streaming_k2"]["f1"] < fixture["streaming"]["f1"]:
        failed["streaming_k2"] = ["learn-every 2 did not lower f1: learning not thinned"]
    emit("eval_fixture", streams=streams, length=length, runs=fixture, card=card)
    if failed:
        raise AssertionError(f"eval fixture failed: {failed}")

    # (b) card == CPU at 12 streams x 1,000, streaming
    reps = {dev: run(f"cpu_check_{dev}", EVAL_CPU_STREAMS, length, device=dev)
            for dev in ("cuda", "cpu")}
    if _strip_wall_clock(reps["cuda"][0]) != _strip_wall_clock(reps["cpu"][0]):
        raise AssertionError(f"eval card vs CPU differ: {reps['cuda'][0]['at_best']} vs "
                             f"{reps['cpu'][0]['at_best']}")
    emit("eval_card_vs_cpu", streams=EVAL_CPU_STREAMS, length=length, reports_equal=True,
         card_s=reps["cuda"][1], cpu_s=reps["cpu"][1], card=card)

    # (c) the committed artifacts' shape, 120 x 1,500; their event counts are
    # the numpy generator's alone, so they gate
    streams, length = EVAL_ARTIFACT
    artifact = {}
    for tag, mode, name in (("streaming", "streaming", "fault_eval.json"),
                            ("window", "window", "fault_eval_window.json")):
        rep, secs, launches, out = run(f"artifact_{tag}", streams, length, "--likelihood", mode)
        with open(os.path.join(here, "reports", name)) as f:
            ref = json.load(f)  # the JAX package's run on a TPU: quality only
        events = {k: v["events"] for k, v in rep["per_kind"].items()}
        ref_events = {k: v["events"] for k, v in ref["per_kind"].items()}
        artifact[tag] = dict(port=headline(rep), artifact=f"reports/{name}",
                             artifact_headline=headline(ref), events=events,
                             seconds=secs, metrics_per_sec=rep["throughput"]["metrics_per_sec"],
                             at_default=rep["at_default"],
                             per_kind={k: v["recall"] for k, v in rep["per_kind"].items()})
        if events != ref_events or rep["at_best"]["events"] != ref["at_best"]["events"] \
                or launches != length:
            failed[tag] = f"events {events} vs {ref_events}, launches {launches}"
        launches_by["eval_artifact"] += launches
        if tag == "streaming":
            row["artifact_report_path"] = out
    emit("eval_artifact", streams=streams, length=length, runs=artifact, card=card)
    if failed:
        raise AssertionError(f"eval at the artifact's shape failed: {failed}")

    # (d) BASELINE config 3: 1,000 streams x 1,500 ticks, streaming, one group
    streams, length = EVAL_1K
    t0 = time.perf_counter()
    gen_events = _event_counts(fault_streams(streams, length, ("spike", "level_shift", "dropout"),
                                             6.0, eval_config(likelihood="streaming"), 11,
                                             "diurnal"))
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rep, secs, launches, _ = run("1k", streams, length)
    peak = torch.cuda.max_memory_allocated()
    tp = rep["throughput"]
    # the port's chunk_step steps a short last chunk's own ticks (1,500 =
    # 5 x 256 + 220): no padding tick launches, one launch per learning tick
    bad = _below(rep, EVAL_1K_FLOORS, MAX_MEDIAN_LATENCY_S)
    if tp["scored"] != streams * length:
        bad.append(f"scored {tp['scored']} != {streams * length}")
    if launches != length:
        bad.append(f"launches {launches} != {length}")
    events = {k: v["events"] for k, v in rep["per_kind"].items()}
    if events != gen_events:
        bad.append(f"events {events} != the generator's {gen_events}")
    emit("eval_1k", streams=streams, length=length, wall_s=secs, replay_s=tp["elapsed_s"],
         generate_s=gen_s, sweep_s=secs - tp["elapsed_s"] - gen_s,
         metrics_per_sec=tp["metrics_per_sec"], scored=tp["scored"], kernel_launches=launches,
         max_memory_allocated=peak, at_best=rep["at_best"], at_default=rep["at_default"],
         **headline(rep), per_kind=rep["per_kind"], kind_thresholds=rep["kind_thresholds"],
         card=card)
    if bad:
        raise AssertionError(f"eval at 1,000 streams failed: {bad}")
    launches_by["eval_1k"] = launches
    row["launches_by_path"] = launches_by
    return row


def phase_workloads(card: str, work: str) -> dict:
    """``python -m rtap_tpu_torch.eval.workload_eval`` on the card at the
    committed artifact's shape (12 streams x 900, seed 11), each modality's
    at_best beside reports/workloads_r09.json; then the log-template
    modality at 4 streams on the card and the CPU."""
    from rtap_tpu_torch.eval import workload_eval as we

    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(work, "workloads.json")
    streams, length, seed = WORKLOAD_SHAPE
    secs, launches = _in_process(we.main, ["--device", "cuda", "--streams", str(streams),
                                           "--length", str(length), "--seed", str(seed),
                                           "--out", out])
    with open(out) as f:
        rep = json.load(f)
    with open(os.path.join(here, "reports", "workloads_r09.json")) as f:
        ref = json.load(f)  # the JAX package's CPU oracle
    # categorical, log template, scalar and composite: one group each, every tick learning
    want = 4 * length
    if not rep["composite_vs_scalar"]["gate_composite_no_worse"] or launches != want:
        raise AssertionError(f"workloads failed: gate {rep['composite_vs_scalar']}, launches "
                             f"{launches} != {want}")

    def best(r):
        return {"categorical": r["categorical"]["at_best"],
                "log_template": r["log_template"]["at_best"],
                "scalar": r["composite_vs_scalar"]["scalar"]["at_best"],
                "composite": r["composite_vs_scalar"]["composite"]["at_best"]}

    port, oracle = best(rep), best(ref)
    t0 = time.perf_counter()
    runs = {dev: we.run_log_template_eval(n_streams=4, length=length, device=dev, seed=seed)
            for dev in ("cuda", "cpu")}
    if _strip_wall_clock(runs["cuda"]) != _strip_wall_clock(runs["cpu"]):
        raise AssertionError(f"log template card vs CPU differ: {runs['cuda']['at_best']} vs "
                             f"{runs['cpu']['at_best']}")
    row = dict(streams=streams, length=length, seed=seed, seconds=secs, kernel_launches=launches,
               gate_composite_no_worse=True, at_best=port, artifact="reports/workloads_r09.json",
               artifact_at_best=oracle,
               differs_from_artifact=[k for k in port if port[k] != oracle[k]],
               log_template_card_vs_cpu=dict(streams=4, reports_equal=True,
                                             seconds=time.perf_counter() - t0),
               card=card)
    emit("workloads", **row)
    return row


def phase_node_heldout(card: str, work: str) -> dict:
    """``python -m rtap_tpu_torch.eval.node_eval`` on the card at the
    committed artifact's shape (its coupled and single event counts a
    gate); node card == CPU at 2 nodes x 400; one held-out cell."""
    import dataclasses

    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.data.synthetic import ANOMALY_KINDS
    from rtap_tpu_torch.eval import heldout_eval, node_eval
    from rtap_tpu_torch.eval.fault_eval import fault_streams, run_fault_eval

    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(work, "node.json")
    nodes, length = NODE_SHAPE
    secs, launches = _in_process(node_eval.main, ["--device", "cuda", "--nodes", str(nodes),
                                                  "--length", str(length), "--out", out])
    with open(out) as f:
        rep = json.load(f)
    with open(os.path.join(here, "reports", "multivariate_node.json")) as f:
        ref = json.load(f)  # the JAX package's run: quality only
    events = {k: v["events"] for k, v in rep["shapes"].items()}
    ref_events = {k: v["events"] for k, v in ref["shapes"].items()}
    if events != ref_events or launches != length:
        raise AssertionError(f"node eval: events {events} vs {ref_events}, launches {launches}")
    n_cpu, t_cpu = NODE_CPU
    t0 = time.perf_counter()
    small = {dev: node_eval.run_node_eval(n_cpu, t_cpu, device=dev) for dev in ("cuda", "cpu")}
    node_cpu_s = time.perf_counter() - t0
    for k in ("raw", "loglik"):
        if not np.array_equal(small["cuda"][k], small["cpu"][k]):
            raise AssertionError(f"node eval card vs CPU: {k} differs")
    if small["cuda"]["shapes"] != small["cpu"]["shapes"]:
        raise AssertionError("node eval card vs CPU: shapes differ")

    name, mag, seed, streams, hlen = HELDOUT_CELL
    cfg = heldout_eval._cfg(*heldout_eval.VARIANTS[name])
    tl.reset_launches()
    t0 = time.perf_counter()
    hrep = dataclasses.asdict(run_fault_eval(n_streams=streams, length=hlen, kinds=ANOMALY_KINDS,
                                             magnitude=mag, cfg=cfg, device="cuda", seed=seed,
                                             family="heldout"))
    torch.cuda.synchronize()
    h_s, h_launches = time.perf_counter() - t0, tl.launches
    gen = _event_counts(fault_streams(streams, hlen, ANOMALY_KINDS, mag, cfg, seed, "heldout"))
    h_events = {k: v["events"] for k, v in hrep["per_kind"].items()}
    if h_events != gen or h_launches != hlen:
        raise AssertionError(f"held-out cell: events {h_events} vs the generator's {gen}, "
                             f"launches {h_launches}")
    row = dict(node=dict(nodes=nodes, length=length, seconds=secs, kernel_launches=launches,
                         shapes=rep["shapes"], artifact="reports/multivariate_node.json",
                         artifact_shapes=ref["shapes"],
                         card_vs_cpu=dict(nodes=n_cpu, length=t_cpu, raw_equal=True,
                                          loglik_equal=True, seconds=node_cpu_s)),
               heldout=dict(cell=f"{name}|mag{mag:g}|seed{seed}", streams=streams, length=hlen,
                            summary=heldout_eval.cell_summary(hrep), events=h_events,
                            events_equal_generator=True, seconds=h_s, kernel_launches=h_launches),
               card=card)
    emit("node_heldout", **row)
    return row


def phase_report(card: str, work: str, eval_report: str) -> dict:
    """``python -m rtap_tpu_torch report`` on the card with phase 15's
    streaming artifact-shape report; where matplotlib is not installed, the
    report's replay (``report_data``) on the card, held equal to the CPU's."""
    import importlib.util

    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.__main__ import main as cli
    from rtap_tpu_torch.eval import report

    if importlib.util.find_spec("matplotlib") is not None:
        out = os.path.join(work, "report")
        secs, launches = _in_process(cli, ["report", "--device", "cuda", "--out-dir", out,
                                           "--eval-report", eval_report])
        sizes = {n: os.path.getsize(os.path.join(out, n)) for n in ("overlay.png", "fault_eval.png")}
        magic = {n: open(os.path.join(out, n), "rb").read(8) for n in sizes}
        if sizes["overlay.png"] <= 20_000 or sizes["fault_eval.png"] <= 5_000 \
                or set(magic.values()) != {b"\x89PNG\r\n\x1a\n"} or launches != REPORT_TICKS:
            raise AssertionError(f"report: sizes {sizes}, magic {magic}, launches {launches}")
        row = dict(rendered=True, png_bytes=sizes, seconds=secs, kernel_launches=launches)
    else:
        print(json.dumps({"phase": "report", "rendered": False,
                          "why": "matplotlib is not installed"}), flush=True)
        tl.reset_launches()
        t0 = time.perf_counter()
        _, res = report.report_data(device="cuda")
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t0, tl.launches
        _, cpu = report.report_data(device="cpu")
        if not (np.array_equal(res.raw, cpu.raw) and np.array_equal(res.log_likelihood,
                                                                    cpu.log_likelihood)) \
                or launches != REPORT_TICKS:
            raise AssertionError(f"report_data card vs CPU differ (launches {launches})")
        row = dict(rendered=False, streams=res.raw.shape[1], ticks=res.raw.shape[0],
                   raw_equal_cpu=True, loglik_equal_cpu=True, seconds=secs,
                   kernel_launches=launches)
    emit("report_run", **row, card=card)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", type=int, default=32768)
    ap.add_argument("--ticks", type=int, default=128)
    ap.add_argument("--warm-ticks", type=int, default=300,
                    help="learning ticks before the kernel-vs-plain comparisons")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.child:
        return run_drill_child(args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rtap_tpu_torch.config import (categorical_preset, cluster_preset, composite_preset,
                                       nab_preset, node_preset)
    from rtap_tpu_torch.ops import _build

    t_start = time.perf_counter()
    seconds: dict = {}  # wall seconds of each phase
    last = [t_start]

    def mark(n: int) -> None:
        now = time.perf_counter()
        seconds[n] = round(now - last[0], 3)
        last[0] = now

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
    mark(2)

    cmp_rows = []
    # 3. kernel vs plain on learned states
    cmp_rows += [phase_compare(label, cfg, G, args.warm_ticks, args.seed, smi)
                 for label, cfg, G in (("cluster_u16", cluster_preset(), 64),
                                       ("cluster_f32", cluster_preset(perm_bits=0), 64),
                                       ("nab", nab_preset(), 1))]
    cmp_rows.append(phase_dense(DENSE_STREAMS, args.seed, smi))
    # ... at the group shapes the serve and drill paths (phases 6-7) give it
    cmp_rows += [phase_compare(label, cluster_preset(), G, args.warm_ticks, args.seed, smi)
                 for label, G in (("cluster_u16_serve_group", SERVE_GROUP),
                                  ("cluster_u16_drill_group", DRILL_GROUP))]
    # ... at the shapes of phases 11 and 14
    cmp_rows += [phase_compare(label, cfg, G, args.warm_ticks, args.seed, smi)
                 for label, cfg, G in (("nab_corpus_group", nab_preset(), 8),
                                       ("composite_u16", composite_preset(), 64),
                                       ("categorical_u16", categorical_preset(), 64))]
    # ... and at the evals' (phases 15 and 17): one group of 1,000
    # cluster streams, and the node eval's dense S = 4 geometry
    cmp_rows += [phase_compare(label, cfg, G, args.warm_ticks, args.seed, smi)
                 for label, cfg, G in (("cluster_u16_eval_1k", cluster_preset(),
                                        EVAL_1K_STREAMS),
                                       ("node_u16", node_preset(3), NODE_STREAMS))]
    torch.cuda.empty_cache()
    mark(3)
    rows = {}
    # 4. the slice, then the kernel at the main path's own shape
    rows["replay"], main_row = phase_slice(args.streams, args.ticks, args.seed, smi)
    cmp_rows.append(main_row)
    mark(4)
    # 5. card vs CPU
    phase_card_vs_cpu(args.seed)
    torch.cuda.empty_cache()  # the children below need the card's memory
    mark(5)
    # 6. serve at full width through the real entry point
    serve_row = phase_serve(args.seed, smi)
    rows["serve"] = serve_row["kernel_launches"]
    mark(6)
    # 7. kill -9 drill
    rows["kill_drill"] = phase_kill_drill(args.seed, smi)["fault_free_kernel_launches"]
    mark(7)
    # 8. serve with the model-side flags at full width
    rows["serve_model_side"] = phase_serve_model_side(args.seed, smi,
                                                      serve_row)["kernel_launches"]
    mark(8)
    # 9. flags on vs off, and the reducers card vs CPU
    rows["flags_on"] = phase_flags_on_off(args.seed, smi)["launches_on"]
    mark(9)
    # 10. the cascade eval on the card, then killed and resumed
    phase_cascade(smi)
    mark(10)
    # 11. the NAB corpus through `nab`, the kernel after it, card == CPU
    nab_row, nab_krow = phase_nab_corpus(smi)
    rows["nab"] = nab_row["kernel_launches"]
    cmp_rows.append(nab_krow)
    torch.cuda.empty_cache()
    mark(11)
    # 12. the HTMModel golden on the card
    rows["htm_model"] = phase_golden(smi)["kernel_launches"]
    mark(12)
    # 13. the SDR classifier, card vs CPU
    rows["classifier"] = phase_classifier(args.seed, smi)["kernel_launches"]
    torch.cuda.empty_cache()
    mark(13)
    # 14. serve --preset nab|composite|categorical
    for preset, row in phase_serve_presets(args.seed, smi).items():
        rows[f"serve_{preset}"] = row["kernel_launches"]
    mark(14)
    work = tempfile.mkdtemp(prefix="rtap-evals-")
    try:
        # 15. python -m rtap_tpu_torch eval: fixture, card == CPU,
        # the artifacts' shape, BASELINE config 3
        eval_row = phase_eval(smi, work)
        rows.update(eval_row["launches_by_path"])
        eval_report = eval_row["artifact_report_path"]
        torch.cuda.empty_cache()
        mark(15)
        # 16. the workload modalities
        rows["workloads"] = phase_workloads(smi, work)["kernel_launches"]
        mark(16)
        # 17. the multivariate node eval and a held-out cell
        nh = phase_node_heldout(smi, work)
        rows["node_eval"] = nh["node"]["kernel_launches"]
        rows["heldout"] = nh["heldout"]["kernel_launches"]
        mark(17)
        # 18. python -m rtap_tpu_torch report
        rows["report"] = phase_report(smi, work, eval_report)["kernel_launches"]
        mark(18)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=seconds)
    kern = {
        "name": "tm_learn", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": rows["replay"],
        "max_abs_err": max(r["max_abs_err"] for r in cmp_rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_full_ms": main_row["bound_full_ms"],
        "library_ms": None,
        # each path's launches, counted from 0 around that path's run
        "launches_by_path": rows,
    }
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
