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
   per-stream shape (n_seg = 4096, M = 12, int16/u16, G = 2,048); then
   learned states at the group sizes of phases 6 and 7 (G = 4,096 and
   1,024).
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
   child's own counts, from 0). Tick latency, missed deadlines, per-phase
   ms, seconds per group save, parse rate and peak device memory are
   reported, not gated.
7. kill -9 drill: this script's hidden ``--child`` mode runs the port's
   ``live_loop`` (2,048 streams in 2 groups, 96 ticks at cadence 0,
   checkpoints every 16 ticks, journal on, a seeded source keyed by the
   global tick, every stream alerting every tick) once without faults, then
   again with SIGKILLs at two journal-observed ticks off the save grid,
   restarted until its tick budget is done: final checkpoint leaves
   bit-equal to the fault-free run, every alert id exactly once with equal
   record bytes, both kills rc -9, and the fault-free child's launches
   equal to groups x learning ticks.

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


def phase_serve(seed: int, card: str) -> dict:
    """`python -m rtap_tpu_torch serve` at full width in a child process,
    fed over TCP by this process in step with the child's ticks; checks
    its stats line."""
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.resilience.journal import last_journal_tick
    from rtap_tpu_torch.service.sources import send_jsonl

    work = tempfile.mkdtemp(prefix="rtap-serve-")
    t0 = time.perf_counter()
    # tick 0 polls before anything is sent; ticks 1.. get one fed tick each
    streams = cluster_streams(SERVE_STREAMS, SERVE_TICKS - 1, seed, n_anomalies=0)
    ids = [s.stream_id for s in streams]
    ticks = [[{"id": sid, "value": float(s.values[t]), "ts": int(s.timestamps[t])}
              for sid, s in zip(ids, streams)] for t in range(SERVE_TICKS - 1)]
    gen_s = time.perf_counter() - t0
    parse_rate = parse_capacity(ticks[0], ids)
    with open(os.path.join(work, "ids.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    journal_dir, ck_dir = os.path.join(work, "journal"), os.path.join(work, "ck")
    cmd = [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams",
           "@" + os.path.join(work, "ids.txt"), "--device", "cuda",
           "--group-size", str(SERVE_GROUP), "--pipeline-depth", "2", "--cadence", "1.0",
           "--ticks", str(SERVE_TICKS), "--port", "0",
           "--alerts", os.path.join(work, "alerts.jsonl"), "--journal-dir", journal_dir,
           "--checkpoint-dir", ck_dir, "--checkpoint-every", str(SERVE_CHECKPOINT_EVERY)]
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
        ck_bytes = _tree_bytes(ck_dir)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)
    stats = json.loads(out.strip().splitlines()[-1])
    tel = _telemetry(stats)
    groups = SERVE_STREAMS // SERVE_GROUP
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
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serve checks failed {bad} (records sent {sent}): "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }")
    row = dict(preset="cluster_preset", streams=SERVE_STREAMS, group_size=SERVE_GROUP,
               groups=groups, ticks=stats["ticks"], cadence_s=stats["cadence_s"],
               pipeline_depth=stats["pipeline_depth"], learn_every=1,
               scored=stats["scored"], missing_values=stats["missing_values"],
               alerts=stats["alerts"],
               latency_p50_ms=stats["latency_p50_ms"], latency_p90_ms=stats["latency_p90_ms"],
               latency_p99_ms=stats["latency_p99_ms"], latency_max_ms=stats["latency_max_ms"],
               missed_deadlines=stats["missed_deadlines"],
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
    # ... and at the group shapes the serve and drill paths (phases 6-7) give it
    cmp_rows += [phase_compare(label, cluster_preset(), G, args.warm_ticks, args.seed, smi)
                 for label, G in (("cluster_u16_serve_group", SERVE_GROUP),
                                  ("cluster_u16_drill_group", DRILL_GROUP))]
    # 4. the slice, then the kernel at the main path's own shape
    launches, main_row = phase_slice(args.streams, args.ticks, args.seed, smi)
    # 5. card vs CPU
    phase_card_vs_cpu(args.seed)
    torch.cuda.empty_cache()  # the children below need the card's memory
    # 6. serve at full width through the real entry point
    serve_row = phase_serve(args.seed, smi)
    # 7. kill -9 drill
    drill_row = phase_kill_drill(args.seed, smi)

    kern = {
        "name": "tm_learn", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cmp_rows + [main_row]),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_full_ms": main_row["bound_full_ms"],
        "library_ms": None,
        # each path's launches, counted from 0 around that path's run
        "launches_by_path": {"replay": launches, "serve": serve_row["kernel_launches"],
                             "kill_drill": drill_row["fault_free_kernel_launches"]},
    }
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
