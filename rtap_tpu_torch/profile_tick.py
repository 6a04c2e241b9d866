"""Where one learning tick of the replay path spends its time on the card.

    python -m rtap_tpu_torch.profile_tick [--streams G] [--warm-ticks T] [--ticks R] [--seed S]
                                          [--health] [--predict K] [--groups N]

Builds one ``cluster_preset`` group of G streams on cuda, learns T ticks of
synthetic cluster data (``chunk_step``, as the replay does), then:

1. ``stages``: R more learning ticks, each split into bind+encode, SP and
   TM (the learning kernel inside it) with CUDA events on the stream and
   the host clock around each stage's enqueue. Where a stage's event time
   is close to its enqueue time, the device waited for the host there.
2. ``likelihood``: the host likelihood + debounce for R ticks of raw
   scores at G (the replay overlaps it with the next chunk's device work).
3. ``profile``: one learning tick under ``torch.profiler``: device time by
   kernel name, the number of device kernels, and the device's busy share
   of the tick (union of kernel intervals over the tick's span). If the
   profiler records no device activity on this machine, the line says so.
4. ``reducers`` (with ``--health`` and/or ``--predict K``): each
   model-side reducer after each of the R ticks' step, as serve runs it:
   its CUDA-event ms and host enqueue ms (medians), and, from one tick
   under ``torch.profiler``, its device kernel count and device ms. The
   health line also carries the bytes the reducer must read (every pool
   slot's presyn and permanence, every segment's stamp) and their time at
   3.35 TB/s.
5. ``serve_tick`` (with ``--groups N`` > 1): serve's tick shape, N groups
   of G streams each stepped by ``chunk_step`` one after the other with no
   wait between them, as ``live_loop`` dispatches them: R ticks with the
   reducers off and R with the flags given, each tick's CUDA-event ms (all
   N groups) and host enqueue ms (medians).

Prints one JSON line per part, each with the card's ``nvidia-smi`` name and
power limit. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from rtap_tpu_torch.config import cluster_preset
from rtap_tpu_torch.data.synthetic import cluster_streams
from rtap_tpu_torch.models.state import init_state
from rtap_tpu_torch.ops.health import health_pool_bytes, health_reduce
from rtap_tpu_torch.ops.predict import predict_update
from rtap_tpu_torch.ops.step import chunk_step, replicate_state_device, step_stages

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
from rtap_tpu_torch.service.likelihood_batch import BatchAnomalyLikelihood


def _emit(part: str, **kw) -> None:
    print(json.dumps({"part": part, **kw}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=32768)
    ap.add_argument("--warm-ticks", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--health", action="store_true", help="also time the health reducer")
    ap.add_argument("--predict", type=int, default=0, metavar="K",
                    help="also time the predictive-horizon reducer at horizon K")
    ap.add_argument("--groups", type=int, default=1,
                    help="also time serve's tick: N groups of --streams each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = cluster_preset()
    G, W, R = args.streams, args.warm_ticks, args.ticks
    streams = cluster_streams(G, W + R + 1, args.seed, n_anomalies=0)
    vals = torch.from_numpy(np.stack([s.values for s in streams], 1)[:, :, None]).to(dev)
    tss = torch.from_numpy(np.stack([s.timestamps for s in streams], 1).astype(np.int32)).to(dev)
    st = replicate_state_device(init_state(cfg, args.seed, args.predict), G, dev)
    st, _ = chunk_step(st, vals[:W], tss[:W], cfg, predict=bool(args.predict))
    torch.cuda.synchronize()

    # the reducers serve runs after each tick's step (ops/step.py _tick):
    # (name, fn(state, raw, t) -> state), t the tick just stepped
    reducers = []
    if args.predict:
        reducers.append(("predict", lambda s, raw, t: predict_update(s, vals[t], cfg, t)[0]))
    if args.health:
        reducers.append(("health", lambda s, raw, t: (health_reduce(s, raw, vals[t], cfg), s)[1]))
    red_dev = {n: [] for n, _ in reducers}
    red_host = {n: [] for n, _ in reducers}

    # 1. stage times: CUDA events on the stream + host enqueue times
    stages = step_stages(cfg, True)
    names = [n for n, _ in stages]
    dev_ms = {n: [] for n in names}
    host_ms = {n: [] for n in names}
    tick_ms = []
    raws = []
    for t in range(W, W + R):
        x = (vals[t], tss[t])
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        torch.cuda.synchronize()
        h_start = time.perf_counter()
        evs[0].record()
        for i, (name, fn) in enumerate(stages):
            h0 = time.perf_counter()
            st, x = fn(st, x)
            host_ms[name].append((time.perf_counter() - h0) * 1e3)
            evs[i + 1].record()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - h_start) * 1e3)
        for i, name in enumerate(names):
            dev_ms[name].append(evs[i].elapsed_time(evs[i + 1]))
        raws.append(x.cpu().numpy())
        for name, fn in reducers:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)  # the window holds device time, not enqueue
            a.record()
            h0 = time.perf_counter()
            st = fn(st, x, t)
            red_host[name].append((time.perf_counter() - h0) * 1e3)
            b.record()
            torch.cuda.synchronize()
            red_dev[name].append(a.elapsed_time(b))
    _emit("stages", streams=G, warm_ticks=W, ticks=R, card=smi,
          tick_ms_median=float(np.median(tick_ms)),
          stage_event_ms_median={n: float(np.median(v)) for n, v in dev_ms.items()},
          stage_enqueue_ms_median={n: float(np.median(v)) for n, v in host_ms.items()})

    # 2. host likelihood + debounce per tick at G
    lik = BatchAnomalyLikelihood(cfg.likelihood, G)
    run = np.zeros(G, np.int64)
    h0 = time.perf_counter()
    for r in raws:
        _, ll = lik.update(r)
        run = np.where(ll >= 0.5, run + 1, 0)
    _emit("likelihood", streams=G, ticks=len(raws), card=smi,
          host_ms_per_tick=(time.perf_counter() - h0) * 1e3 / len(raws))

    if args.groups > 1:
        _serve_tick(args, cfg, st, vals, tss, W + R, smi)

    # 3. one learning tick under the profiler
    from torch.profiler import ProfilerActivity, profile

    for name, fn in reducers:
        # one call of the reducer alone under the profiler: its device kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as rprof:
            st = fn(st, x, W + R - 1)
            torch.cuda.synchronize()
        rk = [e for e in rprof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        extra = {}
        if name == "health":
            nbytes = health_pool_bytes(cfg, G)
            extra = dict(bytes_read=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        _emit("reducers", reducer=name, streams=G, ticks=R, card=smi,
              event_ms_median=float(np.median(red_dev[name])),
              enqueue_ms_median=float(np.median(red_host[name])),
              device_kernels=len(rk) if rk else "not measured: no device activity recorded",
              device_ms=sum(e.time_range.elapsed_us() for e in rk) / 1e3 if rk else None,
              **({"horizon": args.predict} if name == "predict" else {}), **extra)

    t = W + R
    x = (vals[t], tss[t])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn in stages:
            st, x = fn(st, x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        _emit("profile", card=smi, device_time="not measured: the profiler recorded no device activity")
        return 0
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    t_lo = min(min(e.time_range.start for e in prof.events()), spans[0][0])
    t_hi = max(max(e.time_range.end for e in prof.events()), max(e for _, e in spans))
    by_name: dict[str, list] = {}
    for e in kernels:
        agg = by_name.setdefault(e.name[:90], [0, 0.0])
        agg[0] += 1
        agg[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    _emit("profile", streams=G, card=smi, device_kernels=len(kernels),
          device_busy_ms=busy / 1e3, tick_span_ms=(t_hi - t_lo) / 1e3,
          device_busy_share=busy / max(t_hi - t_lo, 1e-9),
          top_kernels=[{"name": n, "count": c, "ms": us / 1e3} for n, (c, us) in top])
    return 0


def _serve_tick(args, cfg, st, vals, tss, t0: int, smi: str) -> None:
    """Serve's tick shape: args.groups copies of the group state (stream 0's
    tm_iter at t0), each ticked by chunk_step back to back on the record of
    row t0; reducers off, then as flagged."""
    states = [{k: v.clone() for k, v in st.items()} for _ in range(args.groups)]
    v1, ts1 = vals[t0:t0 + 1], tss[t0:t0 + 1]
    rows = {}
    tick = t0
    for label, health, predict in (("off", False, False),
                                   ("on", args.health, bool(args.predict))):
        dev_ms, host_ms = [], []
        for _ in range(args.ticks):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            h0 = time.perf_counter()
            for i, s in enumerate(states):
                states[i], _ = chunk_step(s, v1, ts1, cfg, tick0=tick, health=health,
                                          predict=predict)
            host_ms.append((time.perf_counter() - h0) * 1e3)
            b.record()
            torch.cuda.synchronize()
            dev_ms.append(a.elapsed_time(b))
            tick += 1
        rows[label] = dict(tick_event_ms_median=float(np.median(dev_ms)),
                           tick_enqueue_ms_median=float(np.median(host_ms)),
                           health=health, predict=predict)
    del states
    _emit("serve_tick", groups=args.groups, streams_per_group=args.streams, ticks=args.ticks,
          card=smi, **rows)


if __name__ == "__main__":
    sys.exit(main())
