"""Drive the PyTorch port's replay, serve (with its scheduling flags), ingest, resilience, failover, control-plane, fleet chaos, checkpoint-import, observability, NAB, model and eval paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed S] [--streams G] [--ticks T] [--deadline-s D]

Phases, one JSON line each; any failure raises and exits non-zero. Each
phase prints ``{"phase": "phase_end", "name": ..., "seconds": ...}`` as it
ends, and ``{"phase": "part", "name": "<phase>: <part>", "seconds": ...}``
for its parts: each serve child's start until it listens, its registry
build, its warm-up, its tick 0, its fed ticks and its exit; each CPU
reference run, soak, save and reload. Before phase 1 one ``{"phase":
"host", ...}`` line says what the host is: its cores (all and this
process's), CPU model, load average, torch's threads, memory, and the
seconds of a fixed seeded CPU workload (200 plain TM passes on a 16-stream
state, one thread), a host-speed marker apart from the phases' own code. The whole run has a deadline (--deadline-s, default 1,140 s from the
script's start): every wait draws on it, and when it is reached the
running phase's children are killed by process group, one line
``{"phase": "deadline", "running": <phase>, "phase_seconds": {...}}`` is
printed and the run exits 4.

The CPU halves of the card == CPU comparisons of phases 10, 11, 13, 15(b),
16 and 17 run in one background process (this script's hidden
``--cpu-refs`` mode), started after phase 2 with ``CUDA_VISIBLE_DEVICES=``
and pinned to 2 of the host's cores (torch's threads to match): phase 11's
NAB prefix at once, beside phases 3-5; the others from phase 9 on, so that
none overlaps the serve phases 6-8. Each phase makes its comparison as
before once its CPU half arrives, and the process must end with every job
done before the done line; a failed job, or the process's death, fails the
run.

1. the card: ``nvidia-smi`` name and power limit (also printed raw).
2. build: the TM learning kernel, rtap_tpu_torch/csrc/tm_learn.cu, with nvcc
   for sm_90a.
3. kernel vs plain: the TM learning-pass kernel against its plain PyTorch
   version on states that went through --warm-ticks (100; 150 until phase 25) real learning ticks
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
   of 4,096, pipeline depth 2, 1 s cadence, 25 ticks learning every tick,
   alerts, the write-ahead journal and a checkpoint round on exit (phase 25
   saves in the loop at this shape) on; a feeder here pushes one tick of seeded synthetic
   cluster values over TCP (``send_jsonl``) each time the child journals a
   tick, so every tick after the first polls one whole fed tick. The child
   must exit 0 with every tick scored for every stream, no value missing
   past tick 0, every record sent parsed by the native C parser
   (``native_active``), no parse errors or unknown ids, no
   capacity overflow, the checkpoint round saved, its telemetry registry
   agreeing with its stats, and one kernel launch per group per tick (the
   child's own counts, from 0). No tick may miss the 1 s deadline, tick 0
   included (the exit save follows the last tick): the warm-up (``--aot-warmup``, on by default) ran its one program before
   it, with no program dispatched cold after. The missed_tick events are
   read from the child's alert stream and each is gated, its phase split
   reported; tick 0's ms and the warm-up's seconds are reported. Tick
   latency, per-phase ms, seconds per group save, the parse rate alone
   (native and Python) and peak device memory are reported, not gated,
   beside the figures of the Python parser's run. The final checkpoint's
   per-leaf digest and the alert records are kept for phase 22(a).
7. kill -9 drill: the chaos soak's journaled child (2,048 streams in 2
   groups, 32 ticks at cadence 0, checkpoints every 16 ticks, journal on, a
   seeded source keyed by the global tick, every stream alerting every
   tick) once without faults in this process, then as this script's hidden
   ``--child`` mode with a SIGKILL at a journal-observed tick off the save grid,
   restarted until its tick budget is done: final checkpoint leaves
   bit-equal to the fault-free run, every alert id exactly once with equal
   record bytes, both kills rc -9, and the fault-free child's launches
   equal to groups x learning ticks.
8. serve with the model-side and observability flags: phase 6's serve
   (32,768 streams in 8 groups of 4,096, depth 2, 1 s cadence, 12 learning
   ticks, the journal, the tick-gated feeder, phase 6's values) with ``--health --predict
   --topology infer --latency --slo tick=1s@p99 --trace-out F
   --postmortem-dir D --flight-ticks 64 --obs-port 0
   --alert-attribution``, ids renamed ``svc<s>-<n>.<metric>`` so the
   inferred topology groups them (128 services), timestamps anchored ahead
   of the wall clock, and no checkpoint dir. Once the child journals tick
   10 this script GETs /metrics, /healthz, /latency, /health, /predict,
   /incidents and /trace?last=5. Gates: exit 0, every tick scored, one
   kernel launch per learned group tick, 8 x 12 health and predict folds,
   a finite fleet miss EWMA, every tracker armed, ``<alerts>.epoch`` at 1;
   every route 200, the Prometheus text parses and carries the registry's
   ``rtap_obs_*`` families (each one of the child's), /healthz ok; the
   trace file is Chrome trace JSON with the loop's phase spans for every
   tick; every bundle in D valid; every alert line with ``top_fields``;
   the SLO verdict in the stats. Latency, per-phase ms and peak memory are
   reported beside phase 6's and beside phase 8's without the obs flags.
9. flags on vs off: the drill's shape (2 groups of 1,024, 32 ticks at
   cadence 0, every stream alerting every tick) through ``live_loop`` on
   the card with health + predict 8, the trackers and the observability
   hooks (latency + a tick SLO, trace, flight recorder, attribution), and
   without any: every model leaf (the predictor's own aside) bit-equal,
   the raw scores bit for bit and the alert lines byte for byte once
   ``top_fields`` is removed (every on line has it); launches equal; every
   scored stream's miss EWMA finite. Then one learning tick of a 64-stream
   slice of that state on the card and on the CPU with both reducers:
   predict leaves, raw and state bit for bit, health integers exact and
   floats at rtol=1e-5, atol=1e-6.
10. the cascade eval: ``python -m rtap_tpu_torch.predict_eval`` (its main,
   in this process, but for the killed life) at the JAX
   script's defaults on the card (win, blast covered, 0 false precursors)
   and on this machine's CPU (the same page tick and first-precursor
   ticks); then on the card with ``--workdir``, killed with SIGKILL once
   its first precursor is on the alert stream and resumed from its
   checkpoint and journal: every precursor, predicted_incident and
   incident id exactly once, the page tick unchanged.
11. the NAB corpus: ``python -m rtap_tpu_torch nab`` (its main, in this
   process) on the card over data/nab (8 files, 32,256 records, nab_preset, every file one stream
   of one group): the JAX package's quality floors for this corpus, finite
   per-file scores, one kernel launch per learning tick; wall time,
   records/s and peak device memory reported, the scores beside the JAX
   package's TPU run of the same corpus (quality only). The group's final
   state, saved by the run, holds the kernel to its plain version after
   4,032 learning ticks. Then card == CPU on the first NAB_CPU_ROWS rows of
   one file (raw equal, loglik within 1e-12, scores equal): past the
   likelihood probation, what the CPU runs in about 40 s at this width.
12. ``AnomalyDetector`` on the card over golden_config1's stream: raw equal
   to tests/golden/golden_config1.npz, loglik within 1e-12; saved at row
   200, loaded and continued: the same rows.
13. the SDR classifier: cluster_preset + classifier at G = 64 over 32
   learning ticks on the card and the CPU: raw, the model leaves and
   cls_cnt bit for bit, cls_w at rtol 1e-5 / atol 1e-6, predictions and
   probabilities within 1e-4.
14. ``serve --preset nab`` (64 streams in one group, 4 ticks),
   ``--preset composite`` and ``--preset categorical`` (4,096 streams in one
   group, 3 ticks each) fed by phase 6's tick-gated TCP feeder at 1 s
   cadence: every tick after tick 0 under 1 s, values missing only at tick
   0, well-formed alert lines, one launch per group per learning tick; peak
   device memory reported.
15. ``python -m rtap_tpu_torch eval`` (its main, in this process) on the
   card: (a) tests/integration/test_fault_eval.py's fixture shape, 40 x
   1,000, window, streaming and streaming with learn-every 2, each held to
   that file's floors and to one launch per learning tick; (b) 12 streams x
   850 on the card and the CPU, reports equal but for wall-clock
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

19. resilience on the card, ``python -m rtap_tpu_torch.chaos_soak`` (its
   main, in this process): (a) the seeded soak, cluster preset at full
   width, 4,096 streams in 4 groups of 1,024, 50 ticks at cadence 0.05 s,
   checkpoints every 10, restore after 6, seed 1, rate 0.08, plus an
   injected collect fault on group 1 at tick 40 (seed 1's schedule draws
   no quarantine): verified (no silent gap, alert ids unique, bundles
   valid), its schedule digest the one this process draws on the host,
   every quarantined group restored, the untouched groups' final leaves
   bit-equal to a twin run without the state-changing faults, launches
   equal to the learned group ticks; (b) ``--degrade``, 2 groups of 1,024,
   100 ticks at 0.1 s, group 0's dispatch hanging twice the cadence for 25
   ticks: the ladder engages and recovers to level 0, launches equal to
   the learned group ticks and fewer than every group tick; (c)
   ``--supervise --kills 1`` at the drill's shape (2 groups of 1,024, 32
   ticks, checkpoints every 16): a proc_exit death and restart, the
   budget done, journal replays, no alert id twice, the last life's
   launches its learned group ticks; (d) ``--topology-burst`` (12 streams,
   120 ticks): exactly one incident over the flooded nodes. The seconds of
   each and each restore's seconds are reported.
20. the obs cost: every measure of ``obs/selfbench.GATE_MEASURES`` in this
   process (the fleet publisher's ``measure_fleet`` among them) at most 1%
   of the 1 s tick budget, microseconds reported.
21. binary ingest, each part with its seconds: (a) ``serve --ingest-port
   0`` at phase 6's shape (6 ticks) without the checkpoint dir, fed phase 6's ticks
   as one RB1 DATA frame per tick over a persistent BinaryFeedConnection
   (slot codes from its hello MAP) in step with the child's journal: every
   row sent parsed, no garbage, parse errors, unknown ids or dropped rows,
   ``native_active``, 8 x 6 launches, only tick 0 missed, and the
   journal's 6 FRAME records holding exactly the frames fed; tick latency,
   per-phase ms, journal bytes and append ms per tick and peak memory
   reported. (b) the drill's shape through live_loop on the card over
   TcpJsonlSource (native), BinaryBatchSource's socket and its shm ring, in
   lockstep: alert lines byte-identical, final leaves bit-equal, launches
   the learned group ticks. (c) ``serve --ingest-port 0 --journal-dir
   --checkpoint-dir`` at the drill's shape, SIGKILLed at journal tick 20
   and restarted over the same directories: FRAME rows replayed with none
   skipped, every alert id once, alert lines and final leaves equal to the
   uninterrupted run's (the same registry and loop over the same values in
   this process). (d) ``python -m
   rtap_tpu_torch.ingest_bench`` at the JAX package's defaults (1,000,000
   records, 4,096 streams, 8,192 rows per frame): each transport's
   records/s, the host's cores and machine, and the JAX package's gates
   (binary >= 1M rows/s and >= 5x the native JSONL TCP path), which must
   hold.
22. replication and the fleet plane, each part with its seconds: (a)
   phase 6's serve as two ``python -m rtap_tpu_torch serve`` children, a
   leader (``--replicate-to --lease-file --journal-dir --checkpoint-dir``,
   plus ``--latency --obs-port 0``) and a standby (``--standby
   --replicate-listen``, the same lease, sink and checkpoint dir), both at
   ``--threshold 0 --debounce 18`` so that every stream alerts on ticks
   17-24 (inside the 400-tick probation every stream's log-likelihood is
   one constant, so no threshold selects a subset of streams), fed phase
   6's ticks by whichever process the lease names; the leader is
   SIGKILLed 0.3 s after it journals tick 21 (its
   sender has shipped the tick, its next poll is ~1 s away), the
   standby promotes on lease staleness, checkpoints its warm fleet and
   serves the rest. Gates: the promoted process exits 0 on phase 6's final
   state (the per-leaf digest; each group's debounce counter, which the
   threshold defines, at its threshold-0 value of 25), every alert id of
   ticks 17-24 exactly once (262,144), some delivered by the leader
   before its kill and some served after the promotion, none dropped
   from the standby's buffer, the standby applied every tick the leader
   journaled, one launch per group per applied and per served tick, the
   takeover within 10 ticks at lease epoch 2, no value missing after the
   takeover, and only tick 0, the leader's save tick (19) and the takeover
   tick past 1 s. Reported: the leader's tick quantiles (its sketch, scraped before its
   death) beside phase 6's, the replication counters and bytes per tick,
   the standby's apply ms per tick, the takeover split (detection, splice,
   the warm-fleet checkpoint, lease flip, listener, first served tick),
   each side's longest heartbeat gap and device memory. (b) ``python -m
   rtap_tpu_torch.failover_soak --fleet`` on the card at the drill's shape
   (2 groups of 1,024, 32 ticks at 0.2 s, 1 kill and the SIGSTOP fence
   round): verified, and every life's launches its learned group-ticks.
   (c) ``python -m rtap_tpu_torch.chaos_soak --replication`` (its main, in
   this process; 2 groups of 1,024, 32 ticks): the three wire fault kinds
   injected, every tick applied, the standby bit-equal to the leader, and
   one launch per group per tick on each side.
23. the control plane: ``serve --control-listen 0 --control-journal J
   --control-only``, then shard 0's leader (``--replicate-to``) and
   standby and shard 1's leader, each ``--control-join`` with one group of
   1,024 streams (cluster preset, full width) at 0.2 s, threshold 0 and
   debounce 1 (every stream alerts every tick), each shard fed its seeded
   ticks in step with its serving process's journal; the promoted standby
   and shard 1's leader are stopped by SIGTERM once the promoted standby
   served 12 ticks (the --ticks budget is one no process reaches). (a)
   Gates: each leader holds epoch 1 of its shard, the roster holds both
   shards and three members, and the plane's pid is not in ``nvidia-smi
   --query-compute-apps`` and has no /dev/nvidia* file open (a leader's
   has). (b) The plane is SIGKILLed, held down 2 s and restarted on its
   journal and port: both leaders ticked on through the outage, counted
   degraded ticks and wrote control_plane_lost then
   control_plane_regained; the standby did not promote; the restarted
   plane recovered 2 shards; every shard's grants rise strictly. (c)
   ``control_drain`` of shard 0: its leader exits 0 with ``"drained":
   true`` after releasing the lease, the standby is granted epoch 2 within
   one lease timeout (2 s) of the release and serves on, each shard's
   alert stream holds every id of its served ticks once, shard 1 serves on
   through the drain, and every data plane launches one kernel per learned
   tick (the
   standby per applied tick). Reported: the control RPC round trip p50/p99
   (us), the grant's journal append + fsync (ms), degraded ticks, the
   plane's restart to listening and to each leader's regained event, the
   release to the grant and to the promoted standby's first served tick,
   launches per process and the phase's seconds.
24. checkpoint import: the JAX package's orbax checkpoints read by the
   port's own OCDBT, zarr and zstd readers (no orbax, tensorstore or zstd
   library). (a) tests/fixtures/migration/dense_ckpt imported on the card
   with ``sparsify`` and without, each continued 40 ticks over its
   expected.npz: raw and log-likelihood bit for bit, 40 launches, no TM
   overflow; then the kernel against its plain version on each imported
   state's next learning pass (C = 64, K = 4, S = 2, M = 8, G = 2). (b)
   tests/fixtures/torch_import/group0000 (64 streams of cluster_preset at
   full width after 60 ticks) the same way, and the kernel at its shape.
   (c) ``python -m rtap_tpu_torch serve`` with a copy of that fixture as
   its --checkpoint-dir group 0 (its 64 ids, --group-size 64, 0.1 s),
   fed (b)'s values by the tick-gated feeder (the first tick's before its
   poll): exit 0, resumed at tick 60, one launch per learned tick, no value
   missing, and its exit checkpoint equal leaf for leaf to (b)'s group.
   Reported: each import's seconds split into OCDBT reading, zarr
   assembly, zstd decoding and the device copy, the bytes, the decoder's
   MB/s and that rate extrapolated to one 4,096-stream group.
25. the scheduling flags: phase 6's serve (32,768 streams in 8 groups of
   4,096, depth 2, 1 s cadence, the journal, phase 6's feed) for 16 ticks
   with ``--micro-chunk 4 --chunk-stagger --stagger-learn --learn-every 4
   --learn-full-until 0 --dispatch-threads 4``, the warm-up on (the
   default), checkpoints every 8 ticks, threshold 0 and debounce 13 (every
   stream alerts on ticks 12-15). Gates: (a) only the save ticks (7, 15)
   miss, the warm-up ran every knowable program (4 configs x chunk lengths
   1-4) and none was dispatched cold; (b) the exit checkpoint equals, leaf
   for leaf (phase 22(a)'s per-leaf digest), the same staggered registry
   stepped here one tick at a time with no chunk stagger and no threads,
   and so do the alert ids' raw scores and log-likelihoods (the reference
   runs while the child serves its last tick, a save tick); (c) on every
   tick exactly 2 of the 8 groups learn and the tick launches 2 passes,
   and each tick but the save ticks dispatches one phase class (2 groups);
   (d) the child's launches equal its learned group-ticks and the
   reference's, the warm-up's counted apart, and group 0's ticks stepped
   again through the plain TM pass on the card end leaf-equal to the
   kernel's; (e) 4 dispatch threads. Each tick's launches and dispatch ms
   are reported beside phase 6's per-tick phase ms.
26. the fleet chaos drill: ``python -m rtap_tpu_torch.fleet_chaos --device
   cuda`` as a child, two control-plane shards of 1,024 full-width streams
   (one group each), 160 ticks per shard at 0.2 s (lease 0.8 s), every
   stream alerting every tick, checkpoints every 16: both shards' leaders
   SIGKILLed, shard 0's standby SIGKILLed, the plane SIGKILLed and restarted
   from its journal, the SIGSTOP fence round on shard 1, the drain of shard
   0, the two fault-free references beside it. Gates: the JAX twin's
   assertions (verified; 2 leader kills; the standby kill; the outage
   survived with degraded ticks counted by the fleet plane and the stats
   lines; fence rc 7; drain rc 0; per shard 0 duplicated, lost or extra
   alert ids and the state leaves compared; grants rising strictly), each
   shard's 1,024 x 160 alert ids, every life's launches its learned group
   ticks and each reference's launches its 160 ticks, every promotion
   detected within the 10-tick budget, no unscheduled fence, and each of
   the two plane processes without a CUDA context (no /dev/nvidia* file
   open, not in ``nvidia-smi --query-compute-apps``; a member's has).
   Reported: the schedule and the tick each round fired at, each
   promotion's detection and tick, the outage, the degraded ticks, the
   fence and drain rounds, each life's launches, each child's start to
   warm and release to following or leading, the references' seconds.

Then the kernels line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import dataclasses
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

T_START = time.monotonic()  # the whole-run deadline counts from here, before torch loads

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM 32-bit non-tensor peak (NVIDIA data sheet)
KERNEL_SOURCE = "rtap_tpu_torch/csrc/tm_learn.cu"
KERNEL_REPLACES = "rtap_tpu/ops/pallas_tm.py:86"
DENSE_STREAMS = 2048  # the dense row's G: the plain version finishes it in seconds
# phase 6 (ticks cut from 40 to 25 for phase 24; 22(a)'s standby, which
# starts following ~10 ticks behind its leader, needs ~20 to catch up
# before the kill). Phase 6 saves on exit only since phase 25: its in-loop
# save round at 32,768 streams (ticks 7 and 15) is the same save path at
# the same shape
SERVE_STREAMS, SERVE_GROUP, SERVE_TICKS = 32768, 4096, 25
# phase 7: 2 groups; the drill's shape for phases 9, 19(c), 21(b)-(c) too
# (32 ticks: cut from 96 to 64 for phase 22, to 48 for phase 23, to 32 for
# phase 24)
DRILL_STREAMS, DRILL_GROUP, DRILL_TICKS = 2048, 1024, 32
DRILL_CHECKPOINT_EVERY = 16
# journal ticks to SIGKILL at, off the 16-tick save grid (one kill since
# phase 24; (20, 36) before)
DRILL_KILLS = (20,)
NAB_RECORDS = 32256  # data/nab: 8 files of 4,032 rows
NAB_ROWS = 4032  # learning ticks of the batched corpus run (the longest file)
# the JAX package's quality floors for this corpus
# (tests/integration/test_nab_run.py::test_committed_corpus_artifact_floors)
NAB_FLOORS = {"standard": 6.0, "reward_low_FN": 15.0, "reward_low_FP": 2.0}
# card == CPU on a prefix of one file: 12 rows past the 388-row likelihood
# probation, ~25 s of the CPU's plain path at this width (cut from 1,200
# rows, then 600, then 450, to keep the whole smoke near its time target; the
# corpus's first labelled window starts at row 1,117, so the prefix's
# scores are 0.0 on both sides and raw and loglik carry the comparison)
NAB_CPU_SUBSET, NAB_CPU_ROWS = "realAWSCloudwatch/ec2_cpu_utilization_5f5533", 400
GOLDEN_ROWS, GOLDEN_SAVE_AT = 400, 200  # phase 12
CLS_STREAMS, CLS_TICKS = 64, 32  # phase 13 (64 ticks until phase 25)
# phase 14: (preset, streams, group size, ticks)
# (ticks cut from 30, 20 and 20, then 16, 10 and 10, then 10, 6 and 6, then
# 6, 4 and 4, then 4, 3 and 3, to make room for phases 22-25)
PRESET_SERVES = (("nab", 64, 64, 4), ("composite", 4096, 4096, 3),
                 ("categorical", 4096, 4096, 3))
EVAL_1K_STREAMS, NODE_STREAMS = 1000, 12  # phase 3's eval and node rows
# phase 15: (streams, ticks) of tests/integration/test_fault_eval.py's
# fixture, of reports/fault_eval*.json, and of BASELINE config 3
EVAL_FIXTURE, EVAL_ARTIFACT, EVAL_1K = (40, 1000), (120, 1500), (EVAL_1K_STREAMS, 1500)
# phase 15(b): card == CPU, 12 streams x 850 ticks, just past the eval's
# probation bound (~834; cut from the fixture's 1,000 to keep the smoke
# near 900 s)
EVAL_CPU_STREAMS, EVAL_CPU_LENGTH = 12, 850
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
# phase 8: the obs scrape happens once the child journals this tick; phase
# 8's tick latency without the obs flags (p50, p99 ms, PERF.md section 2;
# NVIDIA H100 80GB HBM3, 700.00 W) is reported beside
OBS_SCRAPE_TICK = 10  # 20 until phase 24, 12 until phase 25
PHASE8_WITHOUT_OBS_MS = (349.435, 826.919)
# phase 6 with the Python JSONL parser (run 1 of the previous slice's smoke,
# PERF.md; NVIDIA H100 80GB HBM3, 700.00 W), reported beside the native run
PHASE6_PYTHON_PARSE = {"latency_p50_ms": 61.031, "latency_p99_ms": 9927.466,
                       "source_ms_per_tick": 0.12, "parse_records_per_s_alone": 170354.93}
# phase 21: binary ingest. (b) and (c) at the drill's shape; (c) kills its
# child once the journal reaches BINARY_KILL_AT, off the 16-tick save grid,
# and paces its lives at BINARY_DRILL_CADENCE s so the journal-gated feeder
# (~5 ms behind each append) is always ahead of the child's next poll; (d)
# runs the ingest bench at the JAX package's defaults (1,000,000 records,
# 4,096 streams, 8,192 rows per frame)
BINARY_KILL_AT = 20  # 30 at 48 drill ticks
BINARY_DRILL_CADENCE = 0.1
OBS_ROUTES = ("/metrics", "/healthz", "/latency", "/health", "/predict", "/incidents",
              "/trace?last=5")
# phase 8 must expose at least these registry families while it runs
OBS_FAMILIES = ("rtap_obs_ticks_total", "rtap_obs_scored_total", "rtap_obs_tick_seconds",
                "rtap_obs_phase_seconds", "rtap_obs_streams_active", "rtap_obs_groups_quarantined",
                "rtap_obs_run_epoch", "rtap_obs_build_info", "rtap_obs_last_tick_unixtime",
                "rtap_obs_latency_samples_total", "rtap_obs_slo_burn_rate")
# phase 19: the seeded soak (cluster preset at full width; 50 ticks, cut
# from 120, then 80, then 60, to make room for phases 22-24; seed 1 draws
# the same schedule at 50 ticks as at 60), its injected
# restore drill, the degradation drill and the supervised drill
CHAOS_SOAK = dict(seed=1, streams=4096, group_size=1024, ticks=50, cadence=0.05,
                  checkpoint_every=10, restore_after=6, rate=0.08)
CHAOS_INJECT = ("collect_exception@40:1",)  # seed 1's schedule draws no quarantine
DEGRADE_DRILL = dict(streams=DRILL_STREAMS, group_size=DRILL_GROUP, ticks=100, cadence=0.1)
SUPERVISE_KILLS = 1  # 2 until phase 24
# phase 8 and 21(a) run phase 6's shape at this depth (cut from 40 ticks to
# 24 and 20 for phase 22, then to 22 and 14 for phase 23, then to 14 and 8
# for phase 24, then to 12 and 6 for phase 25; phase 8's obs scrape at
# OBS_SCRAPE_TICK still lands, and its k = 8 predictor's miss EWMA is finite
# from tick 9)
MODEL_SIDE_TICKS, BINARY_SERVE_TICKS = 12, 6
# phase 22: (a) phase 6's serve as a leader/standby pair, the leader
# SIGKILLed once its journal holds FAILOVER_KILL_AT (25 at 40 ticks), the
# lease timeout chosen above the heartbeat gaps a save round
# leaves (PERF.md), takeovers detected within the budget; (b) the failover
# soak at the drill's shape; (c) the replication chaos soak (seed 1's
# 32-tick schedule at rate 0.15 draws all three wire kinds)
FAILOVER_KILL_AT, FAILOVER_LEASE_TIMEOUT, FAILOVER_TAKEOVER_BUDGET = 21, 2.0, 10
# 22(a)'s alerts: inside the 400-tick probation every stream's
# log-likelihood is the same constant (0.0301), so no threshold picks a
# subset of streams; threshold 0 with a debounce of FAILOVER_DEBOUNCE ticks
# makes every stream alert on the ticks FAILOVER_DEBOUNCE - 1 .. SERVE_TICKS -
# 1 only (17 .. 24: ticks the leader delivers before its kill at 21, the
# rest spliced or served after the promotion; 22 .. 39 and a kill at 25 at
# 40 ticks). 8 x 32,768 = 262,144 alert lines; the standby buffers at most
# two ticks of them (65,536 lines, its cap)
FAILOVER_DEBOUNCE = 18
# the leader dies this long after its journal append of the kill tick: its
# replication sender has shipped the record, its next poll is ~1 s away
FAILOVER_KILL_DELAY_S = 0.3
# the leader's save round at tick 19: its ~9 s stall is when the standby,
# which starts following ~10 ticks behind, catches up with the live edge
# (without it a slow host's standby had mirrored 21 of the 22 ticks the
# leader journaled when it died)
FAILOVER_CHECKPOINT_EVERY = 20
# (b)'s soak: 32 ticks, cut from 96 to 48 for phase 23 and to 32 for phase
# 24; one kill (two until phase 24) before the fence round
FAILOVER_SOAK = dict(seed=3, kills=1, streams=DRILL_STREAMS, group_size=DRILL_GROUP, ticks=32,
                     cadence=0.2, checkpoint_every=16)
REPL_CHAOS = dict(seed=1, streams=DRILL_STREAMS, group_size=DRILL_GROUP, ticks=32, cadence=0.05,
                  rate=0.15, checkpoint_every=8)
# phase 23: the control plane. Each data plane serves CONTROL_STREAMS (one
# group, the drill's group shape) at CONTROL_CADENCE s at threshold 0 (every
# stream alerts every tick), with a --ticks budget of CONTROL_TICKS that no
# process reaches: the plane stays down CONTROL_DOWN_S before its restart,
# the drain comes CONTROL_DRAIN_AFTER ticks after both leaders regained it,
# and the promoted standby and shard 1's leader are stopped (SIGTERM, an
# orderly exit) once the promoted standby served CONTROL_SERVED ticks
CONTROL_STREAMS, CONTROL_CADENCE, CONTROL_TICKS = DRILL_GROUP, 0.2, 300
CONTROL_LEASE_TIMEOUT, CONTROL_DOWN_S, CONTROL_DRAIN_AFTER, CONTROL_SERVED = 2.0, 2.0, 6, 12
CONTROL_RPCS = 200  # RPC round trips timed against the live plane
# phase 24: the JAX package's committed dense migration checkpoint and the
# full-width checkpoint it wrote (64 streams of cluster_preset after 60
# ticks; tests/fixtures/torch_import/make_fixture.py), each continued 40
# ticks; (c)'s serve child resumes the latter at this cadence
MIGRATION_FIXTURE = "tests/fixtures/migration"
IMPORT_FIXTURE = "tests/fixtures/torch_import"
IMPORT_SERVE_CADENCE = 0.1
# phase 25: serve's scheduling flags at phase 6's shape, SCHED_TICKS ticks:
# micro-chunks of SCHED_MICRO with staggered boundaries, learning every
# SCHED_LEARN_EVERY ticks on staggered phases, SCHED_THREADS dispatch
# threads, a save every SCHED_CHECKPOINT_EVERY ticks; threshold 0 with this
# debounce makes every stream alert on ticks SCHED_DEBOUNCE - 1 .. 15
SCHED_TICKS, SCHED_MICRO, SCHED_LEARN_EVERY, SCHED_THREADS = 16, 4, 4, 4
SCHED_CHECKPOINT_EVERY, SCHED_DEBOUNCE = 8, 13
# phase 26: the fleet chaos drill. Two control-plane shards, each one group of
# CONTROL_STREAMS (the drill's group shape, phase 23's per-shard shape), at
# phase 22(b)'s cadence (lease 0.8 s), threshold at the floor (every stream
# alerts every tick), the tick budget per shard
FLEET_CHAOS = dict(seed=0, ticks=160, cadence=0.2, checkpoint_every=16)
PHASE_NAMES = {2: "1-2 card and build", 3: "3 kernel vs plain", 4: "4 slice",
               5: "5 card vs cpu", 6: "6 serve", 7: "7 kill drill", 8: "8 serve model side",
               9: "9 flags on vs off", 10: "10 cascade", 11: "11 nab corpus", 12: "12 golden",
               13: "13 classifier", 14: "14 serve presets", 15: "15 eval", 16: "16 workloads",
               17: "17 node and held-out", 18: "18 report", 19: "19 resilience",
               20: "20 obs cost", 21: "21 binary ingest", 22: "22 replication",
               23: "23 control plane", 24: "24 imports", 25: "25 scheduling flags",
               26: "26 fleet chaos"}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def part(name: str, seconds: float, **kw) -> None:
    """One measured part of the running phase (a child's start, a CPU
    reference run, a soak, ...) on a line of its own."""
    emit("part", name=f"{DEADLINE.running}: {name}", seconds=round(seconds, 3), **kw)


class timed_part:
    """``with timed_part(name):`` prints the block's seconds as a part line."""

    def __init__(self, name: str, **kw):
        self.name, self.kw = name, kw

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        part(self.name, time.perf_counter() - self.t0, **self.kw)
        return False


HOST_CALIBRATION_REPS = 200  # plain TM passes of the host line's CPU workload


def host_line() -> dict:
    """What the run's host is: cores (all and this process's), CPU model,
    load, torch's threads, memory, and the seconds of one fixed seeded CPU
    workload (the plain TM learning pass on a 16-stream cluster state, a
    second speed marker independent of the phases' own code paths)."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.config import cluster_preset

    def proc_field(path: str, key: str) -> str | None:
        try:
            with open(path) as f:
                for line in f:
                    if line.startswith(key):
                        return line.split(":", 1)[1].strip()
        except OSError:
            pass
        return None

    lp = learned_state(cluster_preset(), 16, 8, 0, device="cpu")
    snap = [t.clone() for t in lp.args[:2]]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one core's speed, whatever the host's count
    try:
        t0 = time.perf_counter()
        for _ in range(HOST_CALIBRATION_REPS):
            lp.args[0].copy_(snap[0])
            lp.args[1].copy_(snap[1])
            tl.tm_learn_plain(*lp.args, lp.consts, lp.K, lp.N)
        calib = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    row = dict(cpu_count=os.cpu_count(), affinity=len(os.sched_getaffinity(0)),
               cpu_model=proc_field("/proc/cpuinfo", "model name"),
               loadavg=list(os.getloadavg()), torch_threads=threads,
               mem_total=proc_field("/proc/meminfo", "MemTotal"),
               calibration=f"tm_learn_plain x {HOST_CALIBRATION_REPS}, cluster_preset G = 16 "
                           "after 8 learning ticks, CPU, one thread",
               calibration_s=round(calib, 4))
    emit("host", **row)
    return row


DEADLINE_S = 1140.0  # the whole run's default deadline, seconds from T_START
DEADLINE_RC = 4  # the exit code of a run that reached its deadline


def _descendants(pid: int) -> list[int]:
    """Every live descendant of `pid`, read from /proc (parents first)."""
    children: dict[int, list[int]] = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(d))
    out, stack = [], [pid]
    while stack:
        for c in children.get(stack.pop(), []):
            out.append(c)
            stack.append(c)
    return out


def kill_children() -> list[int]:
    """SIGKILL every descendant of this process: by process group where it
    leads one of its own (``spawn_child`` starts each child so), else by pid."""
    mine = os.getpgrp()
    killed = []
    for pid in _descendants(os.getpid()):
        try:
            pgid = os.getpgid(pid)
            if pgid == pid and pgid != mine:
                os.killpg(pgid, signal.SIGKILL)
            else:
                os.kill(pid, signal.SIGKILL)
            killed.append(pid)
        except (ProcessLookupError, PermissionError):
            continue
    return killed


class Deadline:
    """The whole run's deadline. Every wait draws on it (``cap``: a wait's
    own timeout, at most the seconds left; ``until``: a poll loop's end on
    the wall clock), and a watchdog thread fires it: the phase's children are
    killed by process group, one JSON line names the phase running and the
    seconds of those that ended, and the process exits DEADLINE_RC. No
    handler can turn that into a pass. Unarmed (as when imported), it never
    fires and caps nothing."""

    def __init__(self):
        self.at: float | None = None
        self.seconds: float | None = None
        self.running = "start"
        self.phase_seconds: dict[str, float] = {}
        self._firing = threading.Lock()

    def arm(self, seconds: float, start: float = T_START) -> None:
        self.seconds = seconds
        self.at = start + seconds
        threading.Thread(target=self._watch, name="chip-smoke-deadline", daemon=True).start()

    def left(self) -> float:
        return float("inf") if self.at is None else max(0.0, self.at - time.monotonic())

    def passed(self) -> bool:
        """Reached, or within a second of it (a capped wait ends on its own
        clock, a hair before the watchdog's)."""
        return self.at is not None and time.monotonic() >= self.at - 1.0

    def cap(self, own: float) -> float:
        return min(own, self.left())

    def until(self, own: float) -> float:
        """The wall-clock end of a poll loop of `own` seconds."""
        return time.time() + self.cap(own)

    def begin(self, name: str) -> None:
        self.running = name

    def end(self, name: str, seconds: float) -> None:
        """A phase ended: its seconds on a flushed line of their own."""
        self.phase_seconds[name] = seconds
        emit("phase_end", name=name, seconds=seconds,
             elapsed_s=round(time.monotonic() - T_START, 3))

    def _watch(self) -> None:
        while True:
            rest = self.at - time.monotonic()
            if rest <= 0:
                self.fire()
            time.sleep(min(rest, 0.5))

    def fire(self) -> None:
        if not self._firing.acquire(blocking=False):
            time.sleep(3600)  # the other thread is ending the process
        killed = kill_children()
        emit("deadline", running=self.running, phase_seconds=self.phase_seconds,
             deadline_s=self.seconds, elapsed_s=round(time.monotonic() - T_START, 3),
             children_killed=len(killed))
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(DEADLINE_RC)


DEADLINE = Deadline()


def run_guarded(fn) -> int:
    """fn() under the deadline: whatever a wait that ran out with the run's
    time raises, a reached deadline ends the run as the watchdog would."""
    try:
        return fn()
    except BaseException:
        if DEADLINE.passed():
            DEADLINE.fire()
        raise


def spawn_child(cmd: list[str], **kw) -> subprocess.Popen:
    """A child process leading its own process group (the deadline kills
    it and everything it starts by that group)."""
    return subprocess.Popen(cmd, start_new_session=True, **kw)


def run_child(cmd: list[str], timeout: float, **kw) -> subprocess.CompletedProcess:
    """subprocess.run on `spawn_child`, its timeout drawn on the deadline; a
    timed-out child's group is killed before the TimeoutExpired rises."""
    p = spawn_child(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)
    try:
        out, err = p.communicate(timeout=DEADLINE.cap(timeout))
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


CPU_REF_CORES = 2  # the background CPU references' cores (and torch threads)


class CpuRefs:
    """The smoke's CPU-side references, run in one background process (this
    script's hidden ``--cpu-refs`` mode) that never initialises CUDA
    (``CUDA_VISIBLE_DEVICES=`` in its environment) and is pinned to
    CPU_REF_CORES of the host's cores. Its first jobs start at once, beside
    phases 3-5; the others wait for ``go()`` (phase 9), so that none of
    them overlaps the serve phases 6-8. Each job leaves a pickle of (ok,
    value or error, seconds); ``result`` waits for one on the deadline and
    raises if the job failed or the process died without it, so each
    phase's comparison is made as it was, only once its CPU half arrives.
    The process is a ``spawn_child``: the deadline kills it with the rest."""

    def __init__(self):
        self.proc: subprocess.Popen | None = None
        self.dir: str | None = None

    def start(self, seed: int, cmd: list[str] | None = None) -> None:
        self.dir = tempfile.mkdtemp(prefix="rtap-cpu-refs-")
        cmd = cmd or [sys.executable, os.path.abspath(__file__), "--cpu-refs", "--seed", str(seed)]
        self.log = open(os.path.join(self.dir, "log"), "w")
        self.proc = spawn_child([*cmd, "--workdir", self.dir], stdout=self.log,
                                stderr=subprocess.STDOUT,
                                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})

    def go(self) -> None:
        """Let the jobs that wait for phase 9 start."""
        open(os.path.join(self.dir, "go"), "w").close()

    def _failed(self, what: str) -> AssertionError:
        with open(os.path.join(self.dir, "log")) as f:
            tail = f.read()[-3000:]
        return AssertionError(f"background CPU references: {what}\n{tail}")

    def result(self, name: str, timeout: float = 900):
        """Job `name`'s value, once the background has it."""
        import pickle

        path = os.path.join(self.dir, f"{name}.pkl")
        t0, end = time.perf_counter(), DEADLINE.until(timeout)
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                raise self._failed(f"exited {self.proc.returncode} without {name}")
            if time.time() > end:
                raise self._failed(f"no {name} within {timeout} s")
            time.sleep(0.05)
        with open(path, "rb") as f:
            ok, value, secs = pickle.load(f)
        if not ok:
            raise self._failed(f"{name} failed: {value}")
        part(f"background CPU reference {name}", secs,
             waited_s=round(time.perf_counter() - t0, 3))
        return value

    def join(self, timeout: float = 300) -> None:
        """The background ended with every job done (before the done line)."""
        rc = self.proc.wait(timeout=DEADLINE.cap(timeout))
        self.log.close()
        if rc != 0:
            raise self._failed(f"exited {rc}")
        shutil.rmtree(self.dir, ignore_errors=True)

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


BG = CpuRefs()


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


def learned_state(cfg, G: int, ticks: int, seed: int, device: str = "cuda"):
    """The next tick's learning pass for a [G, ...] state after `ticks`
    real learning ticks on synthetic cluster data (fused cpu/mem/net nodes
    for a multivariate node config; a composite config reads one wire value
    per stream, as serve feeds it), on `device`."""
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
    vals = torch.from_numpy(values).to(device)
    ts = torch.from_numpy(np.stack([s.timestamps for s in streams], 1).astype(np.int32)).to(device)
    st = replicate_state_device(init_state(cfg, seed), G, device)
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
    return launches, row, streams


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


def parse_capacity(records: list[dict], ids: list[str], native: bool | None = None) -> float:
    """Records per second one TcpJsonlSource parses on this host with
    nothing else running (`native`: None takes the C parser, False forces
    Python): one tick's records, encoded ahead, pushed over loopback; the
    clock runs from the first byte sent to the last record counted (the
    serve child parses on its listener threads, beside the loop)."""
    from rtap_tpu_torch.service.sources import TcpJsonlSource

    payload = "".join(json.dumps(r) + "\n" for r in records).encode()
    with TcpJsonlSource(ids, native=native) as src:
        if src.native_active != (native is not False):
            raise AssertionError(f"TcpJsonlSource(native={native}).native_active is "
                                 f"{src.native_active}")
        t0 = time.perf_counter()
        with socket.create_connection(src.address) as conn:
            conn.sendall(payload)
        deadline = DEADLINE.until(60)
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


def _serve_child(ids: list[str], ticks: list, work: str, extra: list[str],
                 group: int = SERVE_GROUP, n_ticks: int = SERVE_TICKS,
                 scrape=None, transport: str = "jsonl", cadence: float = 1.0,
                 start: int = 0, kill_at: int | None = None,
                 frames_out: list | None = None, presend: list | None = None,
                 on_last_fed=None) -> tuple:
    """`python -m rtap_tpu_torch serve` on cuda over `ids` (groups of
    `group`, depth 2, `cadence` s, `n_ticks` ticks, alerts and the journal
    in `work`, plus `extra` flags), fed by this process: ``ticks[t]`` (what
    tick t + 1 polls) once the child journals tick t -> (stats, records
    sent, stderr). `transport` "jsonl" sends record lists over TCP
    (``send_jsonl``); "binary" runs the child with ``--ingest-port 0`` and
    sends each ``ticks[t] = (values [N] f32, ts)`` as one RB1 DATA frame
    over one persistent ``BinaryFeedConnection``, with the slot codes of
    its hello MAP, appending the frames to `frames_out`. `start` is the
    first index fed (a resumed life over the same journal). `kill_at`:
    SIGKILL the child once its journal reaches that tick (stats None).
    `scrape` = (tick, fn, out dict): once the child journals that tick,
    ``out.update(fn(obs port))`` (the child runs with --obs-port 0).
    `presend` (JSONL): records sent as soon as the child listens, which its
    first tick polls (it restores its checkpoints before that poll).
    `on_last_fed()` runs once the last tick is fed, while the child serves
    it and exits (work of this process that needs none of the child's
    outputs)."""
    from rtap_tpu_torch.ingest import BinaryFeedConnection
    from rtap_tpu_torch.ingest.protocol import data_frame
    from rtap_tpu_torch.resilience.journal import last_journal_tick
    from rtap_tpu_torch.service.sources import send_jsonl

    with open(os.path.join(work, "ids.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    journal_dir = os.path.join(work, "journal")
    binary = transport == "binary"
    cmd = [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams",
           "@" + os.path.join(work, "ids.txt"), "--device", "cuda",
           "--group-size", str(group), "--pipeline-depth", "2", "--cadence", str(cadence),
           "--ticks", str(n_ticks), *(["--ingest-port", "0"] if binary else ["--port", "0"]),
           "--alerts", os.path.join(work, "alerts.jsonl"), "--journal-dir", journal_dir, *extra]
    listen = "listening for binary batch frames on" if binary else "listening for JSONL records on"
    t_spawn = time.perf_counter()
    proc = spawn_child(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    what = dict(streams=len(ids), ticks=n_ticks, start=start, transport=transport)
    err_lines: list[str] = []
    port: list[int] = []
    obs_port: list[int] = []

    def read_stderr():
        for line in proc.stderr:
            err_lines.append(line)
            if listen in line:
                port.append(int(line.rsplit(":", 1)[1]))
            elif "obs telemetry on http://" in line:
                obs_port.append(int(line.rsplit(":", 1)[1].split("/")[0]))

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    conn = None
    try:
        deadline = DEADLINE.until(300)
        while not port and proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if not port:
            raise AssertionError(f"serve never listened (rc {proc.poll()}):\n"
                                 + "".join(err_lines)[-3000:])
        t_listen = time.perf_counter()
        part("serve child start to listening", t_listen - t_spawn, **what)
        if binary:
            conn = BinaryFeedConnection(("127.0.0.1", port[0]), timeout_s=60.0)
            codes = np.array([conn.code_of[sid] for sid in ids], np.uint32)
            if start:
                # a resumed child re-pushes its slot map once its checkpoints
                # are restored (the epoch moves to 2): frames stamped before
                # that would be refused as stale
                deadline = DEADLINE.until(300)
                while conn.epoch < 2 and proc.poll() is None and time.time() < deadline:
                    conn.poll_map()
                    time.sleep(0.005)
        sent = 0 if presend is None else send_jsonl(("127.0.0.1", port[0]), presend)
        for t in range(start, len(ticks)):
            # the child journals tick t's polled row before scoring it: from
            # then on, what arrives is what tick t + 1 polls
            deadline = DEADLINE.until(300)
            while last_journal_tick(journal_dir) < t and proc.poll() is None \
                    and time.time() < deadline:
                time.sleep(0.002)
            if proc.poll() is not None or last_journal_tick(journal_dir) < t:
                break
            if kill_at is not None and t >= kill_at:
                proc.send_signal(signal.SIGKILL)  # no cleanup, no flush
                proc.wait()
                part("serve child ticks until the kill", time.perf_counter() - t_listen, **what)
                return None, sent, "".join(err_lines)
            if binary:
                conn.poll_map()  # a producer adopts pushed maps before each send
                values, ts = ticks[t]
                frame = data_frame(codes, values, ts, epoch=conn.epoch)
                conn.send_frame(frame)
                if frames_out is not None:
                    frames_out.append(frame)
                sent += len(ids)
            else:
                sent += send_jsonl(("127.0.0.1", port[0]), ticks[t])
            if scrape is not None and t == scrape[0]:
                scrape[2].update(scrape[1](obs_port[0]))
        t_fed = time.perf_counter()
        part("serve child ticks (fed)", t_fed - t_listen, **what)
        if on_last_fed is not None:
            on_last_fed()
        out, _ = proc.communicate(timeout=DEADLINE.cap(600))
        part("serve child last tick to exit", time.perf_counter() - t_fed, **what)
        if proc.returncode != 0:
            raise AssertionError(f"serve exited {proc.returncode}:\n"
                                 + "".join(err_lines)[-3000:])
    finally:
        if conn is not None:
            conn.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=DEADLINE.cap(10))
    stats = json.loads(out.strip().splitlines()[-1])
    _child_parts(stats, **what)
    return stats, sent, "".join(err_lines)


def _child_parts(stats: dict, **what) -> None:
    """A serve child's own start-up seconds from its stats line: the
    registry's build, the warm-up before tick 0, its checkpoint saves."""
    for key, name, scale in (("registry_build_s", "serve child registry build", 1.0),
                             ("aot_warmup_s", "serve child warm-up before tick 0", 1.0),
                             ("tick0_ms", "serve child tick 0", 1e-3)):
        if stats.get(key) is not None:
            part(name, stats[key] * scale, **what)
    if stats.get("group_save_s_mean") is not None:
        part("serve child group save (mean)", stats["group_save_s_mean"],
             saves=stats.get("checkpoints_saved"), **what)


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
                n_ticks: int = SERVE_TICKS, value=float, streams=None):
    """Seeded synthetic cluster values for `n_streams` streams -> (their
    stream ids, one record list per fed tick 1..n_ticks-1, seconds).
    `ts0` re-anchors the timestamps (tick 0 at ts0); `value` maps each
    synthetic value to the wire value. `streams`: already generated
    cluster streams to take the first ticks of (phase 4's, whose faults
    start a quarter into its replay), instead of generating them."""
    from rtap_tpu_torch.data.synthetic import cluster_streams

    t0 = time.perf_counter()
    # tick 0 polls before anything is sent; ticks 1.. get one fed tick each
    if streams is None or len(streams) < n_streams or len(streams[0].values) < n_ticks - 1 \
            or any(s.events and s.events[0].onset <= int(s.timestamps[n_ticks - 2])
                   for s in streams[:n_streams]):
        streams = cluster_streams(n_streams, n_ticks - 1, seed, n_anomalies=0)
    streams = streams[:n_streams]
    ids = [s.stream_id for s in streams]
    shift = 0 if ts0 is None else ts0 + 1 - int(streams[0].timestamps[0])
    ticks = [[{"id": sid, "value": value(s.values[t]), "ts": int(s.timestamps[t]) + shift}
              for sid, s in zip(ids, streams)] for t in range(n_ticks - 1)]
    return ids, ticks, time.perf_counter() - t0


def _cpu_ref_jobs(seed: int, work: str) -> list:
    """The background's jobs in the order it runs them: (name, waits for
    phase 9, fn). Each is the CPU half of a card == CPU comparison, run as
    its phase ran it before."""
    from rtap_tpu_torch.__main__ import main as cli
    from rtap_tpu_torch.eval import node_eval
    from rtap_tpu_torch.eval import workload_eval as we

    def eval_cpu():
        out = os.path.join(work, "eval_cpu_check_cpu.json")
        secs, _ = _in_process(cli, ["eval", "--device", "cpu", "--streams", str(EVAL_CPU_STREAMS),
                                    "--length", str(EVAL_CPU_LENGTH), "--out", out])
        with open(out) as f:
            return json.load(f), secs

    return [
        ("nab_prefix", False, lambda: _nab_run("cpu", work, "prefix_cpu", "--rows",
                                               str(NAB_CPU_ROWS), "--subset", NAB_CPU_SUBSET)),
        ("cascade_cpu", True, lambda: _predict_eval_here("cpu", "--device", "cpu")),
        ("classifier_cpu", True, lambda: _classifier_run("cpu", seed)),
        ("eval_cpu", True, eval_cpu),
        ("log_template_cpu", True, lambda: we.run_log_template_eval(
            n_streams=4, length=WORKLOAD_SHAPE[1], device="cpu", seed=WORKLOAD_SHAPE[2])),
        ("node_cpu", True, lambda: node_eval.run_node_eval(*NODE_CPU, device="cpu")),
    ]


def run_cpu_refs(args) -> int:
    """The hidden ``--cpu-refs`` mode (see CpuRefs): pinned to CPU_REF_CORES
    cores, each job's (ok, value or error, seconds) pickled into --workdir;
    the jobs after the first wait for the ``go`` file. Exits 1 if a job
    failed or CUDA was initialised."""
    import pickle
    import traceback

    cores = sorted(os.sched_getaffinity(0))[-CPU_REF_CORES:]
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))
    parent = os.getppid()
    work = os.path.join(args.workdir, "work")
    os.makedirs(work, exist_ok=True)
    failed = False
    for name, after_go, fn in _cpu_ref_jobs(args.seed, work):
        while after_go and not os.path.exists(os.path.join(args.workdir, "go")):
            if os.getppid() != parent:
                return 1  # the smoke is gone
            time.sleep(0.1)
        t0 = time.perf_counter()
        try:
            ok, value = True, fn()
        except Exception as e:  # noqa: BLE001 - reported to the smoke, which fails on it
            traceback.print_exc()
            ok, value, failed = False, f"{type(e).__name__}: {e}", True
        path = os.path.join(args.workdir, f"{name}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump((ok, value, time.perf_counter() - t0), f)
        os.replace(path + ".tmp", path)
        print(json.dumps({"job": name, "ok": ok, "seconds": time.perf_counter() - t0}),
              flush=True)
    if torch.cuda.is_initialized():
        print("the background CPU references initialised CUDA", flush=True)
        return 1
    return 1 if failed else 0


def phase_serve(seed: int, card: str, streams=None) -> dict:
    """`python -m rtap_tpu_torch serve` at full width in a child process,
    fed over TCP by this process in step with the child's ticks (the first
    fault-free ticks of phase 4's `streams`); checks its stats line."""
    work = tempfile.mkdtemp(prefix="rtap-serve-")
    ids, ticks, gen_s = _serve_feed(seed, streams=streams)
    parse_rate = {"python": parse_capacity(ticks[0], ids, native=False),
                  "native": parse_capacity(ticks[0], ids)}
    ck_dir = os.path.join(work, "ck")
    try:
        # the checkpoint round on exit (phase 25 saves in the loop)
        stats, sent, _ = _serve_child(ids, ticks, work, ["--checkpoint-dir", ck_dir])
        ck_bytes = _tree_bytes(ck_dir)
        missed = _missed_ticks(os.path.join(work, "alerts.jsonl"))
        # the final state phase 22(a)'s failover must reproduce; its alert
        # counters (threshold 0 there) are held to their own exact value
        t_digest = time.perf_counter()
        state_digest = _ck_digest(ck_dir)
        digest_s = time.perf_counter() - t_digest
        alert_run = np.load(os.path.join(ck_dir, "group0000", "state", "alert_run.npy"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tel = _telemetry(stats)
    groups = SERVE_STREAMS // SERVE_GROUP
    # the one save round follows the last tick: no tick saves
    save_ticks: set = set()
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
        # the listener parsed with the native C parser, not Python
        "native_active": stats["native_active"] is True,
        "tm_overflow_total": stats["tm_overflow_total"] == 0,
        # the final save on exit
        "checkpoints_saved": stats.get("checkpoints_saved") == 1,
        # the source syncs its ingest tallies into the registry at each poll,
        # and the last record is parsed before the last poll
        "telemetry": (tel["rtap_obs_ticks_total"], tel["rtap_obs_scored_total"],
                      tel["rtap_obs_ingest_records_total"])
                     == (stats["ticks"], stats["scored"], stats["records_parsed"]),
        # the child's own launch count, from 0 in that fresh process
        "kernel_launches": stats["kernel_launches"]["tm_learn"] == groups * SERVE_TICKS,
        # only the save ticks may miss the 1 s deadline: the warm-up (on by
        # default) loads the modules and makes the first allocations before
        # tick 0; the stats' count agrees with the events
        "missed_ticks": all(t in save_ticks for t, _ in missed)
                        and len(missed) == stats["missed_deadlines"],
        "tick0_deadline": stats["tick0_ms"] < 1000.0,
        "warm_up": stats["aot_programs_compiled"] == 1
                   and stats["cold_compiles_after_warmup"] == 0,
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
               tick0_ms=stats["tick0_ms"], aot_warmup_s=stats["aot_warmup_s"],
               aot_programs_compiled=stats["aot_programs_compiled"],
               aot_kernel_launches=stats["aot_kernel_launches"],
               phase_ms_per_tick=stats["phase_ms_per_tick"],
               checkpoints_saved=stats["checkpoints_saved"],
               group_save_s_mean=stats["group_save_s_mean"], checkpoint_bytes=ck_bytes,
               journal_append_ms_per_tick=stats["journal"]["append_ms_per_tick"],
               records_sent=sent, records_parsed=stats["records_parsed"],
               native_active=stats["native_active"],
               parse_records_per_s_alone=parse_rate,
               before_native_parse=PHASE6_PYTHON_PARSE,
               records_parsed_per_s=stats["records_parsed"] / stats["elapsed_s"],
               elapsed_s=stats["elapsed_s"],
               hbm_peak_bytes_in_use=stats["hbm_peak_bytes_in_use"],
               kernel_launches=stats["kernel_launches"]["tm_learn"],
               state_digest_leaves=len(state_digest), state_digest_s=digest_s,
               feed_gen_s=gen_s, card=card)
    emit("serve", **row)
    return {**row, "state_digest": state_digest,
            "alert_run_like": (alert_run.dtype, alert_run.shape), "feed": (ids, ticks)}


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


def parse_prometheus(text: str) -> tuple[set, int]:
    """Prometheus text -> (its TYPE families, sample lines); raises on a
    sample line whose value is not a number."""
    families, samples = set(), 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
            samples += 1
    return families, samples


def _scrape_obs(port: int) -> dict:
    """GET every obs route of a running serve child -> {route: (status,
    body)}, with the seconds the scrape took."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    out = {}
    for route in OBS_ROUTES:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=DEADLINE.cap(30)) as r:
                out[route] = (r.status, r.read().decode())
        except urllib.error.HTTPError as e:
            out[route] = (e.code, e.read().decode())
    return {"routes": out, "scrape_s": time.perf_counter() - t0}


def phase_serve_model_side(seed: int, card: str, serve_row: dict) -> dict:
    """Phase 6's serve with --health, --predict and --topology infer and
    the observability flags (latency + a tick SLO, trace, flight recorder,
    the obs HTTP server scraped mid-run, alert attribution), no checkpoint
    dir; its latency and per-phase ms beside phase 6's."""
    from rtap_tpu_torch.obs import validate_bundle

    work = tempfile.mkdtemp(prefix="rtap-serve-ms-")
    # phase 6's seeded values (its first MODEL_SIDE_TICKS - 1 fed ticks) under
    # service ids, the timestamps anchored at wall-clock time plus a margin:
    # a fed ts in the past would be clamped up to the wall clock and freeze
    # the correlation clock
    t_feed = time.perf_counter()
    ids6, ticks6 = serve_row["feed"]
    ids = service_ids(ids6)
    shift = int(time.time()) + 3600 + 1 - int(ticks6[0][0]["ts"])
    ticks = [[{"id": sid, "value": r["value"], "ts": r["ts"] + shift}
              for r, sid in zip(records, ids)] for records in ticks6[:MODEL_SIDE_TICKS - 1]]
    gen_s = time.perf_counter() - t_feed
    trace_path, pm_dir = os.path.join(work, "trace.json"), os.path.join(work, "pm")
    scraped: dict = {}
    try:
        stats, sent, err = _serve_child(
            ids, ticks, work,
            ["--health", "--predict", "--topology", "infer", "--latency",
             "--slo", "tick=1s@p99", "--trace-out", trace_path, "--postmortem-dir", pm_dir,
             "--flight-ticks", "64", "--obs-port", "0", "--alert-attribution"],
            n_ticks=MODEL_SIDE_TICKS, scrape=(OBS_SCRAPE_TICK, _scrape_obs, scraped))
        epoch_file = os.path.join(work, "alerts.jsonl.epoch")
        epoch = json.loads(open(epoch_file).read())["epoch"] if os.path.exists(epoch_file) else None
        events: dict = {}
        missed = []  # (tick, seconds) of each missed deadline
        alert_lines = top_fields = 0
        for line in open(os.path.join(work, "alerts.jsonl")):
            if line.startswith('{"event"'):
                ev = json.loads(line)
                events[ev["event"]] = events.get(ev["event"], 0) + 1
                if ev["event"] == "missed_tick":
                    missed.append((ev["tick"], ev["elapsed_s"]))
            else:
                alert_lines += 1
                top_fields += "top_fields" in json.loads(line)
        trace = json.load(open(trace_path))
        bundles = [os.path.join(pm_dir, d) for d in sorted(os.listdir(pm_dir))
                   if not d.startswith(".tmp")] if os.path.isdir(pm_dir) else []
        verdicts = [validate_bundle(b) for b in bundles]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    groups = SERVE_STREAMS // SERVE_GROUP
    health, predict = stats.get("health", {}), stats.get("predict", {})
    ewma_max = predict.get("miss_ewma_max")
    routes = scraped.get("routes", {})
    families, samples = parse_prometheus(routes["/metrics"][1]) \
        if routes.get("/metrics", (0,))[0] == 200 else (set(), 0)
    final_names = {m["name"] for m in stats["telemetry"]["metrics"]}
    spans: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("tid") == 0:
            spans.setdefault(e["name"], set()).add(e["args"]["tick"])
    every = set(range(MODEL_SIDE_TICKS))
    checks = {
        "ticks": stats["ticks"] == MODEL_SIDE_TICKS,
        "scored": stats["scored"] == MODEL_SIDE_TICKS * SERVE_STREAMS,
        "missing_values": stats["missing_values"] == SERVE_STREAMS,
        "records_parsed": stats["records_parsed"] == sent
                          == (MODEL_SIDE_TICKS - 1) * SERVE_STREAMS,
        # one launch per learned tick of every (unquarantined) group
        "kernel_launches": stats["kernel_launches"]["tm_learn"] == stats["learned_group_ticks"]
                           == groups * MODEL_SIDE_TICKS,
        "health_folds": health.get("groups") == groups
                        and health.get("ticks_folded") == groups * MODEL_SIDE_TICKS,
        # the predictor folds every group tick of every group
        "predict_folds": predict.get("groups") == groups
                         and predict.get("ticks_folded") == groups * MODEL_SIDE_TICKS,
        # streams scored from tick k on: the fleet's worst EWMA is a number
        "miss_ewma_finite": ewma_max is not None and 0.0 <= ewma_max <= 1.0,
        "incidents_stats": "incidents" in stats,
        "run_epoch": epoch == 1,
        "armed": all(a in err for a in ("model-health reducers armed",
                                        "predictive horizon armed (k=8 ticks",
                                        "incident correlation armed (inferred",
                                        "detection-latency tracking armed",
                                        "SLOs armed: tick=1s@p99",
                                        "flight recorder armed")),
        # the routes answered mid-run; the Prometheus text parses and carries
        # the registry's families, each one of the child's own
        "routes": sorted(routes) == sorted(OBS_ROUTES)
                  and all(code == 200 for code, _ in routes.values()),
        "prometheus": samples > 0 and set(OBS_FAMILIES) <= families <= final_names,
        "healthz": routes.get("/healthz", (0, "{}"))[0] == 200
                   and json.loads(routes["/healthz"][1])["ok"] is True,
        # the loop's phase spans for every tick (collect and emit from the
        # tick after, depth 2: tick 0 only dispatches)
        "trace": every <= spans.get("tick", set()) and every <= spans.get("source", set())
                 and every <= spans.get("dispatch", set())
                 and every - {0} <= spans.get("collect", set())
                 and every - {0} <= spans.get("emit", set()),
        "bundles_valid": all(v["ok"] for v in verdicts),
        "top_fields": top_fields == alert_lines,
        "slo": stats.get("slo", {}).get("slos", [{}])[0].get("samples") == MODEL_SIDE_TICKS,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serve with the model side and obs flags failed {bad}: "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }; "
                             f"routes {[(r, c) for r, (c, _) in routes.items()]}, "
                             f"families missing {sorted(set(OBS_FAMILIES) - families)}, "
                             f"stderr {err[-1500:]}")
    row = dict(streams=SERVE_STREAMS, group_size=SERVE_GROUP, groups=groups,
               ticks=stats["ticks"],
               flags=["--health", "--predict", "--topology infer", "--latency",
                      "--slo tick=1s@p99", "--trace-out", "--postmortem-dir",
                      "--flight-ticks 64", "--obs-port 0", "--alert-attribution"],
               scored=stats["scored"], alerts=stats["alerts"], alert_lines=alert_lines,
               latency_p50_ms=stats["latency_p50_ms"], latency_p90_ms=stats["latency_p90_ms"],
               latency_p99_ms=stats["latency_p99_ms"], latency_max_ms=stats["latency_max_ms"],
               missed_deadlines=stats["missed_deadlines"], missed_ticks=missed,
               phase_ms_per_tick=stats["phase_ms_per_tick"],
               phase6_latency_p50_ms=serve_row["latency_p50_ms"],
               phase6_latency_p99_ms=serve_row["latency_p99_ms"],
               phase6_phase_ms_per_tick=serve_row["phase_ms_per_tick"],
               without_obs_latency_p50_ms=PHASE8_WITHOUT_OBS_MS[0],
               without_obs_latency_p99_ms=PHASE8_WITHOUT_OBS_MS[1],
               health=health, predict=predict, incidents=stats["incidents"],
               slo=stats["slo"], latency=stats["latency"], postmortem=stats["postmortem"],
               bundles=len(bundles), trace_records=trace["otherData"]["total_records"],
               trace_dropped=trace["otherData"]["dropped_records"],
               obs_scrape_tick=OBS_SCRAPE_TICK, obs_scrape_s=scraped["scrape_s"],
               prometheus_families=len(families), prometheus_samples=samples,
               events_on_stream=events, run_epoch=epoch,
               hbm_peak_bytes_in_use=stats["hbm_peak_bytes_in_use"],
               phase6_hbm_peak_bytes_in_use=serve_row["hbm_peak_bytes_in_use"],
               kernel_launches=stats["kernel_launches"]["tm_learn"], feed_gen_s=gen_s, card=card)
    emit("serve_model_side", **row)
    return row


def run_drill_child(args) -> int:
    """One serve lifetime of the kill drill (``--child``): the chaos soak's
    journaled child (``python -m rtap_tpu_torch.chaos_soak --child``) at
    the drill's shape — recover the journal, resume the checkpoints,
    replay, then run the rest of the DRILL_TICKS budget over a seeded
    source keyed by the global tick, one stream spiking each tick."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return _drill_life(args.workdir, args.seed)


def _drill_life(workdir: str, seed: int) -> int:
    from rtap_tpu_torch import chaos_soak

    # threshold 0: every stream alerts every tick, so exactly-once is
    # checked on every (stream, tick)
    return chaos_soak.main(["--child", "--workdir", workdir, "--seed", str(seed),
                            "--streams", str(DRILL_STREAMS), "--group-size", str(DRILL_GROUP),
                            "--ticks", str(DRILL_TICKS), "--cadence", "0",
                            "--checkpoint-every", str(DRILL_CHECKPOINT_EVERY),
                            "--pipeline-depth", "2", "--threshold=0.0", "--spike-every", "1",
                            "--device", "cuda"])


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
    from rtap_tpu_torch.service.ckpt_tree import read_npy_tree

    out = {}
    for name in sorted(os.listdir(ckdir)):
        if name.startswith("group"):
            meta = json.loads(open(os.path.join(ckdir, name, "meta.json")).read())
            out[name] = (meta["ticks"], read_npy_tree(Path(ckdir, name, "state")))
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
        children.append(spawn_child([sys.executable, me, "--child", "--workdir", work,
                               "--seed", str(seed)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True))
        return children[-1]

    import contextlib
    import io

    t0 = time.perf_counter()
    ref, crash = os.path.join(root, "ref"), os.path.join(root, "crash")
    # the fault-free life in this process (the same journaled child's code;
    # only the killed lives need a process of their own)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _drill_life(ref, seed)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"fault-free drill life returned {rc}")
    ref_stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    ref_s = time.perf_counter() - t0
    part("fault-free life (in this process)", ref_s)
    torch.cuda.empty_cache()
    kills, lives = [], []
    targets = list(DRILL_KILLS)
    while True:
        t_life = time.perf_counter()
        p = child(crash)
        kill = None
        if targets:
            target = targets.pop(0)
            deadline = time.monotonic() + DEADLINE.cap(600)
            while p.poll() is None and time.monotonic() < deadline:
                seen = last_journal_tick(os.path.join(crash, "journal"))
                if seen >= target:
                    p.send_signal(signal.SIGKILL)  # no cleanup, no flush
                    kill = {"target": target, "journal_tick": seen}
                    break
                time.sleep(0.005)
        out, err = p.communicate(timeout=DEADLINE.cap(900))
        lives.append(p.returncode)
        part("killed life" if kill is not None else "resumed life", time.perf_counter() - t_life)
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
    """The drill's shape (2 groups of 1,024, 32 ticks at cadence 0, every
    stream alerting every tick) through live_loop on the card twice: with
    --health and --predict 8 (trackers on) and the observability hooks
    (latency + a tick SLO, trace, flight recorder, alert attribution), and
    without any. Then one learning tick of a 64-stream slice of the
    flags-on state with both reducers on the card and on the CPU."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.obs import (
        FlightRecorder,
        LatencyTracker,
        SloTracker,
        TraceRecorder,
        parse_slo,
        validate_bundle,
    )
    from rtap_tpu_torch.obs.health import HealthTracker
    from rtap_tpu_torch.obs.metrics import TelemetryRegistry
    from rtap_tpu_torch.ops.step import chunk_step
    from rtap_tpu_torch.predict import PredictTracker
    from rtap_tpu_torch.service.attribution import AlertAttributor
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    cfg = cluster_preset()
    ids = [f"n{i // 3}.m{i % 3}" for i in range(DRILL_STREAMS)]

    def obs_hooks(work):
        reg = TelemetryRegistry()
        lat = LatencyTracker(registry=reg)
        slo = SloTracker([parse_slo("tick=1s@p99")], registry=reg, quantile_source=lat.quantile)
        tr = TraceRecorder()
        return dict(latency=lat, slo=slo, trace=tr, attributor=AlertAttributor(cfg),
                    flight=FlightRecorder(trace=tr, n_ticks=64, registry=reg,
                                          out_dir=os.path.join(work, "pm")))

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
                            predictor=PredictTracker(8, registry=TelemetryRegistry()),
                            **obs_hooks(work)) if on else {}
            path = os.path.join(work, f"{name}.jsonl")
            tl.reset_launches()
            t0 = time.perf_counter()
            stats = live_loop(source, reg, n_ticks=DRILL_TICKS, cadence_s=0.0, alert_path=path,
                              pipeline_depth=2, **trackers)
            torch.cuda.synchronize()
            lines = [ln for ln in open(path) if not ln.startswith('{"event"')]
            runs[name] = dict(reg=reg, stats=stats, launches=tl.launches,
                              seconds=time.perf_counter() - t0, lines=lines,
                              # the alert records without their attribution block
                              records=[json.dumps({k: v for k, v in json.loads(ln).items()
                                                   if k != "top_fields"}) + "\n"
                                       for ln in lines] if on else lines,
                              top_fields=sum('"top_fields"' in ln for ln in lines),
                              bundles_valid=all(validate_bundle(b)["ok"] for b in
                                                stats.get("postmortem", {}).get("bundle_paths",
                                                                                [])))
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
        # byte-equal once the attribution block is removed
        "alert_lines_equal": on["records"] == off["lines"],
        "alert_lines": len(on["lines"]) == DRILL_STREAMS * DRILL_TICKS,
        "top_fields": on["top_fields"] == len(on["lines"]),
        "obs_on": on["stats"]["latency"]["ticks"] == DRILL_TICKS
                  and on["stats"]["slo"]["slos"][0]["samples"] == DRILL_TICKS
                  and on["stats"]["postmortem"]["ticks_recorded"] == DRILL_TICKS
                  and on["bundles_valid"],
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
               on_hooks=["health", "predict 8", "latency", "slo tick=1s@p99", "trace",
                         "flight", "attribution"],
               model_leaves_compared=compared, alert_lines=len(on["lines"]),
               alert_lines_with_top_fields=on["top_fields"],
               latency_on=on["stats"]["latency"]["stages"]["tick"],
               slo_on=on["stats"]["slo"], postmortem_on=on["stats"]["postmortem"],
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


def _predict_eval_here(tag: str, *argv: str) -> dict:
    """predict_eval's main in this process -> its result line."""
    import contextlib
    import io

    from rtap_tpu_torch.predict_eval import main as pe_main

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = pe_main(list(argv))
    part(f"predict_eval {tag}", time.perf_counter() - t)
    if rc != 0:
        raise AssertionError(f"predict_eval {tag} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


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
        procs.append(spawn_child(cmd, cwd=root, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True))
        return procs[-1]

    t0 = time.perf_counter()
    try:
        card_res = _predict_eval_here("card", "--device", "cuda")
        cuda_s = time.perf_counter() - t0
        cpu_res = BG.result("cascade_cpu")
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
        t_kill = time.perf_counter()
        p = start(cmd)
        kill, seen, pos = None, "", 0
        deadline = time.monotonic() + DEADLINE.cap(600)
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
        p.communicate(timeout=DEADLINE.cap(900))
        if kill is None:
            raise AssertionError(f"the first precursor never reached the stream (rc {p.returncode})")
        kill["rc"] = p.returncode
        part("predict_eval killed child", time.perf_counter() - t_kill)
        final = _predict_eval_here("resumed", *cmd[3:])
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
    """`python -m rtap_tpu_torch nab` on data/nab (its main, in this
    process) -> (its report, its per-row detections by key)."""
    from rtap_tpu_torch.__main__ import main as cli

    out, det = os.path.join(work, f"{tag}.json"), os.path.join(work, f"{tag}.npz")
    secs, _ = _in_process(cli, ["nab", "--device", device, "--out", out, "--detections", det,
                                *extra])
    part(f"nab {tag}", secs, device=device)
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
        with timed_part("kernel vs plain on the final state"):
            krow = compare_pass("nab_corpus_group_final", lp, kernel_reps=20, plain_reps=3)
        krow.update(learning_ticks_before=NAB_ROWS, card=card)
        emit("kernel_vs_plain", **krow)
        del lp
        torch.cuda.empty_cache()
        # card == CPU on a prefix of one file, at full width
        extra = ("--rows", str(NAB_CPU_ROWS), "--subset", NAB_CPU_SUBSET)
        prefix = dict(args=list(extra), **_nab_same(_nab_run("cuda", work, "prefix_card", *extra),
                                                    BG.result("nab_prefix")))
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


def _classifier_cfg():
    import dataclasses

    from rtap_tpu_torch.config import ClassifierConfig, cluster_preset

    return dataclasses.replace(cluster_preset(), classifier=ClassifierConfig(enabled=True))


def _classifier_run(dev: str, seed: int) -> dict:
    """Phase 13's CLS_TICKS learning ticks of CLS_STREAMS seeded streams on
    `dev` -> raw, predictions, probabilities, state, launches, seconds."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.models.state import init_state, state_to_numpy
    from rtap_tpu_torch.ops.step import chunk_step, replicate_state_device

    cfg = _classifier_cfg()
    streams = cluster_streams(CLS_STREAMS, CLS_TICKS, seed + 2, n_anomalies=0)
    vals = torch.from_numpy(np.stack([s.values for s in streams], 1)[:, :, None])
    ts = torch.from_numpy(np.stack([s.timestamps for s in streams], 1).astype(np.int32))
    st = replicate_state_device(init_state(cfg, seed), CLS_STREAMS, dev)
    tl.reset_launches()
    t0 = time.perf_counter()
    st, (raw, pred, prob) = chunk_step(st, vals.to(dev), ts.to(dev), cfg)
    if dev == "cuda":
        torch.cuda.synchronize()
    return dict(raw=raw.cpu().numpy(), pred=pred.cpu().numpy(), prob=prob.cpu().numpy(),
                state=state_to_numpy(st), launches=tl.launches, seconds=time.perf_counter() - t0)


def phase_classifier(seed: int, card: str) -> dict:
    """cluster_preset with the SDR classifier at G = 64 over CLS_TICKS learning
    ticks on the card and on the CPU: raw, every other leaf and cls_cnt bit
    for bit, cls_w at rtol 1e-5 / atol 1e-6, predictions and probabilities
    within 1e-4."""
    from rtap_tpu_torch.models.state import state_nbytes

    cfg = _classifier_cfg()
    c, p = _classifier_run("cuda", seed), BG.result("classifier_cpu")
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
    if torch.cuda.is_available():  # the background CPU references have no card
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

    def run(tag, streams, length, *flags):
        out = os.path.join(work, f"eval_{tag}.json")
        secs, launches = _in_process(cli, ["eval", "--device", "cuda", "--streams", str(streams),
                                           "--length", str(length), "--out", out, *flags])
        part(f"eval {tag}", secs, device="cuda", streams=streams, length=length)
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

    # (b) card == CPU at 12 streams x 850, streaming (the CPU's in the background)
    length = EVAL_CPU_LENGTH
    reps = {"cuda": run("cpu_check_cuda", EVAL_CPU_STREAMS, length),
            "cpu": BG.result("eval_cpu")}
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
    part("eval 1k generator's event count (host)", gen_s)
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
    part("workload_eval", secs, streams=streams, length=length)
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
    with timed_part("log template eval", device="cuda", streams=4, length=length):
        runs = {"cuda": we.run_log_template_eval(n_streams=4, length=length, device="cuda",
                                                 seed=seed)}
    runs["cpu"] = BG.result("log_template_cpu")
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
    part("node_eval", secs, nodes=nodes, length=length)
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
    with timed_part("node eval card vs CPU", device="cuda", nodes=n_cpu, length=t_cpu):
        small = {"cuda": node_eval.run_node_eval(n_cpu, t_cpu, device="cuda")}
    small["cpu"] = BG.result("node_cpu")
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
    part("held-out cell", h_s, streams=streams, length=hlen)
    with timed_part("held-out generator's event count (host)"):
        gen = _event_counts(fault_streams(streams, hlen, ANOMALY_KINDS, mag, cfg, seed,
                                          "heldout"))
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


def _chaos_soak(argv: list[str], work: str, tag: str) -> tuple[int, dict, float]:
    """``python -m rtap_tpu_torch.chaos_soak`` (its main, in this process,
    on cuda) -> (exit code, report, seconds); its report line is kept off
    this script's stdout."""
    import contextlib
    import io

    from rtap_tpu_torch import chaos_soak

    out = os.path.join(work, f"{tag}.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = chaos_soak.main([*argv, "--device", "cuda", "--workdir", os.path.join(work, tag),
                              "--out", out])
    seconds = time.perf_counter() - t0
    part(f"chaos_soak {tag}", seconds)
    return rc, (json.load(open(out)) if os.path.exists(out) else {}), seconds


def phase_resilience(card: str) -> dict:
    """``rtap_tpu_torch.chaos_soak`` on the card: the seeded soak at full
    width with an injected restore and its fault-free twin, the
    degradation drill, the supervised kill drill, the topology burst."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.resilience import ChaosSpec

    c = CHAOS_SOAK
    work = tempfile.mkdtemp(prefix="rtap-chaos-")
    soak_args = ["--seed", str(c["seed"]), "--streams", str(c["streams"]),
                 "--group-size", str(c["group_size"]), "--ticks", str(c["ticks"]),
                 "--cadence", str(c["cadence"]), "--checkpoint-every", str(c["checkpoint_every"]),
                 "--restore-after", str(c["restore_after"]), "--rate", str(c["rate"])]
    try:
        rc, soak, soak_s = _chaos_soak(
            [*soak_args, *(a for f in CHAOS_INJECT for a in ("--inject", f)), "--twin"],
            work, "soak")
        # the schedule this process draws on the host, beside the card run's
        host_digest = ChaosSpec.generate(seed=c["seed"], n_ticks=c["ticks"],
                                         n_groups=c["streams"] // c["group_size"],
                                         rate=c["rate"]).digest()
        d = DEGRADE_DRILL
        drc, deg, deg_s = _chaos_soak(
            ["--degrade", "--seed", str(c["seed"]), "--streams", str(d["streams"]),
             "--group-size", str(d["group_size"]), "--ticks", str(d["ticks"]),
             "--cadence", str(d["cadence"])], work, "degrade")
        src, sup, sup_s = _chaos_soak(
            ["--supervise", "--kills", str(SUPERVISE_KILLS), "--seed", str(c["seed"]),
             "--streams", str(DRILL_STREAMS), "--group-size", str(DRILL_GROUP),
             "--ticks", str(DRILL_TICKS), "--cadence", "0", "--rate", str(c["rate"]),
             "--checkpoint-every", str(DRILL_CHECKPOINT_EVERY)], work, "supervise")
        launches0 = tl.launches
        trc, topo, topo_s = _chaos_soak(
            ["--topology-burst", "--seed", str(c["seed"]), "--streams", "12",
             "--group-size", "4", "--ticks", "120", "--cadence", "0"], work, "topology")
        topo_launches = tl.launches - launches0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    stats = soak.get("stats", {})
    last = sup.get("last_life") or {}
    checks = {
        "soak_verified": rc == 0 and soak.get("verified") is True,
        "soak_digest": soak.get("schedule_digest") == host_digest,
        "soak_restored": soak.get("quarantines", 0) >= 1
                         and soak.get("restores") == soak.get("quarantines")
                         and soak.get("unrestored") == [],
        "soak_twin": bool(soak.get("twin", {}).get("groups_compared"))
                     and soak["twin"]["leaves_equal"] is True,
        "soak_launches": soak.get("kernel_launches") == stats.get("learned_group_ticks"),
        "degrade": drc == 0 and deg.get("verified") is True
                   and deg["degradation"]["max_level"] >= 1 and deg["degradation"]["level"] == 0
                   and deg["kernel_launches"] == deg["learned_group_ticks"]
                   < deg["group_ticks"],
        "supervise": src == 0 and sup.get("verified") is True
                     and sup["deaths"] == sup["restarts"] == SUPERVISE_KILLS
                     and sup["ticks_completed"] == DRILL_TICKS
                     and sup["journal_replay_events"] >= SUPERVISE_KILLS
                     and sup["duplicated"] == 0
                     and last.get("kernel_launches") == last.get("learned_group_ticks"),
        "topology_burst": trc == 0 and topo.get("verified") is True and topo["incidents"] == 1,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"resilience on the card failed {bad}: soak "
                             f"{ {k: soak.get(k) for k in ('failures', 'quarantines', 'restores', 'unrestored', 'twin', 'schedule_digest')} }, "
                             f"degrade {deg.get('failures')} {deg.get('degradation')}, "
                             f"supervise {sup.get('failures')}, topology {topo.get('failures')}")
    row = dict(soak=dict(**c, inject=list(CHAOS_INJECT), seconds=soak_s,
                         schedule_digest=soak["schedule_digest"], host_digest=host_digest,
                         run_digest=soak["run_digest"], faults_injected=soak["faults_injected"],
                         quarantines=soak["quarantines"], restores=soak["restores"],
                         restore_s=stats.get("restore_s"), twin=soak["twin"],
                         scored_by_group=stats["scored_by_group"],
                         latency_p50_ms=stats["latency_p50_ms"],
                         latency_p99_ms=stats["latency_p99_ms"],
                         phase_ms_per_tick=stats["phase_ms_per_tick"],
                         group_save_s_mean=stats.get("group_save_s_mean"),
                         checkpoint_save_failures=stats.get("checkpoint_save_failures", 0),
                         postmortem_bundles=len(soak["postmortem"]["bundles"]),
                         kernel_launches=soak["kernel_launches"],
                         learned_group_ticks=stats["learned_group_ticks"]),
               degrade=dict(**DEGRADE_DRILL, seconds=deg_s, degradation=deg["degradation"],
                            hang_ticks=deg["hang_ticks"], events=deg["events"],
                            missed_deadlines=deg["missed_deadlines"],
                            kernel_launches=deg["kernel_launches"],
                            learned_group_ticks=deg["learned_group_ticks"],
                            group_ticks=deg["group_ticks"]),
               supervise=dict(streams=DRILL_STREAMS, groups=DRILL_STREAMS // DRILL_GROUP,
                              ticks=DRILL_TICKS, kills=SUPERVISE_KILLS, seconds=sup_s,
                              proc_exit_ticks=sup["proc_exit_ticks"], deaths=sup["deaths"],
                              restarts=sup["restarts"], alert_ids=sup["alert_ids"],
                              journal_replay_events=sup["journal_replay_events"],
                              last_life=last),
               topology_burst=dict(streams=12, group_size=4, ticks=120, seconds=topo_s,
                                   burst_nodes=topo["burst_nodes"],
                                   burst_groups=topo["burst_groups"], incidents=1,
                                   kernel_launches=topo_launches),
               card=card)
    emit("resilience", **row)
    return row


def phase_obs_cost(card: str) -> dict:
    """``obs/selfbench``'s measures in this process, on the card's host
    while the card is warm: each at most 1% of the 1 s tick budget."""
    from rtap_tpu_torch.obs.selfbench import GATE_BUDGET_FRAC, GATE_MEASURES

    results = {name: fn() for name, fn in GATE_MEASURES}
    bad = {n: r["per_tick_overhead_frac"] for n, r in results.items()
           if not r["per_tick_overhead_frac"] <= GATE_BUDGET_FRAC}
    if bad:
        raise AssertionError(f"obs cost over {GATE_BUDGET_FRAC:.0%} of the tick budget: {bad}")
    row = dict(budget_frac=GATE_BUDGET_FRAC, measures=results, card=card)
    emit("obs_cost", **row)
    return row


def _binary_feed(ticks: list[list[dict]]) -> list[tuple]:
    """Record lists -> one (values [N] f32, ts) per fed tick (every stream
    of a synthetic tick shares its timestamp)."""
    feed = []
    for recs in ticks:
        if len({r["ts"] for r in recs}) != 1:
            raise AssertionError("a fed tick spans several timestamps")
        feed.append((np.array([r["value"] for r in recs], np.float32), recs[0]["ts"]))
    return feed


def _journal_records(journal_dir: str) -> list:
    """(tick, ts, TICK row or JournaledFrames) of every record in a journal."""
    from rtap_tpu_torch.resilience.journal import TickJournal

    j = TickJournal(journal_dir)
    try:
        return list(j.recovered_ticks)
    finally:
        j.close()


def phase_binary_serve(seed: int, card: str, serve_row: dict) -> dict:
    """21(a): `serve --ingest-port 0` at phase 6's shape (32,768 streams in
    8 groups of 4,096, depth 2, 1 s cadence, BINARY_SERVE_TICKS learning ticks, the journal,
    no checkpoint dir) fed phase 6's seeded ticks as one RB1 DATA frame per
    tick over a persistent BinaryFeedConnection, in step with the child's
    journal."""
    from rtap_tpu_torch.resilience.journal import JournaledFrames

    work = tempfile.mkdtemp(prefix="rtap-binserve-")
    # phase 6's seeded ticks, the first BINARY_SERVE_TICKS - 1 of them
    ids, ticks = serve_row["feed"]
    feed = _binary_feed(ticks[:BINARY_SERVE_TICKS - 1])
    frames: list[bytes] = []
    try:
        stats, sent, _ = _serve_child(ids, feed, work, [], transport="binary",
                                      n_ticks=BINARY_SERVE_TICKS, frames_out=frames)
        missed = _missed_ticks(os.path.join(work, "alerts.jsonl"))
        records = _journal_records(os.path.join(work, "journal"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    groups = SERVE_STREAMS // SERVE_GROUP
    # tick t + 1 polled the frame sent after tick t: its FRAME record holds
    # exactly that frame; tick 0 polled nothing and journals no frame
    want = [b""] + frames
    got = [r[2].blob if isinstance(r[2], JournaledFrames) else None for r in records]
    tel = _telemetry(stats)
    checks = {
        "ticks": stats["ticks"] == BINARY_SERVE_TICKS,
        "scored": stats["scored"] == BINARY_SERVE_TICKS * SERVE_STREAMS,
        "missing_values": stats["missing_values"] == SERVE_STREAMS,
        "rows_sent": sent == (BINARY_SERVE_TICKS - 1) * SERVE_STREAMS,
        "rows_parsed": stats["records_parsed"] == sent,
        "frames_applied": stats["frames_applied"] == BINARY_SERVE_TICKS - 1,
        "clean": all(stats[k] == 0 for k in (
            "garbage_bytes", "parse_errors", "unknown_ids", "rows_quota_dropped",
            "rows_late_dropped", "rows_backpressure_dropped", "rows_stale_epoch")),
        "native_active": stats["native_active"] is True,
        "tm_overflow_total": stats["tm_overflow_total"] == 0,
        "kernel_launches": stats["kernel_launches"]["tm_learn"] == groups * BINARY_SERVE_TICKS,
        "missed_ticks": all(t == 0 for t, _ in missed)
                        and len(missed) == stats["missed_deadlines"],
        "frame_records": [r[0] for r in records] == list(range(BINARY_SERVE_TICKS))
                         and got == want,
        "telemetry": (tel["rtap_obs_ingest_records_total"], tel["rtap_obs_ingest_frames_total"])
                     == (stats["records_parsed"], stats["frames_applied"]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"binary serve checks failed {bad} (rows sent {sent}, missed "
                             f"{missed}, journal ticks {[r[0] for r in records][:50]}): "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }")
    row = dict(preset="cluster_preset", transport="RB1 over --ingest-port",
               streams=SERVE_STREAMS, group_size=SERVE_GROUP, groups=groups,
               ticks=stats["ticks"], cadence_s=stats["cadence_s"],
               pipeline_depth=stats["pipeline_depth"], scored=stats["scored"],
               missing_values=stats["missing_values"], rows_sent=sent,
               rows_parsed=stats["records_parsed"], frames_applied=stats["frames_applied"],
               frame_bytes=len(frames[0]), native_active=stats["native_active"],
               latency_p50_ms=stats["latency_p50_ms"], latency_p90_ms=stats["latency_p90_ms"],
               latency_p99_ms=stats["latency_p99_ms"], latency_max_ms=stats["latency_max_ms"],
               missed_deadlines=stats["missed_deadlines"], missed_ticks=missed,
               phase_ms_per_tick=stats["phase_ms_per_tick"],
               phase6_jsonl=dict(latency_p50_ms=serve_row["latency_p50_ms"],
                                 latency_p99_ms=serve_row["latency_p99_ms"],
                                 phase_ms_per_tick=serve_row["phase_ms_per_tick"]),
               journal_frame_records=len(records),
               journal_bytes=stats["journal"]["appended_bytes"],
               journal_bytes_per_tick=stats["journal"]["appended_bytes"] / stats["ticks"],
               journal_append_ms_per_tick=stats["journal"]["append_ms_per_tick"],
               phase6_journal_append_ms_per_tick=serve_row["journal_append_ms_per_tick"],
               elapsed_s=stats["elapsed_s"],
               hbm_peak_bytes_in_use=stats["hbm_peak_bytes_in_use"],
               kernel_launches=stats["kernel_launches"]["tm_learn"], card=card)
    emit("binary_serve", **row)
    return row


def _drill_source(seed: int, n: int, ts0: int = 1_700_000_000):
    """Phase 9's seeded drill feed: tick k -> (values [n] f32, ts0 + k),
    one stream spiking each tick."""
    def source(k):
        rng = np.random.Generator(np.random.Philox(key=(seed, k)))
        v = (30 + 5 * rng.random(n)).astype(np.float32)
        v[k % n] += 30.0
        return v, ts0 + k
    return source


def _alert_bytes(path: str) -> dict:
    """Alert lines by alert_id (event lines left out). Tick 0 polls nothing
    in a serve child, so its lines carry the wall clock's ts: those compare
    without it, every other line byte for byte."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith('{"event"'):
                continue
            rec = json.loads(line)
            if rec["alert_id"].endswith(":0"):
                rec.pop("ts")
                line = json.dumps(rec)
            out[rec["alert_id"]] = line
    return out


def phase_transports(seed: int, card: str) -> dict:
    """21(b): the drill's shape (2 groups of 1,024, 32 ticks, cadence 0,
    threshold 0: every stream alerts every tick) through live_loop on the
    card three times, in lockstep (push a tick's rows, wait until they are
    counted, poll): TcpJsonlSource (native parser), BinaryBatchSource over
    its socket, and BinaryBatchSource(shm=...) fed through a ShmRing
    attached by name. Alert lines and final leaves must be equal."""
    import platform

    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.ingest import BinaryBatchSource, BinaryFeedConnection, ShmRing
    from rtap_tpu_torch.ingest.protocol import data_frame
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry
    from rtap_tpu_torch.service.sources import TcpJsonlSource, send_jsonl

    cfg = cluster_preset()
    ids = [f"n{i // 3}.m{i % 3}" for i in range(DRILL_STREAMS)]
    feed = _drill_source(seed, DRILL_STREAMS)
    work = tempfile.mkdtemp(prefix="rtap-transports-")
    runs = {}

    def lockstep(src, push, counted):
        def source(k):
            values, ts = feed(k)
            want = counted() + push(values, ts)
            deadline = DEADLINE.until(60)
            while counted() < want and time.time() < deadline:
                time.sleep(0.0005)
            if counted() != want:
                raise AssertionError(f"tick {k}: {counted()} of {want} rows counted")
            return src(k)
        return source

    try:
        for name in ("jsonl", "socket", "shm"):
            reg = StreamGroupRegistry(cfg, group_size=DRILL_GROUP, device="cuda", threshold=0.0,
                                      debounce=1)
            for sid in ids:
                reg.add_stream(sid)
            reg.finalize()
            ring = conn = None
            if name == "jsonl":
                src = TcpJsonlSource(reg.dispatch_ids()).start()
                if not src.native_active:
                    raise AssertionError("the JSONL source did not load its native parser")

                def push(values, ts, src=src):
                    return send_jsonl(src.address, [{"id": sid, "value": float(v), "ts": ts}
                                                    for sid, v in zip(ids, values)])
                source = lockstep(src, push, lambda src=src: src.records_parsed)
            elif name == "socket":
                src = BinaryBatchSource(reg.slot_map()).start()
                conn = BinaryFeedConnection(src.address, timeout_s=60.0)

                def push(values, ts, conn=conn):
                    return conn.send_rows(ids, values, ts)
                source = lockstep(src, push, lambda src=src: src.records_parsed)
            else:
                ring_name = f"rtap_smoke_{os.getpid()}"
                src = BinaryBatchSource(reg.slot_map(), port=None, shm=ring_name)
                ring = ShmRing.attach(ring_name)
                codes = src._table.codes  # the registry's order is the ids' order

                def source(k, src=src, ring=ring, codes=codes):
                    # the poll drains the ring itself: push, then poll
                    values, ts = feed(k)
                    if not ring.push(data_frame(codes, values, ts)):
                        raise AssertionError(f"tick {k}: the shm ring refused a frame")
                    return src(k)
            path = os.path.join(work, f"{name}.jsonl")
            tl.reset_launches()
            t0 = time.perf_counter()
            try:
                stats = live_loop(source, reg, n_ticks=DRILL_TICKS, cadence_s=0.0,
                                  alert_path=path, pipeline_depth=2)
                torch.cuda.synchronize()
            finally:
                if conn is not None:
                    conn.close()
                if ring is not None:
                    ring.close()
                src.close()
            part(f"transport {name}", time.perf_counter() - t0)
            runs[name] = dict(
                stats=stats, launches=tl.launches, seconds=time.perf_counter() - t0,
                lines=[ln for ln in open(path) if not ln.startswith('{"event"')],
                leaves=[{**state_to_numpy(g.state),
                         **{f"likelihood/{k}": np.asarray(v)
                            for k, v in g.likelihood.state_dict().items()}}
                        for g in reg.groups],
                ingest={k: getattr(src, k, None) for k in (
                    "records_parsed", "parse_errors", "unknown_ids", "garbage_bytes",
                    "frames_applied", "native_active")})
            del reg
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ref = runs["jsonl"]
    failures = []
    for name in ("socket", "shm"):
        r = runs[name]
        if r["lines"] != ref["lines"]:
            failures.append(f"{name}: alert lines differ from JSONL's")
        for gi, (a, b) in enumerate(zip(ref["leaves"], r["leaves"])):
            bad = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(
                a[k], b[k], equal_nan=a[k].dtype.kind == "f")]
            if bad or a.keys() != b.keys():
                failures.append(f"{name}: group {gi} leaves differ {bad[:6]}")
    for name, r in runs.items():
        if len(r["lines"]) != DRILL_STREAMS * DRILL_TICKS:
            failures.append(f"{name}: {len(r['lines'])} alert lines")
        if r["launches"] != r["stats"]["learned_group_ticks"] or r["launches"] != 2 * DRILL_TICKS:
            failures.append(f"{name}: launches {r['launches']} vs learned group ticks "
                            f"{r['stats']['learned_group_ticks']}")
        # the shm ring is safe on total-store-order hosts only: on aarch64 a
        # torn read is counted (garbage, bad CRC), reported, not gated
        torn_ok = name == "shm" and platform.machine() == "aarch64"
        if r["stats"]["missing_values"] or r["ingest"]["unknown_ids"] or (
                not torn_ok and (r["ingest"]["parse_errors"] or r["ingest"]["garbage_bytes"])):
            failures.append(f"{name}: ingest not clean {r['ingest']}, missing "
                            f"{r['stats']['missing_values']}")
    if failures:
        raise AssertionError(f"transports differ: {failures}")
    row = dict(streams=DRILL_STREAMS, groups=2, ticks=DRILL_TICKS,
               transports=["jsonl (native parser)", "RB1 socket", "RB1 shm ring"],
               alert_lines=len(ref["lines"]), leaves_equal=sum(len(x) for x in ref["leaves"]),
               launches={k: r["launches"] for k, r in runs.items()},
               seconds={k: r["seconds"] for k, r in runs.items()},
               phase_ms_per_tick={k: r["stats"]["phase_ms_per_tick"] for k, r in runs.items()},
               ingest={k: r["ingest"] for k, r in runs.items()},
               machine=platform.machine(), card=card)
    emit("transports_equal", **row)
    return row


def _binary_kill_reference(work: str, feed: list) -> dict:
    """21(c)'s uninterrupted run, in this process: the serve child's
    registry and loop (cluster preset, 2 groups of 1,024, threshold 0,
    debounce 1, depth 2, checkpoints every 16) over the values its lives
    are fed, tick 0 polling nothing as theirs does -> the loop's stats."""
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    ids = [f"n{i // 3}.m{i % 3}" for i in range(DRILL_STREAMS)]
    reg = StreamGroupRegistry(cluster_preset(), group_size=DRILL_GROUP, device="cuda",
                              threshold=0.0, debounce=1)
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()

    def source(k):
        if k == 0:
            return np.full(DRILL_STREAMS, np.nan, np.float32), int(time.time())
        return feed[k - 1]

    stats = live_loop(source, reg, n_ticks=DRILL_TICKS, cadence_s=0.0,
                      alert_path=os.path.join(work, "alerts.jsonl"),
                      checkpoint_dir=os.path.join(work, "ck"),
                      checkpoint_every=DRILL_CHECKPOINT_EVERY, pipeline_depth=2)
    torch.cuda.synchronize()
    del reg
    torch.cuda.empty_cache()
    return stats


def phase_binary_kill(seed: int, card: str) -> dict:
    """21(c): `serve --ingest-port 0 --journal-dir J --checkpoint-dir C` at
    the drill's shape (2 groups of 1,024, 32 ticks at BINARY_DRILL_CADENCE
    s, checkpoints every 16, threshold 0), fed the drill's seeded ticks by
    the journal-gated binary feeder: SIGKILLed when its journal reaches
    BINARY_KILL_AT and restarted over the same directories, fed on from the
    restart's resume base; held to the uninterrupted run of the same loop in
    this process over the same values."""
    from rtap_tpu_torch.resilience.journal import last_journal_tick

    root = tempfile.mkdtemp(prefix="rtap-binkill-")
    ids = [f"n{i // 3}.m{i % 3}" for i in range(DRILL_STREAMS)]
    # timestamps ahead of the wall clock that tick 0 (fed nothing) takes, so
    # the loop's monotonic clamp never rewrites a fed tick's ts
    src = _drill_source(seed, DRILL_STREAMS, ts0=int(time.time()) + 3600)
    # feed[t] is what tick t + 1 polls; tick 0 polls nothing in every run
    feed = [src(t + 1) for t in range(DRILL_TICKS - 1)]
    extra = lambda work: ["--checkpoint-dir", os.path.join(work, "ck"),  # noqa: E731
                          "--checkpoint-every", str(DRILL_CHECKPOINT_EVERY),
                          "--threshold=0.0", "--debounce", "1"]

    def life(work, **kw):
        return _serve_child(ids, feed, work, extra(work), group=DRILL_GROUP,
                            n_ticks=DRILL_TICKS, transport="binary",
                            cadence=BINARY_DRILL_CADENCE, **kw)

    t0 = time.perf_counter()
    try:
        ref_dir, crash_dir = os.path.join(root, "ref"), os.path.join(root, "crash")
        os.makedirs(ref_dir)
        os.makedirs(crash_dir)
        ref_stats = _binary_kill_reference(ref_dir, feed)
        ref_s = time.perf_counter() - t0
        part("uninterrupted reference (in this process)", ref_s)
        killed, _, _ = life(crash_dir, kill_at=BINARY_KILL_AT)
        if killed is not None:
            raise AssertionError("the first life was not killed")
        base = last_journal_tick(os.path.join(crash_dir, "journal")) + 1
        t1 = time.perf_counter()
        last, _, err = life(crash_dir, start=base - 1)
        resumed_s = time.perf_counter() - t1
        want, ref_dup, _ = _drill_records(os.path.join(ref_dir, "alerts.jsonl"))
        got, dup, torn = _drill_records(os.path.join(crash_dir, "alerts.jsonl"))
        ref_lines = _alert_bytes(os.path.join(ref_dir, "alerts.jsonl"))
        got_lines = _alert_bytes(os.path.join(crash_dir, "alerts.jsonl"))
        ref_ck = _drill_checkpoints(os.path.join(ref_dir, "ck"))
        got_ck = _drill_checkpoints(os.path.join(crash_dir, "ck"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failures = []
    jr = last["journal"]
    if not (jr["replayed_ticks"] > 0 and jr["skipped_rows"] == 0):
        failures.append(f"the restart replayed {jr['replayed_ticks']} ticks, skipped "
                        f"{jr['skipped_rows']}")
    if f"resuming at tick {base} " not in err:
        failures.append(f"the restart did not resume at tick {base}")
    if last["kernel_launches"]["tm_learn"] != last["learned_group_ticks"]:
        failures.append(f"resumed launches {last['kernel_launches']} vs learned group ticks "
                        f"{last['learned_group_ticks']}")
    if ref_dup or dup or torn:
        failures.append(f"duplicated alert ids {len(dup)} (reference {len(ref_dup)}), "
                        f"torn {torn}")
    if got.keys() != want.keys():
        failures.append(f"alert ids differ: {len(want.keys() - got.keys())} lost, "
                        f"{len(got.keys() - want.keys())} extra")
    if got_lines != ref_lines:
        failures.append("alert lines differ from the reference's")
    if ref_stats["missing_values"] != DRILL_STREAMS or last["missing_values"] != 0:
        failures.append(f"missing values: reference {ref_stats['missing_values']}, resumed "
                        f"life {last['missing_values']} (the feeder fell behind a poll)")
    if ref_stats["kernel_launches"]["tm_learn"] != 2 * DRILL_TICKS:
        failures.append(f"reference launches {ref_stats['kernel_launches']}")
    leaves = 0
    if ref_ck.keys() != got_ck.keys():
        failures.append(f"checkpoint groups differ: {sorted(ref_ck)} vs {sorted(got_ck)}")
    for name in sorted(ref_ck.keys() & got_ck.keys()):
        (rt, rtree), (gt, gtree) = ref_ck[name], got_ck[name]
        if rt != gt or rt != DRILL_TICKS:
            failures.append(f"{name}: final ticks {gt} vs reference {rt}")
        rl, gl = dict(_flat(rtree)), dict(_flat(gtree))
        if rl.keys() != gl.keys():
            failures.append(f"{name}: state leaves differ")
            continue
        for k in rl:
            leaves += 1
            a, b = rl[k], gl[k]
            if a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
                failures.append(f"{name}/{k}: diverges from the reference")
    if failures:
        raise AssertionError(f"binary kill drill failed: {failures}")
    row = dict(streams=DRILL_STREAMS, groups=2, ticks=DRILL_TICKS,
               cadence_s=BINARY_DRILL_CADENCE, checkpoint_every=DRILL_CHECKPOINT_EVERY,
               kill_at_journal_tick=BINARY_KILL_AT, resume_base=base,
               replayed_frame_ticks=jr["replayed_ticks"], skipped_rows=jr["skipped_rows"],
               replay_seconds=jr["replay_seconds"], alert_ids=len(want), duplicated=0,
               lost=0, state_leaves_equal=leaves,
               reference_launches=ref_stats["kernel_launches"]["tm_learn"],
               resumed_launches=last["kernel_launches"]["tm_learn"],
               resumed_learned_group_ticks=last["learned_group_ticks"],
               journal_append_ms_per_tick=last["journal"]["append_ms_per_tick"],
               reference_s=ref_s, resumed_life_s=resumed_s,
               seconds=time.perf_counter() - t0, card=card)
    emit("binary_kill_drill", **row)
    return row


def phase_ingest_bench(card: str) -> dict:
    """21(d): `python -m rtap_tpu_torch.ingest_bench` (host work, no device)
    at the JAX package's defaults; fails when either of the JAX package's
    gates fails (binary >= 1M rows/s, >= 5x the native JSONL TCP path)."""
    import platform

    with timed_part("ingest_bench child"):
        out = run_child([sys.executable, "-m", "rtap_tpu_torch.ingest_bench"], timeout=900,
                        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"ingest bench printed nothing (rc {out.returncode}):\n"
                             f"{out.stderr[-3000:]}")
    res = json.loads(lines[-1])
    row = dict(res, machine=platform.machine(), card=card)
    emit("ingest_bench", **row)
    if out.returncode != 0 or not (res["gate_binary_1m_rows_per_sec"]
                                   and res["gate_binary_5x_jsonl"]):
        raise AssertionError(f"ingest gates failed (rc {out.returncode}): binary socket "
                             f"{res['binary_socket_end_to_end']}, native JSONL socket "
                             f"{res['native_socket_end_to_end']}")
    return row


def phase_binary_ingest(seed: int, card: str, serve_row: dict) -> dict:
    """Phase 21: (a)-(d), each with its own seconds."""
    import platform

    parts, seconds = {}, {}
    for key, fn in (("a", lambda: phase_binary_serve(seed, card, serve_row)),
                    ("b", lambda: phase_transports(seed, card)),
                    ("c", lambda: phase_binary_kill(seed, card)),
                    ("d", lambda: phase_ingest_bench(card))):
        t0 = time.perf_counter()
        parts[key] = fn()
        seconds[key] = round(time.perf_counter() - t0, 3)
        torch.cuda.empty_cache()
    emit("binary_ingest", seconds=seconds, machine=platform.machine(), card=card)
    return parts


# ---------------------------------------------------------------- phase 22
def _leaf_digest(a: np.ndarray) -> str:
    """The first 16 hex digits of sha256(dtype, shape, bytes)."""
    import hashlib

    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).data)
    return h.hexdigest()[:16]


def _ck_digest(ckdir: str) -> dict:
    """Per-leaf digest of a checkpoint dir's state: {group/state/.../leaf.npy:
    the first 16 hex digits of sha256(dtype, shape, bytes)}, plus each
    group's tick cursor. Leaves hash on 8 threads (np.load and hashlib
    release the GIL on large buffers)."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    root = Path(ckdir)
    groups = [d for d in sorted(root.iterdir()) if re.fullmatch(r"group\d{4,}", d.name)]

    def one(p: Path):
        return p.relative_to(root).as_posix(), _leaf_digest(np.load(p, allow_pickle=False))

    with ThreadPoolExecutor(8) as ex:
        out = dict(ex.map(one, [p for g in groups for p in sorted((g / "state").rglob("*.npy"))]))
    for g in groups:
        out[f"{g.name}/ticks"] = json.loads((g / "meta.json").read_text())["ticks"]
    return out


def _lease_watch(path: str, stop: threading.Event, out: dict) -> threading.Thread:
    """Poll the lease file every 10 ms from a thread: per owner, the largest
    gap between two successive heartbeat stamps this process saw."""
    def run():
        last: dict = {}
        while not stop.is_set():
            try:
                cur = json.loads(Path(path).read_text())
            except (OSError, ValueError):
                cur = None
            if cur is not None:
                owner, ts = cur.get("owner"), float(cur.get("ts", 0))
                if owner in last and ts > last[owner]:
                    out[owner] = max(out.get(owner, 0.0), ts - last[owner])
                last[owner] = ts
            stop.wait(0.01)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _gpu_apps() -> str:
    """nvidia-smi's per-process memory table (empty where the host hides
    it)."""
    p = run_child(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                   "--format=csv,noheader"], timeout=60)
    return p.stdout.strip()


def _failover_pair(ids: list[str], ticks: list, work: str, children: list) -> dict:
    """22(a)'s two serve children and its feeder (this thread): the leader
    (--replicate-to, the lease, the journal, checkpoints, --latency and
    --obs-port for the scrape before its death) and the standby
    (--standby --replicate-listen, the same lease, sink and checkpoint dir).
    ``ticks[t]`` goes to the process the lease names once its journal holds
    tick t; the leader is SIGKILLed FAILOVER_KILL_DELAY_S after its journal
    holds FAILOVER_KILL_AT;
    after the promotion the feeder re-pushes from the standby's position."""
    from rtap_tpu_torch.resilience.journal import last_journal_tick
    from rtap_tpu_torch.service.sources import send_jsonl

    with open(os.path.join(work, "ids.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    alerts, ck, lease = (os.path.join(work, n) for n in ("alerts.jsonl", "ck", "lease"))
    journals = {"leader": os.path.join(work, "journal-leader"),
                "standby": os.path.join(work, "journal-standby")}
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    repl_port = s.getsockname()[1]
    s.close()
    common = [sys.executable, "-m", "rtap_tpu_torch", "serve", "--streams",
              "@" + os.path.join(work, "ids.txt"), "--device", "cuda",
              "--group-size", str(SERVE_GROUP), "--pipeline-depth", "2", "--cadence", "1",
              "--ticks", str(SERVE_TICKS), "--port", "0", "--alerts", alerts,
              "--checkpoint-dir", ck, "--checkpoint-every", str(FAILOVER_CHECKPOINT_EVERY),
              "--lease-file", lease, "--lease-timeout", str(FAILOVER_LEASE_TIMEOUT),
              "--threshold", "0", "--debounce", str(FAILOVER_DEBOUNCE)]
    extra = {"leader": ["--journal-dir", journals["leader"], "--replicate-to",
                        f"127.0.0.1:{repl_port}", "--latency", "--obs-port", "0"],
             "standby": ["--journal-dir", journals["standby"], "--standby",
                         "--replicate-listen", str(repl_port)]}
    procs, err, ports, obs_ports, promoted_at, following = {}, {}, {}, {}, [], []

    def spawn(role):
        p = spawn_child(common + extra[role], cwd=os.path.dirname(os.path.abspath(__file__)),
                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        children.append(p)
        procs[role], err[role] = p, []

        def read():
            for line in p.stderr:
                err[role].append(line)
                if "listening for JSONL records on" in line:
                    ports[role] = int(line.rsplit(":", 1)[1])
                elif "obs telemetry on http://" in line:
                    obs_ports[role] = int(line.rsplit(":", 1)[1].split("/")[0])
                elif "PROMOTED to leader at tick" in line:
                    promoted_at.append(int(line.split("at tick ")[1].split()[0]))
                elif "standby following on port" in line:
                    following.append(time.perf_counter())
        threading.Thread(target=read, daemon=True).start()
        return p

    def wait(cond, what, timeout=300):
        deadline = DEADLINE.until(timeout)
        while not cond():
            if time.time() > deadline or any(p.poll() not in (None, -signal.SIGKILL)
                                             for p in procs.values()):
                raise AssertionError(f"22(a): {what} (rcs {[p.poll() for p in procs.values()]}):"
                                     + "".join("\n" + r + ": " + "".join(e)[-2000:]
                                               for r, e in err.items()))
            time.sleep(0.002)

    def owner_role():
        try:
            pid = int(json.loads(Path(lease).read_text())["owner"].rsplit(":", 1)[1])
        except (OSError, ValueError, KeyError):
            return None
        return next((r for r, p in procs.items() if p.pid == pid), None)

    t0 = time.perf_counter()
    spawn("leader")
    wait(lambda: os.path.exists(lease), "the leader never took the lease")
    part("leader start to its lease", time.perf_counter() - t0)
    t_sb = time.perf_counter()
    spawn("standby")
    gaps: dict = {}
    stop_watch = threading.Event()
    watcher = _lease_watch(lease, stop_watch, gaps)
    sent, kill, scrape = 0, None, {}

    def scrape_leader():
        scrape.update({route: _get_json(obs_ports["leader"], route)
                       for route in ("/latency", "/snapshot")})
        scrape["gpu_apps"] = _gpu_apps()

    scraper = threading.Thread(target=scrape_leader, daemon=True)
    try:
        t = 0
        wait(lambda: "leader" in ports, "the leader never listened")
        part("leader start to listening", time.perf_counter() - t0)
        t_fed = time.perf_counter()
        while t < len(ticks):
            role = "leader" if kill is None else "standby"
            wait(lambda: role in ports, f"the {role} never listened")
            wait(lambda: last_journal_tick(journals[role]) >= t,
                 f"the {role} never journaled tick {t}")
            if kill is None and t == FAILOVER_KILL_AT - 3:
                # the leader's tick sketch and counters before its death, off
                # this thread: a slow scrape must not hold back the feed
                scraper.start()
            if kill is None and t >= FAILOVER_KILL_AT:
                # seen within a few ms of the leader's journal append of tick t
                t_seen = time.perf_counter()
                # tick t + 1 polls ticks[t], whichever process serves it: sent
                # before the kill, or the leader could poll it empty first
                sent += send_jsonl(("127.0.0.1", ports[role]), ticks[t])
                scraper.join(timeout=DEADLINE.cap(120))
                # kill mid-tick: long after the sender shipped tick t's record,
                # long before tick t + 1's poll, so every tick the leader
                # journaled reaches the standby (which may still be applying)
                time.sleep(max(0.0, FAILOVER_KILL_DELAY_S - (time.perf_counter() - t_seen)))
                journaled = last_journal_tick(journals["leader"]) + 1
                if journaled != t + 1:  # this tick's window was missed: the next
                    if t >= FAILOVER_KILL_AT + 5:
                        raise AssertionError("22(a): the feed never caught the leader "
                                             "between two journal appends")
                    t += 1
                    continue
                procs["leader"].send_signal(signal.SIGKILL)  # no cleanup, no flush
                procs["leader"].wait()
                t_kill = time.perf_counter()
                part("leader ticks until its kill", t_kill - t_fed)
                kill = {"journal_tick": journaled - 1, "journaled_ticks": journaled,
                        "after_append_s": t_kill - t_seen, "rc": procs["leader"].returncode,
                        "standby_mirrored": last_journal_tick(journals["standby"]) + 1}
                wait(lambda: owner_role() == "standby", "the standby never took the lease")
                kill["lease_flip_s"] = time.perf_counter() - t_kill
                wait(lambda: "standby" in ports, "the promoted standby never listened")
                kill["listening_s"] = time.perf_counter() - t_kill
                part("kill to the promoted standby listening", kill["listening_s"])
                # the promoted leader polls tick promoted_at[0] first: the feed
                # resumes there (ticks the dead leader got but never shipped
                # are pushed again)
                t = promoted_at[0] - 1
                continue
            sent += send_jsonl(("127.0.0.1", ports[role]), ticks[t])
            if kill is not None and "first_served_s" not in kill \
                    and last_journal_tick(journals["standby"]) >= promoted_at[0]:
                kill["first_served_s"] = time.perf_counter() - t_kill
            t += 1
        t_last = time.perf_counter()
        part("kill to the last tick fed", t_last - t_kill)
        out, serr = procs["standby"].communicate(timeout=DEADLINE.cap(600))
        part("promoted standby last tick to exit", time.perf_counter() - t_last)
        if procs["standby"].returncode != 0:
            raise AssertionError(f"22(a): the promoted standby exited "
                                 f"{procs['standby'].returncode}:\n{serr[-3000:]}")
    finally:
        stop_watch.set()
        watcher.join(timeout=DEADLINE.cap(5))
    stats = json.loads(out.strip().splitlines()[-1])
    if following:
        part("standby start to following", following[0] - t_sb)
    _child_parts(stats, role="promoted standby")
    for key, secs in stats["standby"]["takeover"].items():
        part(f"takeover {key}", secs)
    pids = {r: p.pid for r, p in procs.items()}
    return dict(stats=stats, kill=kill, scrape=scrape, sent=sent, ck=ck, alerts=alerts,
                lease_gaps={r: gaps.get(f"{os.uname().nodename}:{pid}") for r, pid in pids.items()},
                promoted_at=promoted_at[0], seconds=time.perf_counter() - t0,
                leader_err="".join(err["leader"]), standby_err="".join(err["standby"]))


def _get_json(port: int, route: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=DEADLINE.cap(30)) as r:
        return json.loads(r.read())


def _spliced_alerts(path: str) -> dict:
    """A failover's alert sink read in order: the (group, stream, tick) of
    each alert id, duplicated ids, torn lines, and how many ids precede the
    standby_promoted event (the dead leader's, then the splice's)."""
    pairs, dup, torn, before, promoted, events = {}, [], 0, 0, False, []
    with open(path) as f:
        for line in f:
            if line.startswith('{"event"'):
                ev = json.loads(line)
                events.append(ev)
                promoted = promoted or ev["event"] == "standby_promoted"
                continue
            try:
                aid = json.loads(line)["alert_id"]
            except (ValueError, KeyError):
                torn += 1
                continue
            if aid in pairs:
                dup.append(aid)
            gi, sid, tick = aid.split(":")
            pairs[aid] = (gi, sid, int(tick))
            before += not promoted
    return dict(pairs=pairs, dup=dup, torn=torn, before_promotion=before, events=events,
                bytes=os.path.getsize(path))


def phase_failover_serve(seed: int, card: str, serve_row: dict) -> dict:
    """22(a): phase 6's serve as a leader/standby pair on the card at
    threshold 0 (debounce FAILOVER_DEBOUNCE), the leader SIGKILLed at journal
    tick FAILOVER_KILL_AT; the promoted standby must end on phase 6's final
    state, and the spliced alert stream must hold each alert id once."""
    work = tempfile.mkdtemp(prefix="rtap-failover-")
    children: list = []
    try:
        ids, ticks = serve_row["feed"]  # phase 6's seeded ticks
        r = _failover_pair(ids, ticks, work, children)
        with timed_part("final checkpoint digest"):
            digest = _ck_digest(r["ck"])
        with timed_part("spliced alert stream read"):
            alerts = _spliced_alerts(r["alerts"])
        events = alerts["events"]
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    stats, kill, groups = r["stats"], r["kill"], SERVE_STREAMS // SERVE_GROUP
    standby = stats["standby"]
    base = r["promoted_at"]
    cut = next(i for i, e in enumerate(events) if e["event"] == "standby_promoted")
    promo = events[cut]
    leader_missed = [(e["tick"], e["elapsed_s"]) for e in events[:cut] if e["event"] == "missed_tick"]
    served_missed = [(base + e["tick"], e["elapsed_s"]) for e in events[cut:]
                     if e["event"] == "missed_tick"]
    save_ticks = {k for k in range(SERVE_TICKS) if (k + 1) % FAILOVER_CHECKPOINT_EVERY == 0}
    # phase 6's per-leaf digest, but each group's debounce counter, which the
    # threshold defines: at threshold 0 every tick hits, so it ends at
    # SERVE_TICKS for every stream
    want = dict(serve_row["state_digest"])
    dtype, shape = serve_row["alert_run_like"]
    for gi in range(groups):
        key = f"group{gi:04d}/state/alert_run.npy"
        assert key in want, key
        want[key] = _leaf_digest(np.full(shape, SERVE_TICKS, dtype))
    diff = sorted(k for k in want.keys() | digest.keys() if want.get(k) != digest.get(k))
    # every stream alerts on each tick from FAILOVER_DEBOUNCE - 1 on
    expect = {(str(i // SERVE_GROUP), sid, t) for i, sid in enumerate(ids)
              for t in range(FAILOVER_DEBOUNCE - 1, SERVE_TICKS)}
    got = set(alerts["pairs"].values())
    by_dead_leader = alerts["before_promotion"] - promo["re_emitted"]
    after_promotion = sum(t >= base for _g, _s, t in alerts["pairs"].values())
    lat = r["scrape"].get("/latency", {}).get("stages", {}).get("tick", {}).get("total", {})
    repl = {m["name"]: m["value"] for m in r["scrape"].get("/snapshot", {}).get("metrics", [])
            if m["name"].startswith("rtap_obs_repl_") and "labels" not in m}
    checks = {
        "leader_killed": kill["rc"] == -signal.SIGKILL,
        "promoted_rc0_ticks": stats["ticks"] == SERVE_TICKS - base and base == kill["journaled_ticks"],
        # the standby applied every tick the leader journaled before it died
        "applied_ticks": standby["applied_ticks"] == kill["journaled_ticks"],
        "standby_launches": standby["kernel_launches"] == standby["learned_group_ticks"]
                            == groups * standby["applied_ticks"],
        "served_launches": stats["kernel_launches"]["tm_learn"] == stats["learned_group_ticks"]
                           == groups * stats["ticks"],
        # every tick the promoted leader served polled a whole fed tick
        "missing_values": stats["missing_values"] == 0,
        "state_digest": not diff and len(digest) == len(serve_row["state_digest"]) > groups,
        # each alert id exactly once, spanning the kill: some delivered by
        # the leader before it died, some served after the promotion
        "alert_ids": got == expect and len(alerts["pairs"]) == len(expect)
                     and not alerts["dup"] and not alerts["torn"],
        "alerts_span_kill": by_dead_leader > 0 and after_promotion > 0,
        # the standby's would-be lines stayed within its buffer
        "standby_buffer": standby["buffered_dropped"] == 0,
        "detect_ticks": promo["detect_ticks"] is not None
                        and promo["detect_ticks"] <= FAILOVER_TAKEOVER_BUDGET,
        "epoch": promo["epoch"] == 2,
        "missed_ticks": all(t == 0 or t in save_ticks for t, _ in leader_missed)
                        and all(t == base for t, _ in served_missed),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"22(a) failover serve failed {bad}: kill {kill}, promoted at {base}, "
                             f"digest diff {diff[:8]}, alerts {len(got)} of {len(expect)} "
                             f"(missing {sorted(expect - got)[:4]}, extra {sorted(got - expect)[:4]}, "
                             f"dup {alerts['dup'][:4]}, torn {alerts['torn']}), "
                             f"leader missed {leader_missed}, served "
                             f"missed {served_missed}, event {promo}: "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }\n"
                             f"standby stderr: {r['standby_err'][-2000:]}")
    row = dict(streams=SERVE_STREAMS, groups=groups, ticks=SERVE_TICKS, kill_at=FAILOVER_KILL_AT,
               lease_timeout_s=FAILOVER_LEASE_TIMEOUT, kill=kill, promoted_at_tick=base,
               standby_promoted=promo, takeover=standby["takeover"],
               standby_apply_ms_per_tick=standby["apply_ms_per_tick"],
               standby_applied_ticks=standby["applied_ticks"],
               standby_kernel_launches=standby["kernel_launches"],
               served_ticks=stats["ticks"], served_kernel_launches=stats["kernel_launches"]["tm_learn"],
               # the leader's tick sketch (with the standby on the same card:
               # an upper bound for a standby on another host), at its death
               leader_tick_p50_s=lat.get("p50"), leader_tick_p99_s=lat.get("p99"),
               leader_tick_count=lat.get("count"),
               phase6_latency_p50_ms=serve_row["latency_p50_ms"],
               phase6_latency_p99_ms=serve_row["latency_p99_ms"],
               leader_repl=repl, leader_repl_bytes_per_tick=repl.get(
                   "rtap_obs_repl_shipped_bytes_total", 0) / max(1, kill["journaled_ticks"]),
               leader_missed_ticks=leader_missed, served_missed_ticks=served_missed,
               served_latency_p50_ms=stats["latency_p50_ms"],
               served_latency_p99_ms=stats["latency_p99_ms"],
               served_phase_ms_per_tick=stats["phase_ms_per_tick"],
               max_heartbeat_gap_s=r["lease_gaps"],
               resumed_from=stats.get("resumed_from"),
               leaves_compared=len(digest), threshold=0.0, debounce=FAILOVER_DEBOUNCE,
               alert_ids=len(alerts["pairs"]), alert_sink_bytes=alerts["bytes"],
               alert_ids_by_dead_leader=by_dead_leader,
               alert_ids_spliced=promo["re_emitted"], alert_ids_suppressed=promo["suppressed"],
               alert_ids_from_promoted_tick=after_promotion,
               standby_buffered_dropped=standby["buffered_dropped"],
               hbm_peak_bytes_in_use_promoted=stats["hbm_peak_bytes_in_use"],
               gpu_apps_at_kill=r["scrape"]["gpu_apps"],
               records_sent=r["sent"], seconds=r["seconds"], card=card)
    emit("failover_serve", **row)
    return row


def phase_failover_soak(card: str, work: str) -> dict:
    """22(b): ``python -m rtap_tpu_torch.failover_soak --fleet`` on the card
    at the drill's shape: a leader kill and the SIGSTOP fence round under
    an aggregator in the soak's process; its own verdict must be verified."""
    c = FAILOVER_SOAK
    out = os.path.join(work, "failover.json")
    t_soak = time.perf_counter()
    p = run_child([sys.executable, "-m", "rtap_tpu_torch.failover_soak", "--device", "cuda",
                   "--seed", str(c["seed"]), "--kills", str(c["kills"]),
                   "--streams", str(c["streams"]), "--group-size", str(c["group_size"]),
                   "--ticks", str(c["ticks"]), "--cadence", str(c["cadence"]),
                   "--checkpoint-every", str(c["checkpoint_every"]), "--fleet",
                   "--workdir", os.path.join(work, "failover"), "--out", out], timeout=900)
    part("failover_soak child", time.perf_counter() - t_soak)
    if p.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"22(b) failover soak exited {p.returncode}:\n{p.stderr[-3000:]}")
    rep = json.load(open(out))
    lines = [json.loads(ln) for ln in open(os.path.join(work, "failover", "ha", "stats.jsonl"))]
    ref = [json.loads(ln) for ln in open(os.path.join(work, "failover", "ref", "stats.jsonl"))]
    groups = c["streams"] // c["group_size"]
    fo = rep["fleetobs"]
    checks = {
        "verified": rep["verified"] is True and not rep["failures"],
        "kills": len(rep["kills"]) == c["kills"] and rep["fence_round"]["rc"] == 7,
        "exactly_once": rep["duplicated"] == rep["lost"] == rep["extra"] == 0
                        and rep["alert_ids"] == c["streams"] * c["ticks"],
        "leaves": rep["state_leaves_compared"] > 0,
        "detect": all(q["detect_ticks"] <= rep["takeover_budget_ticks"] for q in rep["promotions"]),
        "fleet": all(s["ok"] for s in fo["sequence"]) and fo["final_tick"] == c["ticks"] - 1
                 and bool(fo["slo"]["slos"]),
        "zombie": all(s["fenced_line_drops"] >= 1 for s in rep["fenced_exits"]),
        # every life launched one kernel per group per applied or served tick
        "launches": all(s["kernel_launches"] == s["learned_group_ticks"] for s in lines + ref)
                    and ref[0]["kernel_launches"] == groups * c["ticks"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"22(b) failover soak failed {bad}: {rep['failures']} {lines}")
    row = dict(**c, promotions=rep["promotions"], kills_at=rep["kills"],
               fence_round=rep["fence_round"], alert_ids=rep["alert_ids"],
               state_leaves_compared=rep["state_leaves_compared"],
               unscheduled_fences=rep["unscheduled_fences"], lease_timeout_s=rep["lease_timeout_s"],
               fleet_sequence=fo["sequence"], fleet_slo=fo["slo"]["slos"],
               lives=[{k: s.get(k) for k in ("name", "base", "ran", "fenced", "promoted",
                                             "kernel_launches", "learned_group_ticks")}
                     for s in lines],
               reference_kernel_launches=ref[0]["kernel_launches"], wall_s=rep["wall_s"],
               card=card)
    emit("failover_soak", **row)
    return row


def phase_replication_chaos(card: str, work: str) -> dict:
    """22(c): ``python -m rtap_tpu_torch.chaos_soak --replication`` (its
    main, in this process) on the card: all three wire fault kinds hit the
    live replication socket, the standby applies every tick and ends
    bit-equal to the leader."""
    import rtap_tpu_torch.ops.tm_learn as tm_learn
    from rtap_tpu_torch.chaos_soak import main as chaos_main

    c = REPL_CHAOS
    out = os.path.join(work, "replication.json")
    launches0 = tm_learn.launches
    t_soak = time.perf_counter()
    rc = chaos_main(["--replication", "--device", "cuda", "--seed", str(c["seed"]),
                     "--streams", str(c["streams"]), "--group-size", str(c["group_size"]),
                     "--ticks", str(c["ticks"]), "--cadence", str(c["cadence"]),
                     "--rate", str(c["rate"]), "--checkpoint-every", str(c["checkpoint_every"]),
                     "--workdir", os.path.join(work, "replication"), "--out", out])
    part("chaos_soak --replication", time.perf_counter() - t_soak)
    launches = tm_learn.launches - launches0
    rep = json.load(open(out))
    groups = c["streams"] // c["group_size"]
    checks = {
        "verified": rc == 0 and rep["verified"] is True,
        "kinds": {e["kind"] for e in rep["faults_injected"]}
                 == {"conn_drop", "stall_socket", "corrupt_bytes"},
        "applied": rep["standby"]["applied_ticks"] == c["ticks"],
        "leaves": rep["state_leaves_compared"] > 0,
        # leader and standby share this process: one launch per group per
        # tick on each side
        "launches": launches == rep["leader_learned_group_ticks"]
                    + rep["standby"]["learned_group_ticks"] == 2 * groups * c["ticks"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"22(c) replication chaos failed {bad}: {rep}")
    row = dict(**c, schedule_digest=rep["schedule_digest"], faults_injected=rep["faults_injected"],
               standby=rep["standby"], sender=rep["sender"],
               state_leaves_compared=rep["state_leaves_compared"], kernel_launches=launches,
               card=card)
    emit("replication_chaos", **row)
    return row


def phase_replication(seed: int, card: str, serve_row: dict) -> dict:
    """Phase 22: (a)-(c), each with its own seconds."""
    parts, seconds = {}, {}
    work = tempfile.mkdtemp(prefix="rtap-repl-")
    try:
        for key, fn in (("a", lambda: phase_failover_serve(seed, card, serve_row)),
                        ("b", lambda: phase_failover_soak(card, work)),
                        ("c", lambda: phase_replication_chaos(card, work))):
            t0 = time.perf_counter()
            parts[key] = fn()
            seconds[key] = round(time.perf_counter() - t0, 3)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("replication", seconds=seconds, card=card)
    return parts


class _Child:
    """One ``python -m rtap_tpu_torch serve`` child of phase 23, its stderr
    read on a thread: the JSONL listener's port, the control plane's
    address, the promotion tick, each line's arrival time."""

    def __init__(self, name: str, argv: list[str], children: list):
        self.name = name
        self.t0, self.t_ready = time.perf_counter(), None
        self.proc = spawn_child([sys.executable, "-m", "rtap_tpu_torch", "serve", *argv],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        children.append(self.proc)
        self.err: list[str] = []
        self.port = self.control_port = self.promoted_at = None
        self.recovered = None
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stderr:
            self.err.append(line)
            if "listening for JSONL records on" in line:
                self.port = int(line.rsplit(":", 1)[1])
                self.t_ready = self.t_ready or time.perf_counter()
            elif "standby following on port" in line:
                self.t_ready = time.perf_counter()
            elif "serve: control plane on" in line:
                self.t_ready = self.t_ready or time.perf_counter()
                self.control_port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
                self.recovered = int(line.split(", ")[1].split()[0])
            elif "PROMOTED to leader at tick" in line:
                self.promoted_at = int(line.split("at tick ")[1].split()[0])

    def stats(self, timeout: float = 300) -> dict:
        # stdout only: the reader thread owns stderr (communicate would race it)
        out = self.proc.stdout.read()
        self.proc.wait(timeout=DEADLINE.cap(timeout))
        if self.t_ready is not None:
            part(f"{self.name} start to listening", self.t_ready - self.t0)
        if self.proc.returncode != 0:
            raise AssertionError(f"23: {self.name} exited {self.proc.returncode}:\n"
                                 + "".join(self.err)[-3000:])
        return json.loads(out.strip().splitlines()[-1])


def _holds_the_card(pid: int) -> bool:
    """Whether a process has the card's device files open (a CUDA context
    opens /dev/nvidiactl and /dev/nvidia<N>)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def _first_event_s(paths: dict, offsets: dict, kind: str, after: float,
                   timeout: float = 60) -> dict:
    """Poll alert sinks, each from its byte offset on, until an event line of
    `kind` appears in it -> per sink, the wall seconds from `after` to the
    poll that saw it (None if it never did)."""
    seen: dict = {k: None for k in paths}
    while any(v is None for v in seen.values()) and time.time() < min(after + timeout, DEADLINE.until(timeout)):
        for k, path in paths.items():
            if seen[k] is not None:
                continue
            with open(path) as f:
                f.seek(offsets[k])
                if any(ln.startswith('{"event"') and f'"event": "{kind}"' in ln for ln in f):
                    seen[k] = time.time() - after
        time.sleep(0.01)
    return seen


def _quantiles_us(xs: list[float]) -> dict:
    a = np.asarray(xs) * 1e6
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
            "max": float(a.max()), "n": len(xs)}


def phase_control_plane(seed: int, card: str) -> dict:
    """23: a --control-only plane, shard 0's leader and standby and shard 1's
    leader (each ``--control-join``, one group of CONTROL_STREAMS on the
    card); (a) the grants, the roster and a plane that holds no CUDA context;
    (b) the plane SIGKILLed and restarted on its journal and port while the
    leaders tick on their cached grants; (c) shard 0 drained and handed to its
    standby. Fed per shard in step with the serving process's journal."""
    from rtap_tpu_torch.fleet.control import (ControlPlane, control_drain, control_read,
                                              read_control_journal)
    from rtap_tpu_torch.obs.metrics import TelemetryRegistry
    from rtap_tpu_torch.resilience.journal import last_journal_tick
    from rtap_tpu_torch.service.sources import send_jsonl

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="rtap-control-")
    children: list = []
    host = os.uname().nodename
    # each shard's streams and seeded ticks (shard 1's ids renamed apart)
    feeds = {}
    for shard in (0, 1):
        ids, ticks, _ = _serve_feed(seed + shard, n_streams=CONTROL_STREAMS, n_ticks=CONTROL_TICKS)
        if shard:
            ids = [f"s1.{sid}" for sid in ids]
            ticks = [[{**r, "id": f"s1.{r['id']}"} for r in recs] for recs in ticks]
        with open(os.path.join(work, f"ids{shard}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        feeds[shard] = (ids, ticks)
    cj = os.path.join(work, "control")
    # serve scopes a shard's paths (service/shardpath.py): shard 1's journal
    # dir "journal" lands at "journal.shard001", its sink at "alerts.jsonl.shard001"
    jdir = {"leader0": os.path.join(work, "journal-leader"),
            "standby0": os.path.join(work, "journal-standby"),
            "leader1": os.path.join(work, "journal.shard001")}
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    repl_port = s.getsockname()[1]
    s.close()
    plane_argv = lambda port: ["--control-listen", str(port), "--control-journal", cj,  # noqa: E731
                               "--control-only"]

    def data_argv(shard, extra):
        return ["--streams", "@" + os.path.join(work, f"ids{shard}.txt"), "--device", "cuda",
                "--group-size", str(CONTROL_STREAMS), "--pipeline-depth", "2",
                "--cadence", str(CONTROL_CADENCE), "--ticks", str(CONTROL_TICKS), "--port", "0",
                "--threshold", "0", "--debounce", "1", "--shard", str(shard),
                "--alerts", os.path.join(work, "alerts.jsonl"),
                "--checkpoint-dir", os.path.join(work, "ck"),
                "--control-join", f"127.0.0.1:{cport}",
                "--lease-timeout", str(CONTROL_LEASE_TIMEOUT), *extra]

    def wait(cond, what, timeout=300):
        deadline = DEADLINE.until(timeout)
        while not cond():
            dead = [(c.name, c.proc.poll()) for c in kids.values()
                    if c.proc.poll() not in (None, 0, -signal.SIGKILL)]
            if time.time() > deadline or dead:
                raise AssertionError(f"23: {what} (dead {dead}):" + "".join(
                    f"\n{c.name}: " + "".join(c.err)[-1500:] for c in kids.values()))
            time.sleep(0.005)

    kids: dict = {}
    sinks = {0: os.path.join(work, "alerts.jsonl"), 1: os.path.join(work, "alerts.jsonl.shard001")}
    fed = {0: 0, 1: 0}
    feed_errors: list = []
    stop_feed = threading.Event()
    first_served = {}

    def feeder(shard):
        """ticks[t] goes to the shard's serving process once its journal
        holds tick t; after a drain, from the promoted tick on to the
        standby (it re-polls from there)."""
        ids, ticks = feeds[shard]
        role = f"leader{shard}"
        t = 0
        try:
            while t < len(ticks) and not stop_feed.is_set():
                kid = kids[role]
                if role == "leader0" and kid.proc.poll() is not None:
                    # drained: the standby promotes and re-polls its promoted tick
                    role = "standby0"
                    wait(lambda: kids[role].promoted_at is not None and kids[role].port,
                         "the promoted standby never listened")
                    t = kids[role].promoted_at - 1
                    continue
                if last_journal_tick(jdir[role]) < t or kid.port is None:
                    time.sleep(0.002)
                    continue
                fed[shard] += send_jsonl(("127.0.0.1", kid.port), ticks[t])
                if role == "standby0" and "t" not in first_served \
                        and last_journal_tick(jdir[role]) >= kids[role].promoted_at:
                    first_served["t"] = time.time()
                t += 1
        except Exception as e:  # noqa: BLE001 — surfaced by the phase
            feed_errors.append(f"shard {shard}: {type(e).__name__}: {e}")

    try:
        # (a) the plane first (it must bind before anyone joins), then the
        # leaders, then the standby once its leader holds epoch 1
        kids["plane"] = _Child("plane", plane_argv(0), children)
        wait(lambda: kids["plane"].control_port, "the control plane never listened")
        cport = kids["plane"].control_port
        addr = ("127.0.0.1", cport)
        kids["leader0"] = _Child("leader0", data_argv(0, [
            "--journal-dir", jdir["leader0"], "--replicate-to", f"127.0.0.1:{repl_port}"]),
            children)
        kids["leader1"] = _Child("leader1", data_argv(1, [
            "--journal-dir", os.path.join(work, "journal")]), children)

        def cur(shard):
            return (control_read(addr, shard) or {}).get("cur") or {}

        wait(lambda: cur(0).get("owner"), "shard 0's leader never took its lease")
        kids["standby0"] = _Child("standby0", data_argv(0, [
            "--journal-dir", jdir["standby0"], "--standby", "--replicate-listen",
            str(repl_port)]), children)
        feeders = [threading.Thread(target=feeder, args=(sh,), daemon=True) for sh in (0, 1)]
        for th in feeders:
            th.start()
        wait(lambda: cur(1).get("owner") and kids["leader0"].port and kids["leader1"].port
             and last_journal_tick(jdir["standby0"]) >= 2, "the fleet never came up")
        roster = control_read(addr, -1)
        grants = {sh: cur(sh) for sh in (0, 1)}
        rtt = []
        for _ in range(CONTROL_RPCS):
            t0 = time.perf_counter()
            assert control_read(addr, 0) is not None
            rtt.append(time.perf_counter() - t0)
        smi_pids = run_child(["nvidia-smi", "--query-compute-apps=pid",
                              "--format=csv,noheader"], timeout=60).stdout.split()
        card_held = {n: _holds_the_card(k.proc.pid) for n, k in kids.items()}
        # (b) the plane dies (SIGKILL: no flush, no release) mid-run
        at_kill = {n: last_journal_tick(jdir[n]) for n in ("leader0", "leader1")}
        kids["plane"].proc.send_signal(signal.SIGKILL)
        kids["plane"].proc.wait()
        t_kill = time.time()
        time.sleep(CONTROL_DOWN_S)
        down_ticks = {n: last_journal_tick(jdir[n]) - at_kill[n] for n in at_kill}
        promoted_while_down = kids["standby0"].promoted_at is not None
        offsets = {sh: os.path.getsize(sinks[sh]) for sh in sinks}
        t_restart = time.time()
        kids["plane2"] = _Child("plane2", plane_argv(cport), children)
        wait(lambda: kids["plane2"].control_port, "the restarted plane never listened")
        restart_s = time.time() - t_restart
        regained_s = _first_event_s(sinks, offsets, "control_plane_regained", t_restart)
        outage_ticks = {n: last_journal_tick(jdir[n]) - at_kill[n] for n in at_kill}
        # (c) drain shard 0 a few ticks after both leaders regained the plane
        at = last_journal_tick(jdir["leader0"])
        wait(lambda: last_journal_tick(jdir["leader0"]) >= at + CONTROL_DRAIN_AFTER,
             "shard 0's leader stopped ticking after the restart")
        t_drain = time.time()
        drain_reply = control_drain(addr, 0)
        leader0 = kids["leader0"].stats()
        t_leader_exit = time.time()
        wait(lambda: kids["standby0"].promoted_at is not None and last_journal_tick(
            jdir["standby0"]) >= kids["standby0"].promoted_at + CONTROL_SERVED,
             "the promoted standby never served")
        for name in ("standby0", "leader1"):
            kids[name].proc.send_signal(signal.SIGTERM)
        promoted = kids["standby0"].stats()
        leader1 = kids["leader1"].stats()
        stop_feed.set()
        for th in feeders:
            th.join(timeout=DEADLINE.cap(30))
        kids["plane2"].proc.send_signal(signal.SIGTERM)
        plane_final = kids["plane2"].stats(timeout=60)
        journal = read_control_journal(cj)
        # the plane's grant path, timed in this process on the same disk:
        # one journal record appended, flushed and fsynced before a reply
        fs_plane = ControlPlane(os.path.join(work, "fsync"), registry=TelemetryRegistry())
        fsync_s = []
        for i in range(50):
            t0 = time.perf_counter()
            fs_plane._journal("grant", 0, epoch=i + 1, owner="probe", timeout_s=2.0)
            fsync_s.append(time.perf_counter() - t0)
        fs_plane.close()
        alerts = {sh: _drill_records(sinks[sh]) for sh in (0, 1)}
        events = {sh: [json.loads(ln) for ln in open(sinks[sh]) if ln.startswith('{"event"')]
                  for sh in (0, 1)}
    finally:
        stop_feed.set()
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    # the control journal: grants per shard in order, the drain, the release
    grants_by_shard = {sh: [(r["epoch"], r["ts"]) for r in journal
                            if r["kind"] == "grant" and r["shard"] == sh] for sh in (0, 1)}
    release = next(r for r in journal if r["kind"] == "release" and r["shard"] == 0)
    regrant = next(ts for ep, ts in grants_by_shard[0] if ep == 2)
    ctl_kinds = {sh: [e["event"] for e in events[sh] if e["event"].startswith("control_")]
                 for sh in (0, 1)}
    promo = next(e for e in events[0] if e["event"] == "standby_promoted")
    sb = promoted["standby"]
    served = {0: leader0["ticks"] + promoted["ticks"], 1: leader1["ticks"]}
    expect = {sh: {f"0:{sid}:{t}" for sid in feeds[sh][0] for t in range(served[sh])}
              for sh in (0, 1)}
    leader0_owner = f"{host}:{kids['leader0'].proc.pid}"
    checks = {
        # (a)
        "epoch1_each_shard": grants[0].get("epoch") == grants[1].get("epoch") == 1
                             and grants[0].get("owner") == leader0_owner
                             and grants[1].get("owner") == f"{host}:{kids['leader1'].proc.pid}",
        "roster": roster is not None and set(roster["shards"]) == {"0", "1"}
                  and len(roster["members"]) == 3,
        "plane_off_the_card": str(kids["plane"].proc.pid) not in smi_pids
                              and not card_held["plane"] and card_held["leader0"],
        # (b)
        "leaders_ticked_through": all(n >= int(CONTROL_DOWN_S / CONTROL_CADENCE) - 2
                                      for n in down_ticks.values()),
        "degraded_ticks": leader0.get("control_degraded_ticks", 0) > 0
                          and leader1.get("control_degraded_ticks", 0) > 0,
        "lost_then_regained": all(k[:2] == ["control_plane_lost", "control_plane_regained"]
                                  for k in ctl_kinds.values()),
        "no_promotion_while_down": not promoted_while_down and regrant > t_drain,
        "recovered_shards": kids["plane2"].recovered == 2
                            and plane_final["control"]["recovered_shards"] == 2
                            and plane_final["stopped"] is True,
        # every grant strictly above every earlier one of its shard
        "epochs_monotonic": [e for e, _ in grants_by_shard[0]] == [1, 2]
                            and [e for e, _ in grants_by_shard[1]] == [1],
        # (c)
        "drained": drain_reply is not None and drain_reply["draining"] is True
                   and leader0.get("drained") is True and release["owner"] == leader0_owner,
        "promoted_in_one_timeout": promo["epoch"] == 2 and promoted.get("promoted_from_standby")
                                   and regrant - release["ts"] < CONTROL_LEASE_TIMEOUT,
        "exactly_once": all(set(alerts[sh][0]) == expect[sh] and not alerts[sh][1]
                            and not alerts[sh][2] for sh in (0, 1)),
        # shard 1 served on through the drain, unfenced
        "shard1_served": leader1["ticks"] > leader0["ticks"] and not leader1.get("fenced"),
        "shard0_ticks": promoted["ticks"] >= CONTROL_SERVED
                        and sb["applied_ticks"] == leader0["ticks"],
        # every tick polled a whole fed tick but tick 0 (polled before the
        # first push) and the promoted standby's first (it may poll before
        # the re-push lands)
        "fed": not feed_errors and all(fed[sh] >= (served[sh] - 1) * CONTROL_STREAMS
                                       for sh in (0, 1))
               and leader0["missing_values"] == leader1["missing_values"] == CONTROL_STREAMS
               and promoted["missing_values"] <= CONTROL_STREAMS,
        # one tm_learn launch per group per learned tick, in every data plane
        "launches": all(st["kernel_launches"]["tm_learn"] == st["learned_group_ticks"]
                        == st["ticks"] for st in (leader0, promoted, leader1))
                    and sb["kernel_launches"] == sb["learned_group_ticks"] == sb["applied_ticks"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(
            f"23 control plane failed {bad}: grants {grants}, roster {roster}, smi {smi_pids}, "
            f"card {card_held}, down ticks {down_ticks}, kinds {ctl_kinds}, journal {journal}, "
            f"feed {feed_errors}, leader0 { {k: v for k, v in leader0.items() if k != 'telemetry'} }, "
            f"promoted { {k: v for k, v in promoted.items() if k != 'telemetry'} }")
    launches = {"shard0_leader": leader0["kernel_launches"]["tm_learn"],
                "shard0_standby_applied": sb["kernel_launches"],
                "shard0_promoted": promoted["kernel_launches"]["tm_learn"],
                "shard1_leader": leader1["kernel_launches"]["tm_learn"]}
    row = dict(streams_per_shard=CONTROL_STREAMS, groups_per_process=1, cadence_s=CONTROL_CADENCE,
               ticks_served=served, lease_timeout_s=CONTROL_LEASE_TIMEOUT,
               control_rpc_us=_quantiles_us(rtt),
               grant_fsync_ms={k: v / 1e3 for k, v in _quantiles_us(fsync_s).items() if k != "n"},
               plane_down_s=t_restart - t_kill, ticks_while_down=down_ticks,
               ticks_through_outage=outage_ticks,
               degraded_ticks={"shard0": leader0["control_degraded_ticks"],
                               "shard1": leader1["control_degraded_ticks"]},
               plane_restart_to_listening_s=restart_s, restart_to_regained_s=regained_s,
               drain_to_leader_exit_s=t_leader_exit - t_drain,
               release_to_grant_s=regrant - release["ts"],
               release_to_first_served_tick_s=first_served.get("t", float("nan")) - release["ts"],
               promoted_at_tick=promo["tick"], drained_at_tick=leader0["ticks"],
               standby_detect_s=promo["detect_s"], takeover=sb["takeover"],
               standby_apply_ms_per_tick=sb["apply_ms_per_tick"],
               alert_ids={sh: len(alerts[sh][0]) for sh in (0, 1)},
               latency_p50_ms={"shard0_leader": leader0["latency_p50_ms"],
                               "shard0_promoted": promoted["latency_p50_ms"],
                               "shard1_leader": leader1["latency_p50_ms"]},
               control_lease=leader0["control_lease"], records_sent=fed,
               grants={str(sh): [e for e, _ in g] for sh, g in grants_by_shard.items()},
               nvidia_smi_pids=smi_pids, holds_the_card=card_held, kernel_launches=launches,
               seconds=time.perf_counter() - t_phase, card=card)
    emit("control_plane", **row)
    return row


def _continue_import(path: str, exp, sparsify: bool | None = None) -> tuple:
    """Import a JAX checkpoint on the card and continue it over `exp`'s
    values: raw and log-likelihood must equal `exp`'s bit for bit, with one
    kernel launch per tick and no TM overflow -> (group, row)."""
    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.service.checkpoint import load_group

    kw = {} if sparsify is None else {"sparsify": sparsify}
    t0 = time.perf_counter()
    grp = load_group(path, device="cuda", **kw)
    load_s = time.perf_counter() - t0
    vals, ts = exp["vals"], exp["ts"]
    tl.reset_launches()
    t0 = time.perf_counter()
    bad = []
    for j in range(exp["raw"].shape[0]):
        r = grp.tick(vals[j], int(ts[j]))
        if not (np.array_equal(r.raw, exp["raw"][j])
                and np.array_equal(r.log_likelihood, exp["log_likelihood"][j])):
            bad.append(j)
    torch.cuda.synchronize()
    launches = tl.launches
    overflow = int(grp.state["tm_overflow"].sum())
    ticks = exp["raw"].shape[0]
    if bad or launches != ticks or overflow:
        raise AssertionError(f"24: {path} (sparsify {sparsify}) continued with raw/loglik "
                             f"unequal at ticks {bad[:8]}, {launches} launches for {ticks} "
                             f"ticks, tm_overflow {overflow}")
    st = grp.import_stats
    return grp, dict(checkpoint=os.path.relpath(path), sparsify=sparsify,
                     streams=grp.G, resumed_at_tick=int(exp["warm_ticks"]), ticks=ticks,
                     sparse_pool=grp.cfg.sp.sparse_pool, pool_members=grp.cfg.sp_members,
                     raw_equal=True, loglik_equal=True, kernel_launches=launches,
                     tm_overflow=overflow, load_s=load_s, continue_s=time.perf_counter() - t0,
                     import_split_s={k: st[k] for k in ("ocdbt_s", "zarr_s", "zstd_s",
                                                        "device_s")},
                     bytes_on_disk=st["bytes_on_disk"], zstd_bytes_in=st["zstd_bytes_in"],
                     zstd_bytes_out=st["zstd_bytes_out"], zstd_mb_per_s=st["zstd_mb_per_s"])


def _imported_kernel_row(label: str, grp, exp, card: str) -> dict:
    """Kernel vs plain on the next learning pass of an imported group's
    state (the values of its last recorded tick once more)."""
    from rtap_tpu_torch.ops.step import next_learn_pass

    values = torch.from_numpy(np.asarray(exp["vals"][-1], np.float32).reshape(grp.G, -1)).cuda()
    ts = torch.full((grp.G,), int(exp["ts"][-1]) + 1, dtype=torch.int32, device="cuda")
    row = compare_pass(label, next_learn_pass(grp.cfg, grp.state, values, ts))
    row.update(card=card)
    emit("kernel_vs_plain", **row)
    return row


def phase_imports(card: str) -> dict:
    """24: the JAX package's orbax checkpoints imported on the card. (a) the
    committed dense migration fixture, with and without ``sparsify``; (b)
    the full-width fixture (64 streams of cluster_preset); (c) ``python -m
    rtap_tpu_torch serve`` resuming a copy of (b)'s fixture as its
    --checkpoint-dir group 0, fed (b)'s values; its exit checkpoint must
    equal (b)'s group leaf for leaf."""
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.models.state import state_nbytes, state_to_numpy

    here = os.path.dirname(os.path.abspath(__file__))
    mig = np.load(os.path.join(here, MIGRATION_FIXTURE, "expected.npz"))
    warm = int(mig["warm_ticks"])
    mig_exp = {"vals": mig["vals"][warm:], "raw": mig["raw"],
               "log_likelihood": mig["log_likelihood"], "warm_ticks": warm,
               "ts": 1_700_000_000 + warm + np.arange(mig["raw"].shape[0])}
    full = dict(np.load(os.path.join(here, IMPORT_FIXTURE, "expected.npz")))
    out: dict = {"seconds": {}, "kernel_rows": [], "launches": {}}
    t0 = time.perf_counter()
    # (a) the migration fixture, migrated to the sparse layout and as stored
    for sparsify in (True, False):
        tag = "sparse" if sparsify else "dense"
        grp, row = _continue_import(os.path.join(here, MIGRATION_FIXTURE, "dense_ckpt"),
                                    mig_exp, sparsify)
        emit("import", part="a", card=card, **row)
        out["launches"][f"import_migration_{tag}"] = row["kernel_launches"]
        out["kernel_rows"].append(_imported_kernel_row(f"migration_fixture_{tag}", grp,
                                                       mig_exp, card))
        del grp
    out["seconds"]["a"] = time.perf_counter() - t0
    # (b) the full-width fixture in this process
    t0 = time.perf_counter()
    ck_src = os.path.join(here, IMPORT_FIXTURE, "group0000")
    grp, row = _continue_import(ck_src, full)
    per_stream = state_nbytes(cluster_preset())["total"]
    rate = row["zstd_bytes_out"] / row["import_split_s"]["zstd_s"]
    load_rate = grp.G * per_stream / row["load_s"]
    row.update(state_bytes_per_stream=per_stream,
               extrapolated_4096_stream_group={
                   "state_bytes": 4096 * per_stream,
                   "zstd_s_at_this_rate": 4096 * per_stream / rate,
                   "load_s_at_this_rate": 4096 * per_stream / load_rate,
                   "note": "extrapolated from this 64-stream import's rates, not measured"})
    emit("import", part="b", card=card, **row)
    out["launches"]["import_full_width"] = row["kernel_launches"]
    out["kernel_rows"].append(_imported_kernel_row("full_width_fixture", grp, full, card))
    want = {**{f"model/{k}": v for k, v in state_to_numpy(grp.state).items()},
            **{f"likelihood/{k}": np.asarray(v) for k, v in grp.likelihood.state_dict().items()},
            "alert_run": np.asarray(grp._alert_run)}
    ids = list(grp.stream_ids)
    del grp
    torch.cuda.empty_cache()
    out["seconds"]["b"] = time.perf_counter() - t0
    # (c) the real entry point resumes a copy of the fixture
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="rtap-import-")
    try:
        ck = os.path.join(work, "ck")
        shutil.copytree(ck_src, os.path.join(ck, "group0000"))
        n = full["raw"].shape[0]
        warm = int(full["warm_ticks"])
        recs = [[{"id": sid, "value": float(full["vals"][j, i]), "ts": int(full["ts"][j])}
                 for i, sid in enumerate(ids)] for j in range(n)]
        # tick `warm` polls recs[0] (sent before its poll), tick warm + j
        # polls recs[j], sent once the child journals tick warm + j - 1
        ticks = [None] * warm + recs[1:]
        stats, sent, _ = _serve_child(
            ids, ticks, work, ["--checkpoint-dir", ck], group=len(ids), n_ticks=warm + n,
            cadence=IMPORT_SERVE_CADENCE, start=warm, presend=recs[0])
        ticks_saved, tree = _drill_checkpoints(ck)["group0000"]
        got = dict(_flat(tree))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    unequal = sorted(k for k in want if k not in got or got[k].dtype != want[k].dtype
                     or not np.array_equal(got[k], want[k], equal_nan=True))
    checks = {
        "ticks": stats["ticks"] == n,
        "resumed_at_tick": stats.get("resumed_from") == {"group0": warm},
        "scored": stats["scored"] == n * len(ids),
        # the first tick's values were sent before its poll: nothing missing
        "missing_values": stats["missing_values"] == 0,
        "records_parsed": stats["records_parsed"] == sent == n * len(ids),
        "kernel_launches": stats["kernel_launches"]["tm_learn"] == n,
        "exit_checkpoint_ticks": ticks_saved == warm + n,
        "exit_checkpoint_equals_b": not unequal and set(got) == set(want),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"24(c) failed {bad} (leaves unequal {unequal[:8]}): "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }")
    out["launches"]["import_serve"] = stats["kernel_launches"]["tm_learn"]
    out["seconds"]["c"] = time.perf_counter() - t0
    emit("import", part="c", card=card, streams=len(ids), ticks=stats["ticks"],
         resumed_from=stats["resumed_from"], kernel_launches=out["launches"]["import_serve"],
         leaves_equal=len(want), latency_p50_ms=stats["latency_p50_ms"],
         latency_p99_ms=stats["latency_p99_ms"], elapsed_s=stats["elapsed_s"],
         seconds=out["seconds"]["c"])
    emit("imports", seconds=out["seconds"], launches=out["launches"], card=card)
    return out


# ---------------------------------------------------------------- phase 25
def _alert_scores(path: str) -> tuple[dict, int]:
    """{alert_id: (raw_score, log_likelihood)} of an alert stream's alert
    lines, and how many ids came twice."""
    out, dup = {}, 0
    with open(path) as f:
        for line in f:
            if line.startswith('{"event"'):
                continue
            rec = json.loads(line)
            dup += rec["alert_id"] in out
            out[rec["alert_id"]] = (rec["raw_score"], rec["log_likelihood"])
    return out, dup


def _mem_digest(groups) -> dict:
    """_ck_digest's per-leaf digest of groups in memory, under the names
    their save_group files carry."""
    from rtap_tpu_torch.models.state import state_to_numpy

    out = {}
    for gi, g in enumerate(groups):
        base = f"group{gi:04d}/state"
        out.update({f"{base}/model/{k}.npy": _leaf_digest(np.asarray(v))
                    for k, v in state_to_numpy(g.state).items()})
        out.update({f"{base}/likelihood/{k}.npy": _leaf_digest(np.asarray(v))
                    for k, v in g.likelihood.state_dict().items()})
        out[f"{base}/alert_run.npy"] = _leaf_digest(np.asarray(g._alert_run))
        out[f"group{gi:04d}/ticks"] = g.ticks
    return out


def _sched_cfg():
    from rtap_tpu_torch.config import cluster_preset

    return cluster_preset().with_learn_every(SCHED_LEARN_EVERY, full_until=0)


def _sched_source(feed: list, n: int):
    """live_loop's source for phase 25's reference: tick 0 polls nothing
    (every value missing, the wall clock's ts, as the child's listener
    gives), tick t the values and ts of feed[t - 1]."""
    rows = [(np.array([r["value"] for r in recs], np.float32), int(recs[0]["ts"]))
            for recs in feed]

    def source(k):
        if k == 0:
            return np.full(n, np.nan, np.float32), int(time.time())
        return rows[k - 1]
    return source


def phase_sched(seed: int, card: str, serve_row: dict) -> dict:
    """Phase 25: the scheduling flags. `serve` at phase 6's shape with
    ``--micro-chunk 4 --chunk-stagger --stagger-learn --learn-every 4
    --learn-full-until 0 --dispatch-threads 4``, the warm-up on (the
    default), the journal and checkpoints every 8 ticks, threshold 0 with a
    debounce of SCHED_DEBOUNCE, fed phase 6's ticks; held to the same
    staggered registry stepped one tick at a time in this process (no
    chunk stagger, no threads), and group 0 stepped again through the
    plain TM pass."""
    import types

    import rtap_tpu_torch.ops.tm_learn as tl
    from rtap_tpu_torch.models.state import state_to_numpy
    from rtap_tpu_torch.service.aot import knowable_programs
    from rtap_tpu_torch.service.loop import live_loop
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    from rtap_tpu_torch.resilience.journal import last_journal_tick

    ids, ticks = serve_row["feed"]  # phase 6's seeded ticks
    feed = ticks[:SCHED_TICKS - 1]
    groups = SERVE_STREAMS // SERVE_GROUP
    cfg = _sched_cfg()
    work = tempfile.mkdtemp(prefix="rtap-sched-")
    ref_dir = tempfile.mkdtemp(prefix="rtap-sched-ref-")
    ck = os.path.join(work, "ck")
    r: dict = {}

    def reference():
        """The same staggered registry stepped one tick at a time, serially,
        then group 0 again through the plain TM pass; run once the child is
        in its last tick (a save tick), while it serves it and exits."""
        deadline = DEADLINE.until(120)
        while last_journal_tick(os.path.join(work, "journal")) < SCHED_TICKS - 1 \
                and time.time() < deadline:
            time.sleep(0.01)
        with timed_part("reference registry build"):
            reg = StreamGroupRegistry(cfg, group_size=SERVE_GROUP, device="cuda", threshold=0.0,
                                      debounce=SCHED_DEBOUNCE, stagger_learn=True)
            for sid in ids:
                reg.add_stream(sid)
            reg.finalize()
        tl.reset_launches()
        with timed_part("reference run (one tick at a time)"):
            r["stats"] = live_loop(_sched_source(feed, len(ids)), reg, n_ticks=SCHED_TICKS,
                                   cadence_s=0.0,
                                   alert_path=os.path.join(ref_dir, "alerts.jsonl"))
            torch.cuda.synchronize()
        r["launches"] = tl.launches
        with timed_part("reference digest"):
            r["digest"] = _mem_digest(reg.groups)
        r["g0_kernel"] = state_to_numpy(reg.groups[0].state)
        g0_cfg = reg.groups[0].cfg
        del reg
        torch.cuda.empty_cache()
        plain_kernel = tl.tm_learn_kernel
        tl.tm_learn_kernel = lambda *a: tl.tm_learn_plain(*a)
        try:
            with timed_part("group 0 through the plain TM pass"):
                preg = StreamGroupRegistry(g0_cfg, group_size=SERVE_GROUP, device="cuda",
                                           threshold=0.0, debounce=SCHED_DEBOUNCE)
                for sid in ids[:SERVE_GROUP]:
                    preg.add_stream(sid)
                preg.finalize()
                src = _sched_source([recs[:SERVE_GROUP] for recs in feed], SERVE_GROUP)
                tl.reset_launches()
                live_loop(src, preg, n_ticks=SCHED_TICKS, cadence_s=0.0)
                torch.cuda.synchronize()
                r["plain_launches"] = tl.launches
                r["g0_plain"] = state_to_numpy(preg.groups[0].state)
            del preg
        finally:
            tl.tm_learn_kernel = plain_kernel
        torch.cuda.empty_cache()

    try:
        stats, sent, _ = _serve_child(ids, feed, work, [
            "--micro-chunk", str(SCHED_MICRO), "--chunk-stagger", "--stagger-learn",
            "--learn-every", str(SCHED_LEARN_EVERY), "--learn-full-until", "0",
            "--dispatch-threads", str(SCHED_THREADS), "--checkpoint-dir", ck,
            "--checkpoint-every", str(SCHED_CHECKPOINT_EVERY), "--threshold", "0",
            "--debounce", str(SCHED_DEBOUNCE)], n_ticks=SCHED_TICKS, on_last_fed=reference)
        missed = _missed_ticks(os.path.join(work, "alerts.jsonl"))
        with timed_part("child checkpoint digest"):
            child_digest = _ck_digest(ck)
        with timed_part("alert lines read"):
            child_alerts, child_dup = _alert_scores(os.path.join(work, "alerts.jsonl"))
            ref_alerts, ref_dup = _alert_scores(os.path.join(ref_dir, "alerts.jsonl"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(ref_dir, ignore_errors=True)
    ref, ref_launches, ref_digest = r["stats"], r["launches"], r["digest"]
    g0_kernel, g0_plain, plain_launches = r["g0_kernel"], r["g0_plain"], r["plain_launches"]

    stand_ins = [types.SimpleNamespace(cfg=dataclasses.replace(
        cfg, learn_phase=gi % SCHED_LEARN_EVERY)) for gi in range(groups)]
    want_programs = len(knowable_programs(stand_ins, SCHED_MICRO, True))
    sched = stats["schedule"]
    save_ticks = {k for k in range(SCHED_TICKS) if (k + 1) % SCHED_CHECKPOINT_EVERY == 0}
    per_tick = groups // SCHED_LEARN_EVERY
    diff = sorted(k for k in ref_digest.keys() | child_digest.keys()
                  if ref_digest.get(k) != child_digest.get(k))
    alert_ticks = SCHED_TICKS - SCHED_DEBOUNCE + 1
    g0_diff = [k for k in g0_kernel if not np.array_equal(
        g0_kernel[k], g0_plain[k], equal_nan=g0_kernel[k].dtype.kind == "f")]
    checks = {
        "ticks": stats["ticks"] == SCHED_TICKS
                 and stats["scored"] == SCHED_TICKS * SERVE_STREAMS,
        "missing_values": stats["missing_values"] == SERVE_STREAMS
                          and sent == (SCHED_TICKS - 1) * SERVE_STREAMS,
        # (a) the warm-up: only the save ticks miss, every knowable program
        # warmed, none dispatched cold
        "missed_ticks": all(t in save_ticks for t, _ in missed)
                        and len(missed) == stats["missed_deadlines"],
        "aot_programs": stats["aot_programs_compiled"] == want_programs
                        == len({c.cfg for c in stand_ins}) * SCHED_MICRO,
        "cold_compiles": stats["cold_compiles_after_warmup"] == 0,
        # (b) the schedule changes when, not what
        "state_digest": not diff and len(child_digest) == len(ref_digest) > groups,
        "alerts": child_alerts == ref_alerts and not child_dup and not ref_dup
                  and len(ref_alerts) == alert_ticks * SERVE_STREAMS,
        # (c) the stagger is real: n_groups / learn_every groups learn on
        # each tick's row, and each tick launches that many passes; past
        # the save ticks' realignment each tick dispatches one class
        "learning_groups": sched["learning_groups"] == [per_tick] * SCHED_TICKS,
        "launches_per_tick": sched["kernel_launches"] == [per_tick] * SCHED_TICKS,
        "groups_dispatched": all(n == (groups if k in save_ticks else groups // SCHED_MICRO)
                                 for k, n in enumerate(sched["groups_dispatched"])),
        # (d) the kernel on this path
        "kernel_launches": stats["kernel_launches"]["tm_learn"] == stats["learned_group_ticks"]
                           == groups * SCHED_TICKS // SCHED_LEARN_EVERY == ref_launches
                           == ref["learned_group_ticks"],
        "aot_launches_apart": stats["aot_kernel_launches"] > 0,
        "plain_pass": not g0_diff and plain_launches == 0,
        # (e) the effective thread count
        "dispatch_threads": stats["dispatch_threads"] == SCHED_THREADS,
        "tm_overflow_total": stats["tm_overflow_total"] == 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"25 scheduling flags failed {bad}: missed {missed}, digest diff "
                             f"{diff[:8]}, alerts {len(child_alerts)} vs {len(ref_alerts)} "
                             f"(dup {child_dup}/{ref_dup}), group 0 plain diff {g0_diff[:8]}, "
                             f"programs want {want_programs}, ref launches {ref_launches}: "
                             f"{ {k: v for k, v in stats.items() if k != 'telemetry'} }")
    row = dict(streams=SERVE_STREAMS, groups=groups, group_size=SERVE_GROUP, ticks=stats["ticks"],
               cadence_s=stats["cadence_s"], pipeline_depth=stats["pipeline_depth"],
               micro_chunk=stats["micro_chunk"], chunk_stagger=stats["chunk_stagger"],
               learn_every=SCHED_LEARN_EVERY, dispatch_threads=stats["dispatch_threads"],
               aot_programs_compiled=stats["aot_programs_compiled"],
               cold_compiles_after_warmup=stats["cold_compiles_after_warmup"],
               aot_warmup_s=stats["aot_warmup_s"], aot_kernel_launches=stats["aot_kernel_launches"],
               tick0_ms=stats["tick0_ms"], missed_ticks=missed, save_ticks=sorted(save_ticks),
               schedule=sched, phase_ms_per_tick=stats["phase_ms_per_tick"],
               phase6_phase_ms_per_tick=serve_row["phase_ms_per_tick"],
               latency_p50_ms=stats["latency_p50_ms"], latency_p99_ms=stats["latency_p99_ms"],
               latency_max_ms=stats["latency_max_ms"],
               phase6_latency_p50_ms=serve_row["latency_p50_ms"],
               kernel_launches=stats["kernel_launches"]["tm_learn"],
               learned_group_ticks=stats["learned_group_ticks"],
               reference_launches=ref_launches, leaves_compared=len(child_digest),
               alert_ids_compared=len(ref_alerts), plain_pass_leaves_equal=len(g0_plain),
               hbm_peak_bytes_in_use=stats["hbm_peak_bytes_in_use"], card=card)
    emit("sched_serve", **row)
    return row


def _plane_watch(root_pid: int, stop: threading.Event, seen: dict) -> threading.Thread:
    """Until `stop`: every 0.25 s, each descendant of `root_pid` that is a
    ``--control-only`` plane or a drill member, and whether it has the
    card's device files open (`_holds_the_card`); each plane pid once in
    ``nvidia-smi --query-compute-apps`` too, a second after it was seen.
    -> seen = {"plane": {pid: {"holds_the_card", "in_nvidia_smi"}},
    "member": {pid: holds}}."""
    def run():
        while not stop.is_set():
            for pid in _descendants(root_pid):
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        argv = f.read().split(b"\0")
                    if b"--control-only" in argv:
                        row = seen["plane"].setdefault(pid, {"holds_the_card": False,
                                                             "seen": time.monotonic()})
                        row["holds_the_card"] |= _holds_the_card(pid)
                        if "in_nvidia_smi" not in row and time.monotonic() - row["seen"] > 1:
                            row["in_nvidia_smi"] = str(pid) in _gpu_apps().replace(",", " ").split()
                    elif b"--spare" in argv:
                        seen["member"][pid] = seen["member"].get(pid, False) \
                            or _holds_the_card(pid)
                except OSError:
                    continue  # it ended between the listing and the read
            stop.wait(0.25)

    t = threading.Thread(target=run, name="chip-smoke-plane-watch", daemon=True)
    t.start()
    return t


def phase_fleet_chaos(card: str) -> dict:
    """26: ``python -m rtap_tpu_torch.fleet_chaos --device cuda`` as a child:
    two control-plane shards of CONTROL_STREAMS full-width streams (one
    group each) -> the row, with each life's and each reference's launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="rtap-fleet-chaos-")
    out, err = os.path.join(work, "report.json"), os.path.join(work, "stderr")
    fc = FLEET_CHAOS
    cmd = [sys.executable, "-m", "rtap_tpu_torch.fleet_chaos", "--device", "cuda",
           "--seed", str(fc["seed"]), "--streams", str(CONTROL_STREAMS),
           "--group-size", str(CONTROL_STREAMS), "--ticks", str(fc["ticks"]),
           "--cadence", str(fc["cadence"]), "--checkpoint-every", str(fc["checkpoint_every"]),
           "--workdir", os.path.join(work, "w"), "--out", out]
    seen: dict = {"plane": {}, "member": {}}
    stop = threading.Event()
    t0 = time.perf_counter()
    try:
        with open(err, "w") as ef:
            p = spawn_child(cmd, cwd=here, stdout=subprocess.DEVNULL, stderr=ef)
            watch = _plane_watch(p.pid, stop, seen)
            try:
                rc = p.wait(timeout=DEADLINE.cap(600))
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
                raise
            finally:
                stop.set()
                watch.join(timeout=30)
        part("fleet_chaos child", time.perf_counter() - t0)
        with open(err) as f:
            log_tail = f.read()[-4000:]
        if rc != 0 or not os.path.exists(out):
            raise AssertionError(f"26: fleet_chaos exited {rc}:\n{log_tail}")
        with open(out) as f:
            rep = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ticks, budget = fc["ticks"], rep["takeover_budget_ticks"]
    lives = [ln for i in sorted(rep["stats_lines"]) for ln in rep["stats_lines"][i]]
    promotions = [p for s in rep["shards_verdict"] for p in s["promotions"]]
    grants = rep["control_journal"]["grants_per_shard"]
    checks = {
        # the JAX twin's assertions (tests/integration/test_fleet_chaos.py)
        "verified": rep["verified"],
        "leader_kills": len(rep["leader_kills"]) == 2,
        "standby_kill": rep["standby_kill"] is not None,
        "outage_survived": bool(rep["control_outage"]
                                and rep["control_outage"]["leaders_survived"]
                                and rep["control_outage"]["degraded_ticks_fleet"] > 0),
        "fence_rc_7": (rep["fence_round"] or {}).get("rc") == 7,
        "drain_rc_0": (rep["drain_round"] or {}).get("rc") == 0,
        "exactly_once": all(s["duplicated"] == s["lost"] == s["extra"] == 0
                            and s["state_leaves_compared"] > 0
                            for s in rep["shards_verdict"]),
        "grants_rise": all(eps == sorted(set(eps)) for eps in grants.values()),
        "degraded_ticks_stats": rep["degraded_ticks_stats"] > 0,
        # and the card's
        "alert_ids": all(s["alert_ids"] == CONTROL_STREAMS * ticks
                         for s in rep["shards_verdict"]),
        "lives_launch_their_learned_ticks": bool(lives) and all(
            ln["kernel_launches"] == ln["learned_group_ticks"] for ln in lives),
        "references_launch_every_tick": [(r or {}).get("kernel_launches")
                                         for r in rep["reference_lines"]] == [ticks, ticks],
        "detect_within_budget": bool(promotions) and all(
            p["detect_ticks"] is not None and p["detect_ticks"] <= budget for p in promotions),
        "no_unscheduled_fence": not rep["unscheduled_fences"],
        "plane_without_cuda": len(seen["plane"]) == 2 and not any(
            r["holds_the_card"] or r.get("in_nvidia_smi", True)
            for r in seen["plane"].values()),
        "members_hold_the_card": any(seen["member"].values()),
    }
    launches = {f"ref{i}": (r or {}).get("kernel_launches")
                for i, r in enumerate(rep["reference_lines"])}
    for i in sorted(rep["stats_lines"]):
        for j, ln in enumerate(rep["stats_lines"][i]):
            launches[f"shard{i}_{j}_{ln['name']}"] = ln["kernel_launches"]
    for name, secs in rep["timing"].items():
        part(f"fleet_chaos {name}", secs)
    row = dict(
        streams_per_shard=CONTROL_STREAMS, ticks=ticks, cadence_s=fc["cadence"],
        lease_timeout_s=rep["lease_timeout_s"], schedule=rep["schedule"],
        fired_at_ticks=rep["fired_at_ticks"],
        promotions=[dict(shard=s["shard"], **p) for s in rep["shards_verdict"]
                    for p in s["promotions"]],
        leader_kills=rep["leader_kills"], standby_kill=rep["standby_kill"],
        control_outage=rep["control_outage"], control_lives=rep["control_lives"],
        degraded_ticks=dict(fleet=rep["degraded_ticks_total"],
                            stats=rep["degraded_ticks_stats"], events=rep["degraded_events"]),
        fence_round=rep["fence_round"], drain_round=rep["drain_round"],
        grants_per_shard=grants,
        alert_ids=[s["alert_ids"] for s in rep["shards_verdict"]],
        life_launches=[{k: ln.get(k) for k in ("name", "shard", "kernel_launches",
                                               "learned_group_ticks", "ran", "fenced",
                                               "drained", "stopped")} for ln in lives],
        children=[{k: c.get(k) for k in ("name", "start_to_warm_s", "release_to_role_s",
                                          "start_to_role_s", "role")} for c in rep["lives"]],
        reference_s=rep["reference_s"], timing=rep["timing"], wall_s=rep["wall_s"],
        planes={pid: {k: r.get(k) for k in ("holds_the_card", "in_nvidia_smi")}
                for pid, r in seen["plane"].items()},
        members_holding_the_card=sum(seen["member"].values()),
        seconds=time.perf_counter() - t0, card=card)
    emit("fleet_chaos", **row)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"26: fleet chaos checks failed {bad}: {rep['failures']}\n"
                             f"{log_tail}")
    return dict(row, launches=launches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", type=int, default=32768)
    ap.add_argument("--ticks", type=int, default=128)
    ap.add_argument("--warm-ticks", type=int, default=100,
                    help="learning ticks before the kernel-vs-plain comparisons")
    ap.add_argument("--deadline-s", type=float, default=DEADLINE_S,
                    help="the whole run's deadline in seconds from the script's start: "
                         "reaching it kills the running phase's children, prints a "
                         '{"phase": "deadline", ...} line naming that phase and exits '
                         f"{DEADLINE_RC}")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cpu-refs", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.cpu_refs:  # the background CPU references: no card by design
        return run_cpu_refs(args)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.child:
        return run_drill_child(args)
    DEADLINE.arm(args.deadline_s)
    DEADLINE.begin(PHASE_NAMES[2])
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    # child processes (serve, the supervised chaos child) import the port
    # from the checkout
    os.chdir(here)
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
        DEADLINE.end(PHASE_NAMES[n], seconds[n])
        DEADLINE.begin(PHASE_NAMES.get(n + 1, "results"))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # what the host is, and one fixed CPU workload's seconds, before any phase
    host_line()
    # 1. the card
    p = run_child(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                  timeout=60)
    if p.returncode != 0:
        raise AssertionError(f"nvidia-smi exited {p.returncode}: {p.stderr}")
    smi = p.stdout.strip().splitlines()[0]
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
    # the CPU references, in one background process from here on
    BG.start(args.seed)

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
    rows["replay"], main_row, streams = phase_slice(args.streams, args.ticks, args.seed, smi)
    cmp_rows.append(main_row)
    mark(4)
    # 5. card vs CPU
    phase_card_vs_cpu(args.seed)
    torch.cuda.empty_cache()  # the children below need the card's memory
    mark(5)
    # 6. serve at full width through the real entry point
    serve_row = phase_serve(args.seed, smi, streams)
    del streams
    rows["serve"] = serve_row["kernel_launches"]
    mark(6)
    # 7. kill -9 drill
    rows["kill_drill"] = phase_kill_drill(args.seed, smi)["fault_free_kernel_launches"]
    mark(7)
    # 8. serve with the model-side flags at full width
    rows["serve_model_side"] = phase_serve_model_side(args.seed, smi,
                                                      serve_row)["kernel_launches"]
    mark(8)
    # 9. flags on vs off, and the reducers card vs CPU; the background's
    # other jobs start with it (none overlaps the serve phases 6-8)
    BG.go()
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
    # 19. resilience on the card: the chaos soak, its drills
    res = phase_resilience(smi)
    rows["chaos_soak"] = res["soak"]["kernel_launches"]
    rows["degrade"] = res["degrade"]["kernel_launches"]
    rows["supervise_last_life"] = res["supervise"]["last_life"]["kernel_launches"]
    rows["topology_burst"] = res["topology_burst"]["kernel_launches"]
    torch.cuda.empty_cache()
    mark(19)
    # 20. the obs cost gate
    phase_obs_cost(smi)
    mark(20)
    # 21. binary ingest: serve over RB1 at full width, the three transports
    # equal, FRAME replay after a kill -9, the host ingest bench
    b = phase_binary_ingest(args.seed, smi, serve_row)
    rows["binary_serve"] = b["a"]["kernel_launches"]
    rows.update({f"transport_{k}": n for k, n in b["b"]["launches"].items()})
    rows["binary_kill_reference"] = b["c"]["reference_launches"]
    rows["binary_kill_resumed_life"] = b["c"]["resumed_launches"]
    mark(21)
    # 22. replication and the fleet plane: the full-width leader/standby
    # pair killed and taken over, the failover soak, the wire chaos soak
    r = phase_replication(args.seed, smi, serve_row)
    rows["standby_applied"] = r["a"]["standby_kernel_launches"]
    rows["promoted_leader"] = r["a"]["served_kernel_launches"]
    rows["failover_soak_reference"] = r["b"]["reference_kernel_launches"]
    rows["replication_chaos"] = r["c"]["kernel_launches"]
    mark(22)
    # 23. the control plane: a --control-only plane, two shards' leaders and
    # a standby on the card; the plane killed and restarted, shard 0 drained
    rows.update({f"control_{k}": n
                 for k, n in phase_control_plane(args.seed, smi)["kernel_launches"].items()})
    torch.cuda.empty_cache()
    mark(23)
    # 24. the JAX package's orbax checkpoints imported on the card
    imp = phase_imports(smi)
    rows.update(imp["launches"])
    cmp_rows += imp["kernel_rows"]
    torch.cuda.empty_cache()
    mark(24)
    # 25. serve's scheduling flags: stagger, threads and the warm-up at
    # phase 6's shape, held to the one-tick-at-a-time schedule
    sched = phase_sched(args.seed, smi, serve_row)
    rows["sched_serve"] = sched["kernel_launches"]
    rows["sched_serve_warm_up"] = sched["aot_kernel_launches"]
    rows["sched_reference"] = sched["reference_launches"]
    torch.cuda.empty_cache()
    mark(25)
    # 26. the fleet chaos drill: two control-plane shards of 1,024 streams
    rows.update({f"fleet_chaos_{k}": n for k, n in phase_fleet_chaos(smi)["launches"].items()})
    mark(26)
    BG.join()
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
    try:
        sys.exit(run_guarded(main))
    finally:
        BG.kill()  # whatever ended the run, the background references end with it
