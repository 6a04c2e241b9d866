"""Host ingest-path benchmark: JSONL (native C / pure Python) vs the RB1
binary batch protocol (in-process decode, socket and shared-memory ring).

The port of the JAX package's ``scripts/ingest_bench.py``: every transport
over the same record stream on this host, records/s from the first byte
sent to the last record applied (an in-order sentinel record closes each
socket run). The gate is the JAX package's: the binary socket path parses
at least 1M rows/s AND at least 5x the native JSONL TCP path. Host work
only: no device is touched (the slot map comes from a CPU registry).

    python -m rtap_tpu_torch.ingest_bench [--records 1000000] [--streams 4096]
        [--frame-rows 8192] [--out R.json]

Prints one JSON line; exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time

import numpy as np

from rtap_tpu_torch.service.sources import TcpJsonlSource

#: distinctive final-record value; in-order delivery (TCP / ring FIFO) means
#: seeing it implies every earlier record was parsed
SENTINEL = -987654.5


def make_payload(n_records: int, ids: list[str]) -> bytes:
    G = len(ids)
    return "".join(
        json.dumps({"id": ids[i % G], "value": 1.0 + (i % 1000) * 0.5,
                    "ts": 1_700_000_000 + i}) + "\n"
        for i in range(n_records)
    ).encode()


def _rate(n_records: int, dt: float) -> dict:
    return {"records_per_sec": round(n_records / dt), "wall_s": round(dt, 3)}


def socket_drive(native: bool, payload: bytes, n_records: int, ids: list[str]) -> dict:
    """Push the payload through the real JSONL listener; wall time until the
    in-order sentinel record (appended after the payload) is applied."""
    src = TcpJsonlSource(ids, native=native)
    tail = (json.dumps({"id": ids[0], "value": SENTINEL}) + "\n").encode()
    with src:
        t0 = time.perf_counter()
        with socket.create_connection(src.address, timeout=5.0) as s:
            s.sendall(payload + tail)
        deadline = time.time() + 600
        done = False
        while time.time() < deadline:
            with src._lock:
                done = src._latest[0] == np.float32(SENTINEL)
            if done:
                break
            time.sleep(0.005)
        dt = time.perf_counter() - t0
    if not done:
        raise SystemExit("ingest bench: payload not fully consumed in budget")
    return _rate(n_records, dt)


def inproc_drive(payload: bytes, n_records: int, ids: list[str]) -> dict:
    """Native parser cost alone (no socket): 64 KiB chunks like the handler."""
    from rtap_tpu_torch.native import NativeJsonlState

    latest = np.full(len(ids), np.nan, np.float32)
    st = NativeJsonlState(ids, latest)
    conn = st.new_conn()
    t0 = time.perf_counter()
    for off in range(0, len(payload), 65536):
        conn.feed(payload[off:off + 65536])
    conn.flush()
    dt = time.perf_counter() - t0
    assert st.counters[0] == n_records, st.counters
    conn.close()
    return _rate(n_records, dt)


def make_frames(n_records: int, slot_map: dict, ids: list[str],
                frame_rows: int) -> list[bytes]:
    """The same record stream as make_payload, as RB1 DATA frames."""
    from rtap_tpu_torch.ingest.protocol import data_frame, encode_slot

    G = len(ids)
    code_by_pos = np.array([encode_slot(a.shard, a.group, a.slot)
                            for a in (slot_map[s] for s in ids)], np.uint32)
    idx = np.arange(n_records, dtype=np.int64)
    codes = code_by_pos[idx % G]
    values = (1.0 + (idx % 1000) * 0.5).astype(np.float32)
    frames = []
    for off in range(0, n_records, frame_rows):
        sl = slice(off, min(off + frame_rows, n_records))
        frames.append(data_frame(codes[sl], values[sl], 1_700_000_000 + off,
                                 deltas=(idx[sl] - off).astype(np.uint16)))
    return frames


def binary_socket_drive(frames: list[bytes], n_records: int, slot_map: dict) -> dict:
    """Full pipeline over a real socket: frame walk + CRC + decode + scatter,
    sentinel-terminated like the JSONL drives."""
    from rtap_tpu_torch.ingest import BinaryBatchSource
    from rtap_tpu_torch.ingest.protocol import data_frame

    src = BinaryBatchSource(slot_map).start()
    tail = data_frame(src._table.codes[:1], np.array([SENTINEL], np.float32), 1_700_000_000)
    try:
        t0 = time.perf_counter()
        with socket.create_connection(src.address, timeout=5.0) as s:
            s.recv(1 << 20)  # MAP hello
            for fr in frames:
                s.sendall(fr)
            s.sendall(tail)
            deadline = time.time() + 600
            done = False
            while time.time() < deadline:
                with src._lock:
                    done = src._latest[0] == np.float32(SENTINEL)
                if done:
                    break
                time.sleep(0.005)
        dt = time.perf_counter() - t0
    finally:
        src.close()
    if not done:
        raise SystemExit("ingest bench: binary payload not consumed in budget")
    return _rate(n_records, dt)


def binary_inproc_drive(frames: list[bytes], n_records: int, slot_map: dict) -> dict:
    """Decode + scatter cost alone (no socket): walker feed per frame."""
    from rtap_tpu_torch.ingest import BinaryBatchSource

    src = BinaryBatchSource(slot_map, port=None)
    t0 = time.perf_counter()
    src.feed_frames(frames)
    dt = time.perf_counter() - t0
    assert src.records_parsed == n_records, src.records_parsed
    return _rate(n_records, dt)


def shm_drive(frames: list[bytes], n_records: int, slot_map: dict) -> dict:
    """Shared-memory ring end to end: producer push + per-tick drain; the
    ring's torn-read counts (garbage bytes, bad CRCs) ride along."""
    from rtap_tpu_torch.ingest import BinaryBatchSource, ShmRing

    name = f"rtap_ibench_{os.getpid()}"
    ring_bytes = 32 << 20
    if any(len(fr) > ring_bytes for fr in frames):
        raise SystemExit("ingest bench: a frame exceeds the shm ring capacity "
                         f"({ring_bytes} B) — lower --frame-rows")
    src = BinaryBatchSource(slot_map, port=None, shm=name, shm_bytes=ring_bytes)
    w = ShmRing.attach(name)
    tick = 0
    deadline = time.time() + 600  # a wedged ring must fail, not hang the bench
    try:
        t0 = time.perf_counter()
        for fr in frames:
            while not w.push(fr):
                src(tick)  # ring full: consumer drains (backpressure)
                tick += 1
                if time.time() > deadline:
                    raise SystemExit("ingest bench: shm ring wedged")
        while src.records_parsed < n_records:
            src(tick)
            tick += 1
            if time.time() > deadline:
                raise SystemExit("ingest bench: shm payload not consumed in budget")
        dt = time.perf_counter() - t0
    finally:
        w.close()
        src.close()
    return {**_rate(n_records, dt), "garbage_bytes": src.garbage_bytes,
            "parse_errors": src.parse_errors}


def registry_slot_map(ids: list[str], group_size: int) -> dict:
    """The registry's slot map for `ids` in groups of `group_size`, from a
    CPU registry of the narrowest cluster width (the map depends on the
    ids and the group size only)."""
    from rtap_tpu_torch.config import scaled_cluster_preset
    from rtap_tpu_torch.service.registry import StreamGroupRegistry

    reg = StreamGroupRegistry(scaled_cluster_preset(32), group_size=min(group_size, len(ids)),
                              device="cpu")
    for sid in ids:
        reg.add_stream(sid)
    reg.finalize()
    return reg.slot_map()


def run(records: int, streams: int, frame_rows: int, group_size: int = 1024,
        jsonl_records: int | None = None) -> dict:
    ids = [f"node{i // 4:04d}.m{i % 4}" for i in range(streams)]
    slot_map = registry_slot_map(ids, group_size)
    n_jsonl = jsonl_records or min(records, 300_000)
    payload = make_payload(n_jsonl, ids)
    frames = make_frames(records, slot_map, ids, frame_rows)

    native_inproc = inproc_drive(payload, n_jsonl, ids)
    native_sock = socket_drive(True, payload, n_jsonl, ids)
    python_sock = socket_drive(False, payload, n_jsonl, ids)
    bin_inproc = binary_inproc_drive(frames, records, slot_map)
    bin_sock = binary_socket_drive(frames, records, slot_map)
    shm = shm_drive(frames, records, slot_map)

    from rtap_tpu_torch.ingest.protocol import FrameWalker

    return {
        "records": records,
        "jsonl_records": n_jsonl,
        "streams": streams,
        "frame_rows": frame_rows,
        "payload_mb_jsonl": round(len(payload) / 1e6, 1),
        "payload_mb_binary": round(sum(len(f) for f in frames) / 1e6, 1),
        "native_walker": FrameWalker().native_active,
        "native_parser_inproc": native_inproc,
        "native_socket_end_to_end": native_sock,
        "python_socket_end_to_end": python_sock,
        "binary_decode_inproc": bin_inproc,
        "binary_socket_end_to_end": bin_sock,
        "binary_shm_ring_end_to_end": shm,
        "speedup_jsonl_native_vs_python": round(
            native_sock["records_per_sec"] / python_sock["records_per_sec"], 1),
        "speedup_binary_vs_jsonl_socket": round(
            bin_sock["records_per_sec"] / native_sock["records_per_sec"], 1),
        "gate_binary_1m_rows_per_sec": bin_sock["records_per_sec"] >= 1_000_000,
        "gate_binary_5x_jsonl": bin_sock["records_per_sec"] >= 5 * native_sock["records_per_sec"],
        "host_cores": len(os.sched_getaffinity(0)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=1_000_000)
    ap.add_argument("--jsonl-records", type=int, default=None,
                    help="records for the (slow) JSONL lanes; default: "
                         "min(records, 300k) — rates are per-second either way")
    ap.add_argument("--streams", type=int, default=4096)
    ap.add_argument("--frame-rows", type=int, default=8192,
                    help="rows per RB1 DATA frame")
    ap.add_argument("--group-size", type=int, default=1024)
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    result = run(args.records, args.streams, args.frame_rows, args.group_size,
                 args.jsonl_records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    return 0 if result["gate_binary_1m_rows_per_sec"] and result["gate_binary_5x_jsonl"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
