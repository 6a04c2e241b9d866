"""PyTorch port vs the JAX package: the native JSONL parser.

The port's copy of ``jsonl_parser.c`` (built by the port into its own
``_build/``) against the JAX package's native parser and against the port's
Python path: value and ts coercions, oversized lines and escapes, the
counter order, unknown-name capture, ``set_ids`` swapping the table
mid-connection, and the forced Python path (``native=False``) — directly
on seeded fuzz and through the TCP listener.
"""

import json
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rtap_tpu.native import NativeJsonlState as JNativeJsonlState
from rtap_tpu.service.sources import TcpJsonlSource as JTcpJsonlSource
from rtap_tpu_torch.native import NativeJsonlState
from rtap_tpu_torch.service.sources import TcpJsonlSource, send_jsonl

torch.set_num_threads(1)

IDS = ["node0000.m0", "node0000.m1", "a", "long." * 10 + "id"]


def _state(ids=IDS, cls=NativeJsonlState, track_unknown=False):
    latest = np.full(len(ids), np.nan, np.float32)
    return cls(ids, latest, track_unknown=track_unknown), latest


def _wait(cond, timeout=10.0):
    """True as soon as cond() is (each call may consume what it saw)."""
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            return False
        time.sleep(0.005)
    return True


def test_the_library_is_the_ports_own_build():
    from rtap_tpu_torch import native
    from rtap_tpu_torch.ops import _build

    native.load()
    path = native._lib._name
    assert path.startswith(str(_build.BUILD_DIR)) and "libjsonl_parser-" in path


# ------------------------------------------------------------ direct C API


def test_split_chunks_and_flush():
    st, latest = _state()
    c = st.new_conn()
    c.feed(b'{"id": "node0000.m0", "va')
    c.feed(b'lue": 2.5, "ts": 7}\n{"id": "a", "value"')
    c.feed(b': -1}\n{"id": "node0000.m1", "value": 9}')  # no trailing \n
    assert np.isnan(latest[1])  # unterminated: not yet processed
    c.flush()                   # EOF processes it, like rfile iteration
    assert (latest[0], latest[1], latest[2]) == (np.float32(2.5), np.float32(9), np.float32(-1))
    assert st.ts_buf[0] == 7 and list(st.counters) == [3, 0, 0]
    c.close()


def test_value_and_ts_coercions_match_python():
    st, latest = _state()
    c = st.new_conn()
    c.feed(b'{"id": "a", "value": "7.25", "ts": 101.9}\n')
    assert latest[2] == np.float32(7.25) and st.ts_buf[0] == 101
    c.feed(b'{"id": "a", "value": true, "ts": "144"}\n')
    assert latest[2] == np.float32(1.0) and st.ts_buf[0] == 144
    c.feed(b'{"id": "a", "value": -3e2}\n')
    assert latest[2] == np.float32(-300.0)
    c.feed(b'{"id": "a", "value": null}\n')  # np.float32(None) is nan
    assert np.isnan(latest[2]) and list(st.counters) == [4, 0, 0]
    c.feed(b'{"id": "a", "value": "null"}\n')  # np.float32("null") raises
    assert list(st.counters) == [4, 1, 0]
    c.feed(b'{"id": "a", "value": 5, "ts": "xx"}\n')  # value kept, ts error
    assert latest[2] == np.float32(5.0) and list(st.counters) == [4, 2, 0]
    c.feed(b'{"id": "a", "value": 6, "ts": "101.9"}\n')
    assert latest[2] == np.float32(6.0)
    c.feed(b'{"id": "a", "value": 8, "ts": "1e3"}\n')
    c.feed(b'{"id": "a", "value": "0x10"}\n')
    assert list(st.counters) == [4, 5, 0] and st.ts_buf[0] == 144
    c.feed(b'{"id": "a", "value": 7, "ts": " -12 "}\n')
    assert list(st.counters) == [5, 5, 0]
    c.close()


def test_counter_semantics_match_python_ordering():
    st, _ = _state()
    c = st.new_conn()
    c.feed(b'{"value": 5}\n')            # no id -> rec["id"] KeyError
    c.feed(b'{"id": "a"}\n')             # known id, no value -> KeyError
    c.feed(b'{"id": "zzz"}\n')           # unknown id checked BEFORE value
    c.feed(b'{"id": 5, "value": 1}\n')   # non-string id -> dict.get miss
    c.feed(b'garbage\n\n')               # malformed + empty line
    assert list(st.counters) == [0, 4, 2]
    c.feed(b'{"id": {"x": 1}, "value": 2}\n{"id": [1], "value": 2}\n')  # unhashable
    assert list(st.counters) == [0, 6, 2]
    c.close()


def test_oversized_line_resync_and_escapes():
    st, latest = _state()
    c = st.new_conn()
    c.feed(b'{"id": "a", "value": ' + b"9" * 70000)  # > MAX_LINE, no newline yet
    c.feed(b'999}\n{"id": "a", "value": 3}\n')
    assert list(st.counters) == [1, 1, 0] and latest[2] == np.float32(3.0)
    c.feed(b'{"note": "q\\"uoted", "id": "a", "meta": {"x": [1, 2]}, "value": 4}\n')
    assert latest[2] == np.float32(4.0) and list(st.counters) == [2, 1, 0]
    c.close()


def _fuzz_records(seed: int, ids: list[str], n: int, oversized: bool = False) -> list[bytes]:
    """Seeded realistic-space records: shuffled field order, mixed value/ts
    types (the coercible and the erroneous), unknown ids, extra fields,
    whitespace variation, escapes, malformed tails, and with `oversized`
    lines past the C parsers' MAX_LINE (a parse error there, where Python's
    json parses them: the documented divergence of the two backends)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        sid = ids[int(rng.integers(0, len(ids)))] if r < 0.8 else \
            rng.choice(["ghost", "ghost.2", "caf\\u00e9", "new.x"])
        value = rng.choice([str(float(rng.normal())), '"7.5"', "true", "false", "null",
                            '"nope"', str(int(rng.integers(-100, 100))), "1e3", "-0.0"])
        ts = rng.choice([str(int(rng.integers(1, 10**9))), '"123"', '"9.5"', "55.7", "null"])
        fields = [f'"id": "{sid}"', f'"value": {value}', f'"ts": {ts}',
                  '"extra": {"nested": [1, "x\\"y"]}']
        rng.shuffle(fields)
        line = "{" + (", " if rng.random() < 0.8 else ",").join(fields) + "}"
        if rng.random() < 0.06:
            line = line[: int(rng.integers(1, len(line)))]  # malformed tail
        if oversized and rng.random() < 0.01:
            line = '{"id": "' + "x" * 70000 + '", "value": 1}'  # oversized
        out.append(line.encode())
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_direct_fuzz_equals_the_jax_native_parser(seed):
    """Both C parsers fed the same bytes in the same seeded chunk splits:
    the same values, ts, counters and captured unknown names."""
    ids = [f"n{i}" for i in range(6)]
    payload = b"\n".join(_fuzz_records(seed, ids, 500, oversized=True)) + b"\n"
    rng = np.random.default_rng(seed + 100)
    cuts = np.sort(rng.integers(0, len(payload), 60))
    chunks = [payload[a:b] for a, b in zip([0, *cuts], [*cuts, len(payload)])]
    results = []
    for cls in (NativeJsonlState, JNativeJsonlState):
        st, latest = _state(ids, cls, track_unknown=True)
        c = st.new_conn()
        for ch in chunks:
            c.feed(ch)
        c.flush()
        c.close()
        results.append((latest.copy(), int(st.ts_buf[0]), list(st.counters),
                        st.drain_unknown_names()))
    (v, ts, cnt, unk), (jv, jts, jcnt, junk) = results
    assert np.array_equal(v, jv, equal_nan=True)
    assert (ts, cnt, unk) == (jts, jcnt, junk)
    assert cnt[1] > 0 and cnt[2] > 0 and unk


# ----------------------------------------------------- socket-level parity


def _drive_socket(src_cls, native, ids, payload, sentinel_value, track_unknown=False):
    sentinel = json.dumps({"id": ids[0], "value": sentinel_value}).encode() + b"\n"
    src = src_cls(ids, native=native, track_unknown=track_unknown)
    with src:
        assert src.native_active == (native is not False)
        with socket.create_connection(src.address, timeout=5.0) as s:
            s.sendall(payload + sentinel)
        assert _wait(lambda: src._latest[0] == np.float32(sentinel_value))
        values, ts = src(0)
        unknown = src.drain_unknown()
    return values, ts, src.parse_errors, src.unknown_ids, src.records_parsed, unknown


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_socket_fuzz_native_python_and_jax_agree(seed):
    """The port's listener, native and Python, and the JAX one (native):
    value for value and counter for counter over the seeded record space,
    unknown-name capture included."""
    ids = [f"n{i}" for i in range(6)]
    payload = b"\n".join(_fuzz_records(seed, ids, 400)) + b"\n"
    native = _drive_socket(TcpJsonlSource, True, ids, payload, 31337.0, True)
    python = _drive_socket(TcpJsonlSource, False, ids, payload, 31337.0, True)
    jax = _drive_socket(JTcpJsonlSource, True, ids, payload, 31337.0, True)
    for other in (python, jax):
        assert np.array_equal(native[0], other[0], equal_nan=True)
        assert native[1:5] == other[1:5]
    # the escaped id rides raw: the C parsers skip capturing it, the Python
    # path (json-decoded) captures it; everything else is captured alike
    assert native[5] == jax[5]
    assert set(python[5]) - set(native[5]) <= {"café"}
    assert native[2] > 0 and native[3] > 0 and native[4] > 0


def test_socket_parity_native_vs_python():
    ids = [f"s{i}" for i in range(8)]
    rng = np.random.default_rng(7)
    recs = [{"id": ids[int(rng.integers(0, 8))], "value": float(rng.normal()),
             "ts": 1700000000 + k} for k in range(500)]
    recs.insert(50, {"id": "nope", "value": 1.0})            # unknown
    recs.insert(90, {"id": ids[0], "value": "not-a-number"})  # parse error
    payload = "".join(json.dumps(r) + "\n" for r in recs).encode()
    v_n, ts_n, pe_n, unk_n, rec_n, _ = _drive_socket(TcpJsonlSource, True, ids, payload, 424242.0)
    v_p, ts_p, pe_p, unk_p, rec_p, _ = _drive_socket(TcpJsonlSource, False, ids, payload, 424242.0)
    assert np.array_equal(v_n, v_p, equal_nan=True)
    assert (ts_n, pe_n, unk_n) == (ts_p, pe_p, unk_p) == (ts_p, 1, 1)
    assert rec_n == rec_p == 501  # the sentinel counts too


def test_multi_connection_and_drain():
    src = TcpJsonlSource(["x", "y"], native=True)
    with src:
        send_jsonl(src.address, [{"id": "x", "value": 1.0, "ts": 10}])
        send_jsonl(src.address, [{"id": "y", "value": 2.0, "ts": 12}])
        assert _wait(lambda: src.records_parsed == 2)
        values, ts = src(0)
        assert values[0] == 1.0 and values[1] == 2.0 and ts == 12
        values2, ts2 = src(1)  # drained: all-NaN, ts sticks
        assert np.isnan(values2).all() and ts2 == 12


def test_concurrent_producers_stress():
    """Two live connections pushing interleaved records in tiny odd-sized
    writes: per-connection remainders stay apart and nothing is miscounted."""
    G = 32
    ids = [f"c{i}" for i in range(G)]
    src = TcpJsonlSource(ids, native=True)
    n_each = 400

    def produce(half: int):
        own = ids[half * (G // 2):(half + 1) * (G // 2)]
        with socket.create_connection(src.address, timeout=5.0) as s:
            payload = b"".join(json.dumps({"id": own[k % len(own)], "value": half * 1000.0 + k,
                                           "ts": 1700000000 + k}).encode() + b"\n"
                               for k in range(n_each))
            for off in range(0, len(payload), 17):
                s.sendall(payload[off:off + 17])

    with src:
        threads = [threading.Thread(target=produce, args=(h,)) for h in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert _wait(lambda: src.records_parsed >= 2 * n_each)
        assert src.records_parsed == 2 * n_each
        assert src.parse_errors == 0 and src.unknown_ids == 0
        values, ts = src(0)
    for half in (0, 1):
        own = list(range(half * (G // 2), (half + 1) * (G // 2)))
        for j, g in enumerate(own):
            last_k = max(k for k in range(n_each) if k % len(own) == j)
            assert values[g] == np.float32(half * 1000.0 + last_k)
    assert ts == 1700000000 + n_each - 1


def test_python_fallback_forced_and_bad_ts_not_counted():
    src = TcpJsonlSource(["x"], native=False)
    with src:
        assert not src.native_active
        send_jsonl(src.address, [{"id": "x", "value": 3.5, "ts": 9}])
        assert _wait(lambda: src.records_parsed == 1)
        values, ts = src(0)
        assert values[0] == np.float32(3.5) and ts == 9
        # a bad ts keeps the value (written first) but is a parse error
        send_jsonl(src.address, [{"id": "x", "value": 5, "ts": "xx"}])
        assert _wait(lambda: src.parse_errors == 1)
        values, _ = src(1)
    assert values[0] == np.float32(5.0) and src.records_parsed == 1


def test_native_unknown_name_capture():
    src = TcpJsonlSource(["a", "b"], port=0, native=True, track_unknown=True).start()
    try:
        assert src.native_active
        with socket.create_connection(src.address, timeout=5.0) as s:
            s.sendall(b'{"id": "caf\\u00e9", "value": 0.5}\n')  # escaped: not captured
        send_jsonl(src.address, [
            {"id": "a", "value": 1.0}, {"id": "newcomer.x", "value": 2.0},
            {"id": "newcomer.y", "value": 3.0}, {"id": "newcomer.x", "value": 4.0},
            {"id": 123, "value": 5.0}])  # numeric id: counted, not captured
        assert _wait(lambda: src.unknown_ids >= 5)
        assert src.unknown_ids == 5
        assert src.drain_unknown() == ["newcomer.x", "newcomer.y"]
        assert src.drain_unknown() == []
    finally:
        src.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_set_ids_swaps_table_mid_connection(native):
    """A membership change while a connection holds a partial line: the
    line completes against the new table, retained ids carry over by id."""
    src = TcpJsonlSource(["a", "b"], port=0, native=native, track_unknown=True).start()
    try:
        with socket.create_connection(src.address, timeout=5.0) as s:
            s.sendall(b'{"id": "a", "value": 7.0}\n{"id": "c", "value"')
            assert _wait(lambda: src._latest[0] == np.float32(7.0))
            src.set_ids(["c", "a"])  # new id first: the order is the caller's
            s.sendall(b": 9.0}\n")
        assert _wait(lambda: src._latest[0] == np.float32(9.0))
        values, _ = src(0)
        assert values[0] == np.float32(9.0)  # c: completed after the swap
        assert values[1] == np.float32(7.0)  # a: carried over by id
    finally:
        src.close()


def test_python_fallback_parse_error_count_is_exact_under_concurrency():
    src = TcpJsonlSource(["a", "b"], native=False)
    n_threads, n_bad = 6, 250

    def produce():
        with socket.create_connection(src.address, timeout=5.0) as s:
            s.sendall(b"".join(b"not json at all\n" for _ in range(n_bad)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # widen the lost-update window
    try:
        with src:
            threads = [threading.Thread(target=produce) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert _wait(lambda: src.parse_errors >= n_threads * n_bad)
            assert src.parse_errors == n_threads * n_bad and src.records_parsed == 0
    finally:
        sys.setswitchinterval(old)


def test_tcp_source_close_joins_accept_thread():
    src = TcpJsonlSource(["s0"], port=0).start()
    src.close()
    assert not src._thread.is_alive()
