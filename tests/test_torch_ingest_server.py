"""PyTorch port vs the JAX package: ``BinaryBatchSource``.

The port's source and the JAX one fed the same seeded frame sequences with
``feed_frames`` give the same values, ts and ``take_tick_frames`` bytes on
every tick and the same counters — at backfill horizon 0 and > 0, under a
quota, under drop-oldest backpressure, with stale epochs, garbage and a
membership change mid-run. Also: ``inf`` surviving the backfill merge and
the synthesized journal frame; the MAP push on a membership change; the
hello-MAP ordering (the port registers a connection before its hello, so
an ``announce_leader`` right after the hello reaches the producer: the JAX
listener loses it), and a producer adopting every MAP of a recv chunk; NAMES frames feeding ``drain_unknown``; the arrival-lag
pair as one tuple; the shm ring drain; ``close()`` joining its threads.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from rtap_tpu.ingest import BinaryBatchSource as JBinaryBatchSource
from rtap_tpu.ingest.dispatch import DispatchTable as JDispatchTable
from rtap_tpu.ingest.dispatch import decode_frames_to_row as j_decode
from rtap_tpu_torch.config import scaled_cluster_preset
from rtap_tpu_torch.ingest import (
    BinaryBatchSource,
    BinaryFeedConnection,
    DispatchTable,
    ShmRing,
    build_frame,
    send_binary,
)
from rtap_tpu_torch.ingest.dispatch import decode_frames_to_row
from rtap_tpu_torch.ingest.protocol import KIND_NAMES, data_frame, encode_slot
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)

COUNTERS = ("rows_applied", "frames_applied", "rows_unknown", "rows_stale_epoch",
            "rows_quota_dropped", "rows_late_dropped", "rows_backfilled",
            "rows_backpressure_dropped", "garbage_bytes", "parse_errors", "records_parsed",
            "unknown_ids", "native_active")


def _reg(n=10, group_size=4, reserve=6):
    reg = StreamGroupRegistry(scaled_cluster_preset(32), group_size=group_size, device="cpu")
    for i in range(n):
        reg.add_stream(f"s{i}")
    reg.finalize(reserve=reserve)
    return reg


def _wait(cond, timeout=10.0):
    """True as soon as cond() is (each call may consume what it saw)."""
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            return False
        time.sleep(0.005)
    return True


def _tick_frames(rng, codes, epoch, t, n_frames):
    """One tick's seeded frames: known and unknown codes, late and future
    timestamps, three tenants, current, unaware (0) and stale epochs, inf
    and NaN values, a NAMES frame and garbage now and then."""
    out = []
    for _ in range(n_frames):
        n = int(rng.integers(1, 12))
        cs = codes[rng.integers(0, len(codes), n)]
        cs[rng.random(n) < 0.1] = encode_slot(0, 9, 9)  # no live stream there
        vals = rng.normal(30, 5, n).astype(np.float32)
        vals[rng.random(n) < 0.05] = np.inf
        vals[rng.random(n) < 0.05] = np.nan
        ep = rng.choice([epoch, epoch, epoch, 0] + ([epoch - 1] if epoch > 1 else []))
        out.append(data_frame(cs, vals, 10_000 + t + int(rng.integers(-3, 2)),
                              deltas=rng.integers(0, 3, n).astype(np.uint16),
                              tenant=str(rng.choice(["a", "b", ""])), epoch=int(ep)))
    if rng.random() < 0.2:
        out.append(build_frame(KIND_NAMES, b"new.1\nnew.2"))
    if rng.random() < 0.2:
        out.append(b"garbage" * int(rng.integers(1, 4)))
    return out


def _scenario(seed, ticks=14, change_at=6, **kw):
    """Run the port's and the JAX source over one seeded frame sequence,
    with a membership change at `change_at` -> per-tick records of both."""
    rng = np.random.default_rng(seed)
    reg = _reg()
    srcs = [BinaryBatchSource(reg.slot_map(), port=None, track_unknown=True, **kw),
            JBinaryBatchSource(reg.slot_map(), port=None, track_unknown=True, **kw)]
    recs = [[], []]
    epoch = 1
    for t in range(ticks):
        if t == change_at:
            reg.add_stream("late.x")
            for src in srcs:
                src.set_slot_map(reg.slot_map())
            epoch += 1
        frames = _tick_frames(rng, DispatchTable(reg.slot_map()).codes, epoch, t,
                              int(rng.integers(0, 5)))
        for src, rec in zip(srcs, recs):
            for i in range(0, len(frames), 2):  # two feed calls per tick
                src.feed_frames(frames[i:i + 2])
            values, ts = src(t)
            rec.append((values, ts if ts < 1_000_000_000 else "wall",
                        b"".join(src.take_tick_frames()), src.drain_unknown(),
                        {c: getattr(src, c) for c in COUNTERS}, src._map_epoch))
    return recs, reg


def _assert_same(recs):
    for t, (a, b) in enumerate(zip(*recs)):
        assert np.array_equal(a[0], b[0], equal_nan=True), t
        assert a[1:] == b[1:], (t, a[1:], b[1:])


@pytest.mark.parametrize("kw", [
    {}, {"quota_rows": 9}, {"backfill_horizon": 2}, {"backfill_horizon": 1, "quota_rows": 7},
    {"backfill_horizon": 3, "max_pending_buckets": 2}, {"native": False}],
    ids=["latest-wins", "quota", "backfill", "backfill-quota", "backpressure", "python-walker"])
@pytest.mark.parametrize("seed", [1, 2])
def test_ticks_equal_jax_over_a_seeded_frame_sequence(seed, kw):
    recs, reg = _scenario(seed, **kw)
    _assert_same(recs)
    ours = recs[0]
    assert ours[-1][4]["rows_applied"] > 0 and ours[-1][5] == 2
    if "quota_rows" in kw:
        assert ours[-1][4]["rows_quota_dropped"] > 0
    if "max_pending_buckets" in kw:
        assert ours[-1][4]["rows_backpressure_dropped"] > 0
    if kw.get("backfill_horizon"):
        assert ours[-1][4]["rows_backfilled"] > 0
    # the journal frames of every tick replay into its emitted vector
    table = DispatchTable(reg.slot_map())
    for values, _ts, blob, *_ in ours[6:]:
        assert np.array_equal(decode_frames_to_row([blob], table.n, table), values,
                              equal_nan=True)


def test_stale_epoch_frames_refused_whole():
    reg = _reg(n=4, group_size=4, reserve=4)
    src = BinaryBatchSource(reg.slot_map(), port=None)
    codes = src._table.codes
    old = src._map_epoch
    src.feed_frames([data_frame(codes[:1], [1.0], 100, epoch=old)])
    assert src.records_parsed == 1
    reg.add_stream("newcomer")
    src.set_slot_map(reg.slot_map())
    assert src._map_epoch == old + 1
    src.feed_frames([data_frame(codes[:1], [2.0], 101, epoch=old)])
    assert src.records_parsed == 1 and src.rows_stale_epoch == 1
    src.feed_frames([data_frame(codes[:1], [3.0], 102)])  # epoch 0: admitted
    src.feed_frames([data_frame(codes[:1], [4.0], 103, epoch=src._map_epoch)])
    assert src.records_parsed == 3


def test_inf_values_survive_backfill_and_synth_replay():
    reg = _reg(n=4, group_size=4, reserve=0)
    for cls, dtable, decode in ((BinaryBatchSource, DispatchTable, decode_frames_to_row),
                                (JBinaryBatchSource, JDispatchTable, j_decode)):
        src = cls(reg.slot_map(), port=None, quota_rows=3)
        codes = src._table.codes
        src.feed_frames([data_frame(codes, [np.inf, -np.inf, 3.0, 4.0], 2000, tenant="a")])
        v, _ = src(0)  # quota-truncated -> impure -> synthesized journal frame
        assert v[0] == np.inf and v[1] == -np.inf and np.isnan(v[3])
        row = decode(src.take_tick_frames(), 4, dtable(reg.slot_map()))
        assert np.array_equal(row, v, equal_nan=True)
        srcb = cls(reg.slot_map(), port=None, backfill_horizon=1)
        srcb.feed_frames([data_frame(codes[:1], [np.inf], 3000),
                          data_frame(codes[1:2], [1.0], 3002)])
        v, _ = srcb(0)
        assert v[0] == np.inf  # through the bucket merge


def test_tick_zero_and_empty_ticks_journal_nothing():
    """Tick 0 polls before anything arrived: an all-NaN vector on the wall
    clock and no frames to journal, as in the JAX package."""
    reg = _reg(n=4, group_size=4, reserve=0)
    for cls in (BinaryBatchSource, JBinaryBatchSource):
        src = cls(reg.slot_map(), port=None)
        v, ts = src(0)
        assert np.isnan(v).all() and abs(ts - time.time()) < 5
        assert src.take_tick_frames() == []
        src.feed_frames([data_frame(src._table.codes[:2], [1.0, 2.0], 5000)])
        v, ts = src(1)
        assert ts == 5000 and len(src.take_tick_frames()) == 1
        assert src.take_tick_frames() == []  # taken once


def test_map_push_on_membership_change_and_poll():
    reg = _reg(n=4, group_size=4, reserve=4)
    src = BinaryBatchSource(reg.slot_map()).start()
    try:
        with BinaryFeedConnection(src.address) as conn:
            e0 = conn.epoch
            assert conn.poll_map() is False  # nothing pushed yet
            reg.add_stream("pushed.late")
            src.set_slot_map(reg.slot_map())
            assert _wait(conn.poll_map)
            assert conn.epoch == e0 + 1 and "pushed.late" in conn.code_of
            assert conn.code_of == src._table.code_of
    finally:
        src.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_announce_right_after_the_hello_reaches_the_producer_only_in_the_port(pkg):
    """The hello-MAP order, deterministically: an announce_leader landing
    just after a new connection's hello was sent. The port registered the
    socket before the hello, so the push reaches it; the JAX listener
    registers after, so at that moment it has no socket to push to and the
    producer stays on the old MAP (the race behind the JAX package's
    flaky test_announce_leader_repoints_producers)."""
    reg = _reg(n=4, group_size=4, reserve=0)
    src = (BinaryBatchSource if pkg == "port" else JBinaryBatchSource)(reg.slot_map())
    real = src._send_map
    registered_at_announce = []

    def hello_then_announce(sock):
        real(sock)
        if not registered_at_announce:
            with src._lock:
                registered_at_announce.append(len(src._conns))
            src.announce_leader("127.0.0.1:12345")

    src._send_map = hello_then_announce
    src.start()
    try:
        with BinaryFeedConnection(src.address) as conn:
            assert _wait(lambda: bool(registered_at_announce))
            if pkg == "port":
                assert registered_at_announce == [1]
                # the push may share the hello's recv (adopted by the
                # constructor) or come after it (adopted by poll_map)
                assert _wait(lambda: (conn.poll_map(), conn.epoch)[1] == 2)
                assert conn.leader_hint == "127.0.0.1:12345"
            else:
                assert registered_at_announce == [0]  # the push had no recipient
                assert conn.leader_hint is None and conn.epoch == 1
    finally:
        src.close()


def test_announce_leader_repoints_connected_producers():
    reg = _reg(n=4, group_size=4, reserve=0)
    src = BinaryBatchSource(reg.slot_map()).start()
    try:
        with BinaryFeedConnection(src.address) as conn:
            assert conn.leader_hint is None
            e0 = conn.epoch
            # the hello is sent after registration: the socket is known
            assert _wait(lambda: len(src._conns) == 1)
            src.announce_leader("127.0.0.1:12345")
            assert _wait(conn.poll_map)
            assert conn.leader_hint == "127.0.0.1:12345" and conn.epoch == e0 + 1
    finally:
        src.close()


def test_names_frames_feed_drain_unknown_like_jax():
    reg = _reg(n=4, group_size=4, reserve=0)
    out = []
    for cls in (BinaryBatchSource, JBinaryBatchSource):
        src = cls(reg.slot_map(), port=None, track_unknown=True)
        src.feed_frames([build_frame(KIND_NAMES, "b.2\na.1\n\nü.3\nb.2".encode()),
                         build_frame(KIND_NAMES, b"\xff\xfebad\nc.4")])
        out.append((src.drain_unknown(), src.drain_unknown(), src.frames_applied))
        quiet = cls(reg.slot_map(), port=None)
        quiet.feed_frames([build_frame(KIND_NAMES, b"x")])
        assert quiet.drain_unknown() == []
    assert out[0] == out[1]
    assert out[0][0][:3] == ["a.1", "b.2", "bad"] and out[0][1] == []


def test_send_binary_names_unknown_ids_and_counts_the_known():
    reg = _reg(n=4, group_size=4, reserve=0)
    ids = list(reg.slot_map())
    src = BinaryBatchSource(reg.slot_map(), track_unknown=True).start()
    try:
        recs = [{"id": sid, "value": float(i), "ts": 7000 + i} for i, sid in enumerate(ids)]
        recs.append({"id": "ghost", "value": 1.0, "ts": 7000})
        assert send_binary(src.address, recs) == len(ids)
        assert _wait(lambda: src.records_parsed == len(ids) and src.frames_applied >= 2)
        v, ts = src(0)
        assert list(v) == [float(i) for i in range(len(ids))] and ts == 7000 + len(ids) - 1
        assert src.drain_unknown() == ["ghost"]
    finally:
        src.close()


def test_arrival_lag_pair_is_one_atomic_tuple():
    reg = _reg(n=4, group_size=4, reserve=0)
    src = BinaryBatchSource(reg.slot_map(), port=None)
    codes = src._table.codes
    assert src.last_arrival_lag_s is None and src.last_release_hold_s is None
    now = int(time.time())
    src.feed_frames([data_frame(codes[:1], [1.0], now - 3)])
    assert isinstance(src._arrival, tuple) and src._arrival[1] == now - 3
    assert 2.0 <= src.last_arrival_lag_s < 60.0
    src.feed_frames([data_frame(codes[:1], [2.0], now + 3600)])
    assert src.last_arrival_lag_s == 0.0  # a future stamp clamps at 0
    stop = threading.Event()

    def feed(offset):
        while not stop.is_set():
            src.feed_frames([data_frame(codes[:1], [1.0], int(time.time()) + offset)])

    threads = [threading.Thread(target=feed, args=(off,)) for off in (-600, 3600)]
    for t in threads:
        t.start()
    bad = []
    try:
        for _ in range(500):
            lag = src.last_arrival_lag_s
            if not (lag == 0.0 or 590.0 <= lag <= 610.0):
                bad.append(lag)
                break
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
    assert not bad, f"a torn arrival pair gave an impossible lag: {bad}"
    hold = BinaryBatchSource(reg.slot_map(), port=None, backfill_horizon=2)
    hold.feed_frames([data_frame(codes[:1], [1.0], 100), data_frame(codes[1:2], [1.0], 103)])
    hold(0)
    assert hold.last_release_hold_s == 3.0


def test_shm_ring_source_drains_each_tick():
    reg = _reg(n=4, group_size=4, reserve=0)
    name = f"rtap_tt_src_{os.getpid()}"
    src = BinaryBatchSource(reg.slot_map(), port=None, shm=name, shm_bytes=8192)
    try:
        assert src.ring_name == name and src.address is None
        w = ShmRing.attach(name)
        codes = src._table.codes
        for t in range(30):
            assert w.push(data_frame(codes, np.arange(4, dtype=np.float32) + t, 100 + t))
            v, ts = src(t)
            assert list(v) == [t, t + 1, t + 2, t + 3] and ts == 100 + t
        assert src.garbage_bytes == 0 and src.parse_errors == 0 and src.records_parsed == 120
        w.close()
    finally:
        src.close()


def test_close_joins_every_thread():
    for _ in range(2):
        before = {t for t in threading.enumerate() if t.is_alive()}
        src = BinaryBatchSource(_reg(n=4, group_size=4, reserve=0).slot_map()).start()
        conns = [socket.create_connection(src.address, timeout=5.0) for _ in range(3)]
        for c in conns:
            assert c.recv(1 << 16)  # the MAP hello: the handler is up
        src.close()
        assert _wait(lambda: not [t for t in threading.enumerate()
                                  if t.is_alive() and t not in before], timeout=5.0)
        for c in conns:
            c.close()


def test_constructor_refusals_match_jax():
    sm = _reg(n=4, group_size=4, reserve=0).slot_map()
    for kw in ({"quota_rows": -1}, {"backfill_horizon": -1}):
        with pytest.raises(ValueError) as ours:
            BinaryBatchSource(sm, port=None, **kw)
        with pytest.raises(ValueError) as theirs:
            JBinaryBatchSource(sm, port=None, **kw)
        assert str(ours.value) == str(theirs.value)


def test_producer_adopts_every_map_of_a_chunk():
    """A MAP pushed right behind the hello can share its recv: the port's
    producer ends on the later map, where the JAX one keeps the first."""
    from rtap_tpu.ingest.emit import BinaryFeedConnection as JBinaryFeedConnection
    from rtap_tpu_torch.ingest.protocol import KIND_MAP

    listener = socket.create_server(("127.0.0.1", 0))
    hello = build_frame(KIND_MAP, b'{"__epoch__":1,"a":0}')
    push = build_frame(KIND_MAP, b'{"__epoch__":2,"__leader__":"h:1","a":0}')

    def serve_one():
        conn, _ = listener.accept()
        conn.sendall(hello + push)  # one write: one recv on the producer side
        time.sleep(0.5)
        conn.close()

    try:
        for cls, want in ((BinaryFeedConnection, (2, "h:1")), (JBinaryFeedConnection, (1, None))):
            t = threading.Thread(target=serve_one)
            t.start()
            with cls(listener.getsockname(), timeout_s=5.0) as conn:
                assert (conn.epoch, conn.leader_hint) == want
            t.join(timeout=10)
    finally:
        listener.close()
