"""PyTorch port vs the JAX package: the RB1 binary batch protocol.

* ``build_frame``/``pack_rows``/``data_frame`` give the JAX package's bytes
  for every kind; the slot codec round-trips, keeps its bounds and packs
  as the JAX one does.
* On seeded fuzzed byte streams (torn frames, bad magic, bad CRC, version
  and kind skew, raw garbage) the port's walker, native C and Python,
  yields the JAX walker's metas, frames and counters, in one scan and
  incrementally at awkward chunk sizes.
* ``DispatchTable.lookup`` and ``decode_frames_to_row`` equal the JAX ones
  on the registry's slot map and on fuzzed codes.
* ``ShmRing`` round-trips and wraps, refuses a frame that does not fit,
  and works across the packages in both directions.
* The journal's FRAME records round-trip, survive a torn tail, and read
  the same in both packages.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from rtap_tpu.config import scaled_cluster_preset as j_scaled
from rtap_tpu.ingest import dispatch as j_dispatch
from rtap_tpu.ingest import protocol as j_protocol
from rtap_tpu.ingest.shm import ShmRing as JShmRing
from rtap_tpu.resilience.journal import TickJournal as JJournal
from rtap_tpu.service.registry import StreamGroupRegistry as JReg
from rtap_tpu_torch.config import scaled_cluster_preset
from rtap_tpu_torch.ingest import DispatchTable, FrameWalker, ShmRing, build_frame
from rtap_tpu_torch.ingest.dispatch import decode_frames_to_row
from rtap_tpu_torch.ingest.protocol import (
    KIND_DATA,
    KIND_MAP,
    KIND_NAMES,
    MAX_GROUPS,
    MAX_SHARDS,
    MAX_SLOTS,
    data_frame,
    decode_slot,
    encode_slot,
    scan_frames_py,
)
from rtap_tpu_torch.native import frame_walker_scan
from rtap_tpu_torch.resilience.journal import JournaledFrames, TickJournal
from rtap_tpu_torch.service.registry import StreamGroupRegistry

torch.set_num_threads(1)


def _reg(n=6, group_size=4, reserve=0):
    reg = StreamGroupRegistry(scaled_cluster_preset(32), group_size=group_size, device="cpu")
    for i in range(n):
        reg.add_stream(f"s{i}")
    reg.finalize(reserve=reserve)
    return reg


def _jreg(n=6, group_size=4, reserve=0):
    reg = JReg(j_scaled(32), group_size=group_size, backend="cpu")
    for i in range(n):
        reg.add_stream(f"s{i}")
    reg.finalize(reserve=reserve)
    return reg


# ------------------------------------------------------------- codec ----


def test_slot_codec_roundtrip_bounds_and_jax_codes():
    for shard, group, slot in [(0, 0, 0), (3, 77, 1023),
                               (MAX_SHARDS - 1, MAX_GROUPS - 1, MAX_SLOTS - 1)]:
        sh, g, s = decode_slot(encode_slot(shard, group, slot))
        assert (int(sh), int(g), int(s)) == (shard, group, slot)
    for bad in [(-1, 0, 0), (MAX_SHARDS, 0, 0), (0, MAX_GROUPS, 0), (0, 0, MAX_SLOTS)]:
        with pytest.raises(ValueError):
            encode_slot(*bad)
        with pytest.raises(ValueError):
            j_protocol.encode_slot(*bad)
    rng = np.random.default_rng(5)
    addrs = np.stack([rng.integers(0, MAX_SHARDS, 200), rng.integers(0, MAX_GROUPS, 200),
                      rng.integers(0, MAX_SLOTS, 200)], axis=1)
    codes = np.array([encode_slot(*map(int, a)) for a in addrs], np.uint32)
    assert list(codes) == [j_protocol.encode_slot(*map(int, a)) for a in addrs]
    for ours, theirs in zip(decode_slot(codes), j_protocol.decode_slot(codes)):
        assert np.array_equal(ours, theirs)


def _frames_of_every_kind(rng):
    codes = np.array([encode_slot(0, int(rng.integers(0, 4)), int(rng.integers(0, 64)))
                      for _ in range(7)], np.uint32)
    vals = rng.normal(size=7).astype(np.float32)
    vals[2], vals[4] = np.nan, np.inf
    deltas = rng.integers(0, 65536, 7).astype(np.uint16)
    return [
        ("data", lambda m: m.data_frame(codes, vals, 1_700_000_000, deltas=deltas,
                                        tenant="acme", epoch=7)),
        ("data-empty", lambda m: m.build_frame(m.KIND_DATA, b"", base_ts=3)),
        ("names", lambda m: m.build_frame(m.KIND_NAMES, "new.a\nnew.b\nünï".encode(),
                                          tenant="t" * 255)),
        ("map", lambda m: m.build_frame(m.KIND_MAP, b'{"__epoch__":3,"s0":0}', epoch=3)),
        ("map-request", lambda m: m.build_frame(m.KIND_MAP, b"")),
        ("rows", lambda m: m.pack_rows(codes, vals, deltas)),
        ("rows-broadcast", lambda m: m.pack_rows(codes, vals)),
    ]


@pytest.mark.parametrize("case", [name for name, _ in _frames_of_every_kind(
    np.random.default_rng(0))])
def test_frames_and_rows_are_the_jax_bytes(case):
    make = dict(_frames_of_every_kind(np.random.default_rng(0)))[case]
    from rtap_tpu_torch.ingest import protocol as port

    assert make(port) == make(j_protocol)


def test_build_frame_refusals_match_jax():
    for args, kw in (((9, b""), {}), ((KIND_DATA, b"123"), {}),
                     ((KIND_NAMES, b""), {"epoch": 1 << 16}),
                     ((KIND_NAMES, b""), {"tenant": "x" * 256}),
                     ((KIND_DATA, b"0" * 10), {"count": 2})):
        with pytest.raises(ValueError) as ours:
            build_frame(*args, **kw)
        with pytest.raises(ValueError) as theirs:
            j_protocol.build_frame(*args, **kw)
        assert str(ours.value) == str(theirs.value)


def test_frame_roundtrip_all_kinds():
    codes = np.array([encode_slot(0, 0, i) for i in range(3)], np.uint32)
    vals = np.array([1.5, np.nan, -7.0], np.float32)
    frames = [data_frame(codes, vals, 1_700_000_000, deltas=[0, 1, 2], tenant="acme"),
              build_frame(KIND_NAMES, b"new.a\nnew.b"), build_frame(KIND_MAP, b'{"s0": 0}')]
    out = FrameWalker(native=False).feed(b"".join(frames))
    assert [f.kind for f in out] == [KIND_DATA, KIND_NAMES, KIND_MAP]
    assert out[0].tenant == "acme" and out[0].base_ts == 1_700_000_000
    rows = out[0].rows()
    assert np.array_equal(rows["slot"], codes)
    assert np.array_equal(rows["value"], vals, equal_nan=True)
    assert list(rows["dt"]) == [0, 1, 2]
    assert bytes(out[1].payload) == b"new.a\nnew.b"
    assert out[0].raw == frames[0]  # verbatim: the journal's payload


# ------------------------------------------------------------- walker ----


def _reskew(frame: bytes, byte_off: int, value: int) -> bytes:
    b = bytearray(frame[:-4])
    b[byte_off] = value
    return bytes(b) + struct.pack("<I", zlib.crc32(bytes(b[3:])))


def _edge_streams():
    one = data_frame(np.array([encode_slot(0, 0, 0)], np.uint32), [3.0], 1000)
    good = build_frame(KIND_NAMES, b"ok")
    bad_crc = bytearray(one)
    bad_crc[-1] ^= 0xFF
    return {
        "torn": [one[i:i + 3] for i in range(0, len(one), 3)],
        "bad-magic": [b"NOISE" + good + b"RB" + good],
        "bad-crc": [bytes(bad_crc) + good],
        "version-skew": [_reskew(good, 3, 9) + _reskew(good, 4, 200) + good],
        "garbage-tail": [good + b"R" * 50],
    }


def _walk(walker, chunks):
    frames = [f for c in chunks for f in walker.feed(c)]
    return ([(f.kind, f.tenant, f.count, f.base_ts, f.epoch, f.raw, bytes(f.payload))
             for f in frames],
            (walker.frames, walker.garbage_bytes, walker.bad_crc, walker.version_skew))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", list(_edge_streams()))
def test_walker_edges_match_jax(case, native):
    chunks = _edge_streams()[case]
    ours = _walk(FrameWalker(native=native), chunks)
    assert ours == _walk(j_protocol.FrameWalker(native=False), chunks)
    expect = {"torn": (1, 0, 0, 0), "bad-magic": (2, 5 + 2, 0, 0),
              "bad-crc": (1, None, 1, 0), "version-skew": (1, 0, 0, 2),
              "garbage-tail": (1, None, 0, 0)}[case]
    assert all(e is None or e == o for e, o in zip(expect, ours[1])), ours[1]


def _fuzz_stream(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(60):
        r = rng.random()
        n = int(rng.integers(1, 20))
        codes = np.array([encode_slot(0, int(rng.integers(0, 4)), int(rng.integers(0, 64)))
                          for _ in range(n)], np.uint32)
        frame = data_frame(codes, rng.normal(size=n).astype(np.float32),
                           int(rng.integers(1, 2**40)),
                           deltas=rng.integers(0, 65536, n).astype(np.uint16),
                           tenant="t" * int(rng.integers(0, 6)),
                           epoch=int(rng.integers(0, 3)))
        if r < 0.55:
            parts.append(frame)
        elif r < 0.7:  # a flipped byte somewhere (CRC or header damage)
            b = bytearray(frame)
            b[int(rng.integers(0, len(b)))] ^= 0xFF
            parts.append(bytes(b))
        elif r < 0.8:  # version/kind skew with a valid CRC
            parts.append(_reskew(frame, 3 if r < 0.75 else 4, int(rng.integers(5, 250))))
        elif r < 0.9:  # raw garbage (may hold magic-like bytes)
            parts.append(bytes(rng.integers(0, 256, int(rng.integers(1, 80)), dtype=np.uint8)))
        else:  # a frame cut mid-payload
            parts.append(frame[:int(rng.integers(1, len(frame)))])
    return b"".join(parts)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_walker_fuzz_native_and_python_equal_jax(seed):
    blob = _fuzz_stream(seed)
    want = j_protocol.scan_frames_py(blob)
    assert scan_frames_py(blob) == want
    assert frame_walker_scan(blob) == want
    for chunk in (1237, 64, 7):
        ref = _walk(j_protocol.FrameWalker(native=False),
                    [blob[o:o + chunk] for o in range(0, len(blob), chunk)])
        for native in (True, False):
            got = _walk(FrameWalker(native=native),
                        [blob[o:o + chunk] for o in range(0, len(blob), chunk)])
            assert got == ref, (chunk, native)
        assert ref[1][0] > 0 and ref[1][2] > 0 and ref[1][3] > 0


def test_native_walker_loops_past_its_frame_cap():
    frames = [build_frame(KIND_NAMES, b"n%d" % i) for i in range(5000)]
    blob = b"".join(frames)
    metas, consumed, stats = frame_walker_scan(blob)
    assert (metas, consumed, stats) == j_protocol.scan_frames_py(blob)
    assert len(metas) == 5000 and consumed == len(blob)


def test_walker_drops_an_unbounded_remainder():
    w, jw = FrameWalker(native=True), j_protocol.FrameWalker(native=False)
    # a header claiming the largest legal DATA frame, then never finishing
    head = struct.pack("<3sBBBHIq", b"RB1", 1, KIND_DATA, 0, 0, (1 << 22), 0)
    assert w.MAX_BUFFER == jw.MAX_BUFFER
    chunk = head + b"\0" * (1 << 20)
    for _ in range(2):
        w.feed(chunk)
        jw.feed(chunk)
    assert (w.garbage_bytes, len(w._buf)) == (jw.garbage_bytes, len(jw._buf))


# ---------------------------------------------- slot map / dispatch table ----


def test_slot_map_matches_dispatch_order_and_jax():
    reg, jreg = _reg(n=6, group_size=4, reserve=4), _jreg(n=6, group_size=4, reserve=4)
    sm = reg.slot_map()
    assert list(sm) == reg.dispatch_ids()
    assert all(a.shard == 0 for a in sm.values())
    reg.add_stream("late")
    jreg.add_stream("late")
    sm2 = reg.slot_map()
    assert list(sm2) == reg.dispatch_ids() and "late" in sm2
    addr = lambda sm: {k: (a.shard, a.group, a.slot) for k, a in sm.items()}  # noqa: E731
    assert addr(sm2) == addr(jreg.slot_map())
    table, jtable = DispatchTable(sm2), j_dispatch.DispatchTable(jreg.slot_map())
    assert table.ids == jtable.ids == reg.dispatch_ids()
    assert np.array_equal(table.codes, jtable.codes) and table.code_of == jtable.code_of
    assert np.array_equal(table.lookup(table.codes), np.arange(table.n))


def test_dispatch_lookup_rejects_bad_codes():
    table = DispatchTable.from_registry(_reg(n=6, group_size=4))
    bad = np.array([encode_slot(0, 2, 0),    # group beyond the fleet
                    encode_slot(0, 0, 100),  # slot beyond the groups' extent
                    encode_slot(1, 0, 2),    # wrong shard for a live (g, s)
                    table.codes[2]], np.uint32)
    assert list(table.lookup(bad)) == [-1, -1, -1, 2]
    # pads are not addressable: group 1 holds 2 live + 2 pad slots
    assert table.lookup(np.array([encode_slot(0, 1, 3)], np.uint32))[0] == -1


@pytest.mark.parametrize("seed", [1, 2])
def test_dispatch_lookup_equals_jax_on_fuzzed_codes(seed):
    rng = np.random.default_rng(seed)
    sm = dict(_reg(n=37, group_size=8, reserve=8).slot_map())
    for sid in rng.choice(sorted(sm), 4, replace=False):
        del sm[sid]  # released slots
    ours, theirs = DispatchTable(sm), j_dispatch.DispatchTable(sm)
    codes = np.concatenate([
        ours.codes, rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32),
        ours.codes | np.uint32(1 << 24),  # shard 1
        rng.integers(0, 8 << 12, 500).astype(np.uint32)])
    rng.shuffle(codes)
    assert np.array_equal(ours.lookup(codes), theirs.lookup(codes))
    assert np.array_equal(DispatchTable({}).lookup(codes[:9]),
                          j_dispatch.DispatchTable({}).lookup(codes[:9]))


@pytest.mark.parametrize("seed", [3, 4])
def test_decode_frames_to_row_equals_jax(seed):
    rng = np.random.default_rng(seed)
    sm = _reg(n=10, group_size=4, reserve=2).slot_map()
    table, jtable = DispatchTable(sm), j_dispatch.DispatchTable(sm)
    blobs = []
    for _ in range(6):
        n = int(rng.integers(1, 30))
        codes = np.concatenate([table.codes, np.array([encode_slot(0, 7, 1)], np.uint32)])
        codes = codes[rng.integers(0, len(codes), n)]
        vals = rng.normal(size=n).astype(np.float32)
        vals[rng.random(n) < 0.1] = np.inf
        blobs.append(data_frame(codes, vals, 5000 + int(rng.integers(0, 10))))
    blobs.insert(2, build_frame(KIND_NAMES, b"x\ny"))
    row = decode_frames_to_row(blobs, table.n, table)
    assert np.array_equal(row, j_dispatch.decode_frames_to_row(blobs, jtable.n, jtable),
                          equal_nan=True)
    with pytest.raises(ValueError, match="width"):
        decode_frames_to_row(blobs, table.n + 1, table)


# --------------------------------------------------------------- shm ----


def test_shm_ring_roundtrip_and_wraparound():
    name = f"rtap_tt_ring_{os.getpid()}"
    ring = ShmRing.create(name, 4096)
    try:
        w = ShmRing.attach(name)
        frame = build_frame(KIND_NAMES, b"n" * 100)
        walker = FrameWalker(native=True)
        got = 0
        for k in range(200):  # ~25 KiB through a 4 KiB ring: many wraps
            assert w.push(frame)
            if k % 3 == 0:
                got += len(walker.feed(ring.drain()))
        got += len(walker.feed(ring.drain()))
        assert got == 200 and walker.bad_crc == 0 and walker.garbage_bytes == 0
        assert ring.unread_bytes == 0
        # a frame that cannot fit is refused, counted, never torn
        assert not w.push(build_frame(KIND_NAMES, b"x" * 5000))
        assert w.push_rejected == 1
        w.close()
    finally:
        ring.close()


def test_shm_attach_rejects_non_ring_and_small_capacity():
    from multiprocessing import shared_memory

    name = f"rtap_tt_bad_{os.getpid()}"
    raw = shared_memory.SharedMemory(name=name, create=True, size=1024)
    try:
        with pytest.raises(ValueError, match="bad magic"):
            ShmRing.attach(name)
    finally:
        raw.close()
        raw.unlink()
    with pytest.raises(ValueError):
        ShmRing.create(f"rtap_tt_small_{os.getpid()}", 100)


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_shm_ring_works_across_the_packages(creator):
    """A JAX producer attaches to a port ring and a port producer to a JAX
    ring: the same header, magic and cursors."""
    name = f"rtap_tt_x_{creator}_{os.getpid()}"
    make, attach = (ShmRing, JShmRing) if creator == "port" else (JShmRing, ShmRing)
    ring = make.create(name, 8192)
    try:
        w = attach.attach(name)
        frames = [data_frame(np.array([encode_slot(0, 0, i)], np.uint32), [float(i)], 100 + i)
                  for i in range(300)]
        out = b""
        for i, fr in enumerate(frames):
            assert w.push(fr)
            if i % 7 == 0:
                out += ring.drain()
        out += ring.drain()
        assert out == b"".join(frames)
        assert w.unread_bytes == ring.unread_bytes == 0
        w.close()
    finally:
        ring.close()


# ---------------------------------------------- journal FRAME records ----


def test_journal_frame_records_roundtrip_torn_tail_and_jax_reads_them(tmp_path):
    table = DispatchTable.from_registry(_reg(n=4, group_size=4))
    c = table.codes
    j = TickJournal(tmp_path / "j")
    frames0 = [data_frame(c, [1, 2, 3, 4], 9000), data_frame(c[:1], [np.inf], 9000)]
    j.append_tick_frames(0, 9000, 4, frames0)
    j.append_tick_frames(1, 9001, 4, [])  # no-data tick: legal, all-NaN
    j.append_tick(2, 9002, np.array([5, 6, 7, 8], np.float32))  # mixed log
    assert j.next_tick == 3 and j.appended_ticks == 3
    j.close()

    for journal_cls in (TickJournal, JJournal):
        j2 = journal_cls(tmp_path / "j")
        assert [r[0] for r in j2.recovered_ticks] == [0, 1, 2]
        t0, t1 = j2.recovered_ticks[0][2], j2.recovered_ticks[1][2]
        assert type(t0).__name__ == "JournaledFrames" and t0.width == 4
        assert t0.blob == b"".join(frames0)
        assert np.array_equal(decode_frames_to_row([t0.blob], 4, table),
                              np.array([np.inf, 2, 3, 4], np.float32))
        assert np.isnan(decode_frames_to_row([t1.blob], 4, table)).all()
        j2.close()

    # the JAX journal's FRAME records read back in the port as its own
    jj = JJournal(tmp_path / "jj")
    jj.append_tick_frames(0, 7000, 4, frames0)
    jj.close()
    pj = TickJournal(tmp_path / "jj")
    rec = pj.recovered_ticks[0]
    assert rec[:2] == (0, 7000) and isinstance(rec[2], JournaledFrames)
    assert rec[2].blob == b"".join(frames0)
    pj.close()

    # a torn tail on a FRAME record truncates back to the last valid one
    seg = sorted((tmp_path / "j").glob("seg-*.rjl"))[-1]
    data = seg.read_bytes()
    seg.write_bytes(data[:-7])
    j3 = TickJournal(tmp_path / "j")
    assert j3.truncations == 1
    assert [r[0] for r in j3.recovered_ticks] == [0, 1]
    j3.close()


def test_journal_frame_records_are_the_jax_bytes(tmp_path):
    table = DispatchTable.from_registry(_reg(n=4, group_size=4))
    frames = [data_frame(table.codes, [1, 2, 3, 4], 9000)]
    for cls, d in ((TickJournal, "p"), (JJournal, "j")):
        j = cls(tmp_path / d)
        j.append_tick_frames(0, 9000, 4, frames)
        j.append_tick_frames(1, 9001, 4, [])
        j.close()
    seg = lambda d: sorted((tmp_path / d).glob("seg-*.rjl"))  # noqa: E731
    assert [s.read_bytes() for s in seg("p")] == [s.read_bytes() for s in seg("j")]


def test_walker_falls_back_when_the_library_cannot_build(monkeypatch):
    """A host without a C compiler: the port's walker falls back to Python
    at construction (native=None) and refuses native=True, where the JAX
    walker reports native and its first feed raises (ROADMAP.md section C)."""
    import rtap_tpu.native as j_native
    import rtap_tpu_torch.native as native

    def no_compiler():
        raise FileNotFoundError("[Errno 2] No such file or directory: 'cc'")

    monkeypatch.setattr(native, "load_frame_walker", no_compiler)
    monkeypatch.setattr(native, "_fw_lib", None)
    w = FrameWalker()
    assert w.native_active is False
    frame = build_frame(KIND_NAMES, b"x")
    assert [f.kind for f in w.feed(frame)] == [KIND_NAMES]
    with pytest.raises(RuntimeError, match="unavailable"):
        FrameWalker(native=True)
    # the reference, the same way: native claimed, the first feed raises
    monkeypatch.setattr(j_native, "load_frame_walker", no_compiler)
    jw = j_protocol.FrameWalker()
    assert jw.native_active is True
    with pytest.raises(FileNotFoundError):
        jw.feed(frame)
