"""PyTorch port vs the JAX package: the write-ahead tick journal.

* The same appends through both TickJournals give identical segment bytes,
  with segment rotation, the max_segments bound and compaction.
* Each package recovers the other's journal, a torn tail cut mid-record
  included, with equal recovered rows and recovery counts.
* parse_fsync parity, and the JAX package's FRAME records recovered by the
  port.
"""

import os

import numpy as np
import pytest
import torch

from rtap_tpu.resilience import journal as jj
from rtap_tpu_torch.resilience import journal as tj

torch.set_num_threads(1)

PKGS = {"jax": jj, "torch": tj}


def _segments(path):
    return {p: open(os.path.join(path, p), "rb").read()
            for p in sorted(os.listdir(path)) if p.endswith(".rjl")}


def _write(mod, path, n_ticks, seed=0, segment_bytes=1024, max_segments=256,
           compact_at=None, fsync="os", fsync_every=64, ndim=1):
    rng = np.random.default_rng(seed)
    j = mod.TickJournal(path, segment_bytes=segment_bytes, max_segments=max_segments,
                        fsync=fsync, fsync_every=fsync_every)
    for t in range(n_ticks):
        shape = (7,) if ndim == 1 else (5, 3)
        vals = rng.normal(30, 5, shape).astype(np.float32)
        vals[rng.random(shape) < 0.2] = np.nan
        j.append_tick(t, 1_700_000_000 + t, vals)
        j.append_cursor(t, 100 * t)
        if compact_at is not None and t == compact_at:
            j.compact(t - 4)
    stats = j.stats()
    j.close()
    return stats


@pytest.mark.parametrize("case", [
    dict(n_ticks=60),
    dict(n_ticks=60, compact_at=40),
    dict(n_ticks=80, max_segments=3),
    dict(n_ticks=12, segment_bytes=4 << 20, fsync="every-n", fsync_every=5, ndim=2),
], ids=["rotate", "rotate-compact", "max-segments", "fields-every-n"])
def test_same_appends_give_identical_segments(tmp_path, case):
    stats = {name: _write(mod, tmp_path / name, **case) for name, mod in PKGS.items()}
    a, b = _segments(tmp_path / "jax"), _segments(tmp_path / "torch")
    assert a.keys() == b.keys() and len(a) > 0
    for name in a:
        assert a[name] == b[name], name
    assert stats["jax"] == stats["torch"]


def _recovered(mod, path):
    j = mod.TickJournal(path, segment_bytes=1024)
    out = (
        [(t, ts, v.tobytes()) for t, ts, v in j.recovered_ticks],
        list(j.cursors), j.truncations, j.truncated_bytes, j.dropped_segments,
        j.next_tick,
    )
    j.close()
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("cut", [5, 17, 40], ids=["header", "payload", "late-payload"])
def test_each_package_recovers_the_others_torn_journal(tmp_path, writer, cut):
    """A torn tail (the last segment cut `cut` bytes into its last tick
    record) is truncated back to the last valid record the same way by
    both."""
    src = tmp_path / "src"
    _write(PKGS[writer], src, 30)
    segs = sorted(p for p in os.listdir(src) if p.endswith(".rjl"))
    last = src / segs[-1]
    data = last.read_bytes()
    # the last tick record's start: walk the framing
    off = 0
    starts = []
    while off < len(data):
        if data[off + 2] == 1:
            starts.append(off)
        ln = int.from_bytes(data[off + 3:off + 7], "little")
        off += 7 + ln + 4
    torn = data[:starts[-1] + cut]
    results = {}
    for name, mod in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        for s in segs[:-1]:
            (d / s).write_bytes((src / s).read_bytes())
        (d / segs[-1]).write_bytes(torn)
        results[name] = _recovered(mod, d)
        # recovery truncated the file back to the valid prefix
        assert (d / segs[-1]).read_bytes() == data[:starts[-1]]
    assert results["jax"] == results["torch"]
    assert results["torch"][2] == 1 and results["torch"][3] == cut


def test_mid_log_corruption_drops_later_segments_the_same_way(tmp_path):
    _write(tj, tmp_path / "src", 40)
    segs = sorted(p for p in os.listdir(tmp_path / "src") if p.endswith(".rjl"))
    assert len(segs) >= 3
    results = {}
    for name, mod in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        for i, s in enumerate(segs):
            b = bytearray((tmp_path / "src" / s).read_bytes())
            if i == 1:
                b[30] ^= 0xFF  # bitrot inside the second segment's first record
            (d / s).write_bytes(bytes(b))
        results[name] = _recovered(mod, d)
    assert results["jax"] == results["torch"]
    assert results["torch"][4] == len(segs) - 2  # segments after the corruption


@pytest.mark.parametrize("spec", ["os", "every-tick", "EVERY-7", " every-1 ", "every-0",
                                  "every-x", "never", "every-"])
def test_parse_fsync_parity(spec):
    def call(mod):
        try:
            return mod.parse_fsync(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert call(jj) == call(tj)


def test_port_recovers_jax_frame_records(tmp_path):
    """The JAX package's binary ingest journals FRAME records; the port
    parses them (the format is shared) and counts them like tick rows."""
    j = jj.TickJournal(tmp_path)
    j.append_tick(0, 1_700_000_000, np.arange(3, dtype=np.float32))
    j.append_tick_frames(1, 1_700_000_001, 3, [b"abc", b"defg"])
    j.close()
    t = tj.TickJournal(tmp_path)
    (t0, _, v0), (t1, ts1, fr) = t.recovered_ticks
    assert (t0, t1, ts1) == (0, 1, 1_700_000_001)
    np.testing.assert_array_equal(v0, np.arange(3, dtype=np.float32))
    assert isinstance(fr, tj.JournaledFrames) and fr.width == 3 and fr.blob == b"abcdefg"
    assert tj.last_journal_tick(tmp_path) == jj.last_journal_tick(tmp_path) == 1
    t.close()


def test_wipe_and_resume_numbering(tmp_path):
    j = tj.TickJournal(tmp_path, segment_bytes=1024)
    for t in range(20):
        j.append_tick(t, t, np.zeros(4, np.float32))
    j.close()
    j = tj.TickJournal(tmp_path, segment_bytes=1024)
    assert j.next_tick == 20 and j.recovered_count == 20
    j.wipe()
    assert j.next_tick == 0 and not list(tmp_path.glob("seg-*.rjl"))
    assert tj.last_journal_tick(tmp_path) == -1
    j.append_tick(0, 0, np.zeros(4, np.float32))
    j.close()
    assert tj.last_journal_tick(tmp_path) == 0
