"""PyTorch port vs the JAX package: the alert sink.

* format_alert_line gives the same bytes over seeded inputs (scalar and
  multivariate values, with and without an alert id).
* AlertWriter with resume suppression, flush cadence, events and a torn
  tail healed on reopen writes byte-identical files with equal counters
  and sink offsets.
* The tolerant line iterator and the suppression scan agree.
"""

import io

import numpy as np
import pytest
import torch

from rtap_tpu.service import alerts as ja
from rtap_tpu_torch.service import alerts as ta

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(4))
def test_format_alert_line_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    for i in range(200):
        scalar = rng.random() < 0.5
        value = np.float32(rng.normal(0, 1e3)) if scalar else \
            rng.normal(0, 50, rng.integers(1, 4)).astype(np.float32)
        if rng.random() < 0.1:
            value = np.float32(np.nan) if scalar else value * np.nan
        aid = None if rng.random() < 0.2 else f"{i % 3}:n{i}.cpu:{rng.integers(0, 10**6)}"
        args = (aid, f"n{i}.cpu", int(rng.integers(0, 2**31)), value,
                float(np.float32(rng.random())), float(rng.random() * 0.1))
        assert ta.format_alert_line(*args) == ja.format_alert_line(*args)


def _drive(mod, path, flush_every):
    rng = np.random.default_rng(7)
    ids = [f"s{i}" for i in range(6)]
    w = mod.AlertWriter(str(path), flush_every=flush_every)
    w.arm_suppression({"0:s1:3", "1:s4:5", "0:s0:999"})
    offsets = []
    for t in range(12):
        for g in range(2):
            alerts = rng.random(6) < 0.4
            vals = rng.normal(30, 4, 6).astype(np.float32)
            raw = rng.random(6).astype(np.float32)
            ll = rng.random(6) * 0.2
            w.emit_batch(ids, np.full(6, 1_700_000_000 + t), vals, raw, ll, alerts,
                         group=g, tick=t)
        if t % 4 == 0:
            w.emit_event({"tick": t, "event": "missed_tick", "elapsed_s": 1.5})
        w.flush_sink()
        offsets.append(w.sink_offset())
    w.emit_batch(ids, np.zeros(6), np.zeros(6, np.float32), np.zeros(6), np.zeros(6),
                 np.ones(6, bool))  # no group/tick: no alert ids
    out = (w.count, w.suppressed, w.dropped, offsets, w.torn_heals)
    w.close()
    return out


@pytest.mark.parametrize("flush_every", [1, 3])
def test_alert_writer_files_equal(tmp_path, flush_every):
    res = {}
    for name, mod in (("jax", ja), ("torch", ta)):
        path = tmp_path / f"{name}.jsonl"
        path.write_text('{"alert_id": "0:s2:0", "stream": "s2"}\n{"torn": ')  # torn tail
        res[name] = _drive(mod, path, flush_every)
    assert (tmp_path / "jax.jsonl").read_bytes() == (tmp_path / "torch.jsonl").read_bytes()
    assert res["jax"] == res["torch"]
    assert res["torch"][1] == 2 and res["torch"][4] == 1  # two ids suppressed, one heal


def test_scan_and_iterator_parity(tmp_path):
    path = tmp_path / "a.jsonl"
    path.write_text(
        '{"alert_id": "0:a:1", "stream": "a"}\n'
        '{"event": "missed_tick", "tick": 1}\n'
        '[1, 2]\n'
        '\n'
        '{"stream": "b"}\n'
        '{"alert_id": "1:b:2", "str')
    for off in (0, 10, 40):
        assert list(ta.iter_alert_records(str(path), off)) == \
            list(ja.iter_alert_records(str(path), off))
        assert ta.scan_alert_ids(str(path), off) == ja.scan_alert_ids(str(path), off)
    assert ta.scan_alert_ids(str(path)) == {"0:a:1"}
    assert list(ta.iter_alert_records(str(tmp_path / "absent"))) == []
    for content in ("", "x\n", "x"):
        for name, mod in (("j", ja), ("t", ta)):
            (tmp_path / name).write_text(content)
        assert ta.heal_torn_tail(str(tmp_path / "t")) == ja.heal_torn_tail(str(tmp_path / "j"))
        assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()


def test_sink_failures_quarantine_and_restore(tmp_path):
    """A failing sink never raises into scoring: retry once, count drops,
    open the breaker after three failed batches, restore on a probe."""
    from rtap_tpu_torch.resilience.policies import CircuitBreaker

    clock = [0.0]
    w = ta.AlertWriter(str(tmp_path / "a.jsonl"),
                       breaker=CircuitBreaker(3, 5.0, clock=lambda: clock[0], name="t"))
    real = w._fh

    class Full:
        def writelines(self, lines):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

    w._fh = Full()
    one = dict(stream_ids=["a"], ts=np.zeros(1), values=np.ones(1, np.float32),
               raw=np.ones(1), log_likelihood=np.ones(1), alerts=np.ones(1, bool))
    for t in range(5):
        w.emit_batch(**one, group=0, tick=t)
    assert w.count == 5 and w.dropped == 5 and w.sink_quarantines == 1
    w._fh = real
    clock[0] = 10.0
    w.emit_batch(**one, group=0, tick=5)
    w.close()
    lines = (tmp_path / "a.jsonl").read_text().splitlines()
    assert lines[0].startswith('{"alert_id": "0:a:5"')
    assert lines[1] == '{"event": "alert_sink_restored", "lines_dropped": 5}'


class _RawSink(io.RawIOBase):
    """A sink that records each write the OS would see."""

    def __init__(self):
        self.writes: list[bytes] = []

    def writable(self):
        return True

    def write(self, b):
        self.writes.append(bytes(b))
        return len(b)


def test_a_tick_batch_reaches_the_sink_in_one_write_unlike_the_reference(tmp_path):
    """A full-width tick's alert batch (1,024 lines, ~200 KB) goes to the
    sink in one write in the port. The reference's ``writelines`` hands it
    over ~8 KB at a time, so a leader SIGSTOPped mid-batch finishes the
    tick's lines after it wakes, past its fence check, duplicating the ids
    its promoted standby spliced in the meantime (the fleet chaos drill's
    fence round at 1,024 streams per shard; ROADMAP.md §C). The bytes are
    the same."""
    ids = [f"n{i // 3}.m{i % 3}" for i in range(1024)]
    got = {}
    for mod in (ta, ja):
        rng = np.random.default_rng(3)
        w = mod.AlertWriter(str(tmp_path / f"{mod.__name__}.jsonl"))
        w._fh.close()
        sink = _RawSink()
        w._fh = io.TextIOWrapper(io.BufferedWriter(sink), encoding="utf-8")
        w.emit_batch(ids, np.full(1024, 1_700_000_152), rng.random(1024).astype(np.float32),
                     rng.random(1024).astype(np.float32), rng.random(1024) * 0.1,
                     np.ones(1024, bool), group=0, tick=152)
        w.flush_sink()
        got[mod] = sink.writes
    assert b"".join(got[ta]).count(b"\n") == 1024
    assert len(got[ta]) == 1
    assert len(got[ja]) > 1  # the reference's split batch
    assert b"".join(got[ta]) == b"".join(got[ja])
