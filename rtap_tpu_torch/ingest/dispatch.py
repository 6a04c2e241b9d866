"""Registry slot map -> vectorized wire-code dispatch.

The registry hands sources a SLOT MAP — ``{stream_id: SlotAddress(shard,
group, slot)}`` (service/registry.py) — instead of a flat id list: the
addressing every pod-scale design needs (a shard owns groups, a group
owns slots; a flat id registry cannot express placement). This module
renders that map as dense numpy lookup tables so a frame's packed rows
route to their (group, slot) dispatch positions with two fancy-index
operations and zero per-record Python.
"""

from __future__ import annotations

import numpy as np

from rtap_tpu_torch.ingest.protocol import (
    MAX_GROUPS,
    MAX_SLOTS,
    SLOT_BITS,
    encode_slot,
)


class DispatchTable:
    """Bidirectional (shard, group, slot) <-> dispatch-position tables.

    ``ids``/``codes`` follow the registry's dispatch order (the value-
    vector order live_loop routes by); ``lookup`` maps wire slot codes to
    dispatch positions (-1 for codes that address no live stream —
    pads, released slots, or garbage), vectorized over whole frames.
    """

    def __init__(self, slot_map: dict):
        # dispatch order = (group, slot) ascending, matching
        # StreamGroupRegistry.dispatch_ids() (live slots per group in
        # slot order) — pinned by tests/test_torch_ingest_protocol.py
        items = sorted(slot_map.items(),
                       key=lambda kv: (kv[1].group, kv[1].slot))
        self.ids: list[str] = [sid for sid, _ in items]
        self.codes = np.array(
            [encode_slot(a.shard, a.group, a.slot) for _, a in items],
            np.uint32)
        self.code_of = {sid: int(c) for sid, c in zip(self.ids, self.codes)}
        self.n = len(self.ids)
        # direct table over a code's low 24 bits (group << 12 | slot) ->
        # dispatch position, -1 where no live stream sits (pads, released
        # slots): 16 KiB per group, sized to the fleet's groups, plus one -1
        # guard entry that every out-of-range address clips onto
        n_groups = 1 + max((a.group for _, a in items), default=0)
        self._direct = np.full((n_groups << SLOT_BITS) + 1, -1, np.int32)
        for pos, (_sid, a) in enumerate(items):
            self._direct[(a.group << SLOT_BITS) | a.slot] = pos
        self._low_mask = np.uint32(MAX_GROUPS * MAX_SLOTS - 1)
        # codes by position plus one entry that position -1 reads
        self._codes_ext = np.append(self.codes, np.uint32(0))

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        """Wire codes [N] u32 -> dispatch positions [N] i64 (-1 = no
        live stream at that address). Shard bits are part of the
        address: a code whose (group, slot) exists but whose shard
        disagrees with the map is rejected too.

        The JAX package's positions from one direct gather instead of its
        dense [group, slot] table and boolean masks (the binary decode's
        hottest step; the port's addition)."""
        codes = np.asarray(codes, np.uint32)
        idx = self._direct.take(codes & self._low_mask, mode="clip").astype(np.int64)
        # full-code check: catches wrong-shard (and any future reserved-bit)
        # addressing; position -1 stays -1 whatever it reads
        idx[self._codes_ext.take(idx) != codes] = -1
        return idx

    @classmethod
    def from_registry(cls, reg) -> "DispatchTable":
        return cls(reg.slot_map())


def decode_frames_to_row(blobs, width: int, table: DispatchTable) -> np.ndarray:
    """Journal-replay decode: apply raw DATA frame bytes in order onto
    a NaN row of ``width`` — exactly the ingest-time scatter, re-run,
    so a journaled binary tick replays bit-identically
    (resilience/journal.py FRAME records; service/loop.py calls this).

    Raises ValueError on a width mismatch (membership changed without a
    checkpoint boundary — the caller skips the row, counted)."""
    from rtap_tpu_torch.ingest.protocol import KIND_DATA, FrameWalker

    if width != table.n:
        raise ValueError(
            f"journaled frame width {width} != dispatch width {table.n}")
    values = np.full(width, np.nan, np.float32)
    walker = FrameWalker(native=False)  # replay is cold-path
    for blob in blobs:
        for fr in walker.feed(blob):
            if fr.kind != KIND_DATA:
                continue
            rows = fr.rows()
            pos = table.lookup(rows["slot"])
            valid = pos >= 0
            values[pos[valid]] = rows["value"][valid]
    return values
