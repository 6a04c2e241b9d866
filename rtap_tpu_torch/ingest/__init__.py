"""Ingest boundary of the port: the RB1 binary batch protocol and the
log-template miner.

The port's copy of the JAX package's ``ingest/`` (host only, no device):

- :mod:`rtap_tpu_torch.ingest.protocol` — the versioned ``RB1`` frame
  (packed ``(slot_u32, value_f32, ts_delta_u16)`` rows), the (shard, group,
  slot) slot-code packing and the frame walker (native C scanner,
  pure-Python fallback).
- :mod:`rtap_tpu_torch.ingest.dispatch` — the registry slot map as a
  vectorized code -> dispatch-position table, and the journal-replay decode.
- :mod:`rtap_tpu_torch.ingest.shm` — the shared-memory frame ring for
  co-located exporters (same frames, no socket).
- :mod:`rtap_tpu_torch.ingest.server` — :class:`BinaryBatchSource`, the
  live_loop source: persistent-socket listener and shm drain, backfill,
  quotas and backpressure, ``rtap_obs_ingest_*`` telemetry.
- :mod:`rtap_tpu_torch.ingest.emit` — producer helpers
  (:func:`send_binary`, :class:`BinaryFeedConnection`).
- :mod:`rtap_tpu_torch.ingest.templates` — the log-template miner.
"""

from rtap_tpu_torch.ingest.dispatch import DispatchTable
from rtap_tpu_torch.ingest.emit import BinaryFeedConnection, send_binary
from rtap_tpu_torch.ingest.protocol import (
    KIND_DATA,
    KIND_MAP,
    KIND_NAMES,
    PROTOCOL_VERSION,
    FrameWalker,
    build_frame,
    decode_slot,
    encode_slot,
    pack_rows,
)
from rtap_tpu_torch.ingest.server import BinaryBatchSource
from rtap_tpu_torch.ingest.shm import ShmRing
from rtap_tpu_torch.ingest.templates import WILDCARD, TemplateMiner

__all__ = [
    "BinaryBatchSource",
    "TemplateMiner",
    "WILDCARD",
    "BinaryFeedConnection",
    "DispatchTable",
    "FrameWalker",
    "KIND_DATA",
    "KIND_MAP",
    "KIND_NAMES",
    "PROTOCOL_VERSION",
    "ShmRing",
    "build_frame",
    "decode_slot",
    "encode_slot",
    "pack_rows",
    "send_binary",
]
