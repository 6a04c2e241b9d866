"""Ingest-boundary helpers of the port: the log-template miner."""

from rtap_tpu_torch.ingest.templates import WILDCARD, TemplateMiner

__all__ = ["TemplateMiner", "WILDCARD"]
