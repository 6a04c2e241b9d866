"""rtap_tpu_torch.correlate — topology-aware incident correlation: the
node/service topology (topology.py) and the windowed correlator that folds
per-stream alerts into cluster-level ``incident`` events (incidents.py).
The port's copy of the JAX package's ``correlate/``."""

from rtap_tpu_torch.correlate.incidents import IncidentCorrelator, incident_id_of
from rtap_tpu_torch.correlate.topology import TopologyMap

__all__ = ["IncidentCorrelator", "TopologyMap", "incident_id_of"]
