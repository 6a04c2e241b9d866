"""rtap_tpu_torch.predict — the host side of the predictive horizon: the
per-stream precursor tracker (horizon.py) and the precursor x topology
fuser (blast.py). The port's copy of the JAX package's ``predict/``."""

from rtap_tpu_torch.predict.blast import BlastFuser
from rtap_tpu_torch.predict.horizon import PredictTracker

__all__ = ["BlastFuser", "PredictTracker"]
