"""HTMModel / AnomalyDetector: the single-stream model API.

Port of the JAX package's ``models/htm_model.py`` (``ModelFactory.create``
-> ``model.run(record)`` -> anomaly score). ``device=`` takes the place of
``backend=``: the model steps its one stream as a stream group of G = 1
through the port's own fused step (ops/step.group_step) on ``cuda`` unless
the caller asks for ``"cpu"``; there is no numpy-oracle backend. The
likelihood stays on the host (models/likelihood.py). Each record costs one
host sync (the raw score comes back as a float).

:meth:`HTMModel.save` writes the JAX package's one-file ``.npz`` layout
(``config_json``, ``seed``, ``lik_*``, single-stream ``s_*`` leaves, no
``fwd_*``) with an atomic temp-and-rename, so a file saved by either
package loads in the other and continues identically.

Many-stream execution goes through service/registry.py stream groups.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from rtap_tpu_torch import resolve_device
from rtap_tpu_torch.config import ModelConfig, nab_preset
from rtap_tpu_torch.models.likelihood import AnomalyLikelihood
from rtap_tpu_torch.models.state import init_state
from rtap_tpu_torch.ops.step import group_step, replicate_state_device


@dataclass
class ModelResult:
    """Per-record output (the reference's ModelResult.inferences)."""

    raw_score: float  # 1 - |active ∩ predicted| / |active|
    likelihood: float  # rolling-Gaussian tail probability complement
    log_likelihood: float  # NuPIC log-scaled likelihood (the detection score)
    prediction: float | None = None  # predicted next value (SDR classifier)
    prediction_prob: float | None = None  # probability of the argmax bucket


class HTMModel:
    """One HTM anomaly model over one (possibly multivariate) metric stream."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 _state: dict | None = None):
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the dense SP overlap counts through an f32 product (ops/sp.py)
            # and the classifier's product is f32
            torch.backends.cuda.matmul.allow_tf32 = False
        # _state: a prebuilt single-stream numpy state (HTMModel.load)
        single = init_state(cfg, seed) if _state is None else _state
        self.state = replicate_state_device(single, 1, self.device)
        self.likelihood = AnomalyLikelihood(cfg.likelihood)

    def run(self, timestamp: int, value: float | np.ndarray, learn: bool = True) -> ModelResult:
        """Process one record -> scores. Mirrors model.run({...}); with a
        learning cadence, group_step picks learn or infer from tm_iter
        (completed steps) with ``cfg.learns_on``, as the grouped path does."""
        values = np.atleast_1d(np.asarray(value, np.float32))
        v = torch.from_numpy(values[None]).to(self.device)
        ts = torch.tensor([int(timestamp)], dtype=torch.int32, device=self.device)
        self.state, out = group_step(self.state, v, ts, self.cfg, learn=learn)
        pred = prob = None
        if self.cfg.classifier.enabled:
            out, pred_t, prob_t = out
            pred, prob = float(pred_t[0]), float(prob_t[0])
        raw = float(out[0])
        lik, loglik = self.likelihood.update(raw)
        return ModelResult(raw, lik, loglik, pred, prob)

    def single_state(self) -> dict[str, np.ndarray]:
        """The model's state as single-stream numpy leaves (the shared layout)."""
        return {k: v[0].detach().cpu().numpy() for k, v in self.state.items()}

    def save(self, path: str) -> None:
        """Serialize the whole model (SDR state, likelihood, config, seed) to
        one .npz; :meth:`load` resumes bit-exactly. Atomic: written to a temp
        sibling and renamed over `path`, so a crash mid-save never corrupts
        an existing file there."""
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            np.savez_compressed(
                tmp,
                config_json=np.frombuffer(self.cfg.to_json().encode(), np.uint8),
                seed=np.asarray(self.seed, np.int64),
                **{f"lik_{k}": v for k, v in self.likelihood.state_dict().items()},
                **{f"s_{k}": v for k, v in self.single_state().items()},
            )
            # savez appends .npz to a name without it: follow it
            if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
                tmp += ".npz"
            os.replace(tmp, path)
        finally:
            for residue in (tmp, tmp if tmp.endswith(".npz") else tmp + ".npz"):
                if os.path.exists(residue) and os.path.abspath(residue) != os.path.abspath(path):
                    os.unlink(residue)

    @classmethod
    def load(cls, path: str, device=None) -> "HTMModel":
        """Rebuild a model from :meth:`save` (either package's) on `device`
        (``cuda`` unless given). Forward-index leaves (``s_fwd_*``, derived
        state of the JAX package) are skipped: the port has no forward
        index."""
        with np.load(path) as z:
            cfg = ModelConfig.from_json(bytes(z["config_json"]).decode())
            state = {k[2:]: z[k] for k in z.files
                     if k.startswith("s_") and not k[2:].startswith("fwd_")}
            lik_state = {k[4:]: z[k] for k in z.files if k.startswith("lik_")}
            seed = int(z["seed"])
        model = cls(cfg, seed=seed, device=device, _state=state)
        model.likelihood.load_state_dict(lik_state)
        return model


def create_model(cfg: ModelConfig | None = None, device=None, seed: int = 0,
                 min_val: float = 0.0, max_val: float = 100.0) -> HTMModel:
    """ModelFactory.create analog. With no config, the NAB preset sized to
    the stream's expected [min_val, max_val] range (as NAB sizes its
    detectors per file)."""
    return HTMModel(cfg or nab_preset(min_val, max_val), seed=seed, device=device)


class AnomalyDetector:
    """NAB-detector-shaped wrapper: feed records, get detection scores and
    alerts; `threshold` is on the log-likelihood scale (0.5 by default)."""

    def __init__(self, cfg: ModelConfig | None = None, device=None, seed: int = 0,
                 min_val: float = 0.0, max_val: float = 100.0, threshold: float = 0.5):
        self.model = create_model(cfg, device, seed, min_val, max_val)
        self.threshold = threshold

    def handle_record(self, timestamp: int, value: float | np.ndarray) -> tuple[float, bool]:
        """-> (detection score in [0, 1] (log-likelihood), alert?)."""
        res = self.model.run(timestamp, value)
        return res.log_likelihood, res.log_likelihood >= self.threshold
