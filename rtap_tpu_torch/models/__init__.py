"""Model state, permanence domains, the single-stream likelihood and the
single-stream model API (``HTMModel``, ``AnomalyDetector``, ``create_model``,
``ModelResult`` from models/htm_model.py, importable from here too)."""

_HTM_MODEL_NAMES = ("AnomalyDetector", "HTMModel", "ModelResult", "create_model")


def __getattr__(name):
    # imported on first use: htm_model imports ops/step, which imports
    # models/state, so an eager import here would be circular
    if name in _HTM_MODEL_NAMES:
        from rtap_tpu_torch.models import htm_model

        return getattr(htm_model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
