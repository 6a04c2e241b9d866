"""NAB detection quality: the scorer (numpy) and the corpus runner."""

from rtap_tpu_torch.nab.scorer import (  # noqa: F401
    PROFILES,
    CostProfile,
    optimize_threshold,
    scaled_sigmoid,
    score_corpus,
    score_file,
)
