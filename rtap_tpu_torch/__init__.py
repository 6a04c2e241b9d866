"""rtap_tpu_torch — the HTM anomaly pipeline in PyTorch, for one NVIDIA H100.

A port of the JAX package ``rtap_tpu`` that computes the same per-stream
state and the same raw scores bit for bit. It imports ``torch`` and numpy,
never ``jax`` and nothing of ``rtap_tpu``: the framework-free modules it
needs (config, permanence domains, likelihood, synthetic data) are its own
copies.

The replay path: ``service/replay.replay_streams`` -> ``service/registry``
stream groups -> ``ops/step.chunk_step`` (bind offsets -> encode -> SP ->
TM -> raw score per tick) -> host likelihood and debounced alerts. The TM
learning pass is a hand-written CUDA kernel (``csrc/tm_learn.cu``, wrapped
by ``ops/tm_learn.py``); everything else is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
missing card raises instead of falling back.
"""

def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA was asked for (or defaulted to) and there is
    no card — the port never falls back to the CPU on its own."""
    # torch is imported here, not with the package: a process that needs no
    # tensor (the --control-only plane) starts without paying its import
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rtap_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch path on the CPU")
    return dev
