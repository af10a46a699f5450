"""Which torch device the engines run on.

Counterpart of swarm_tpu/device.py: reports whether a CUDA device is
present and its name. CUDA initialisation errors propagate.
"""

import torch


def device_available() -> bool:
    """True when a CUDA device is present."""
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """The first CUDA device when present, else the CPU."""
    return torch.device("cuda", 0) if device_available() else torch.device("cpu")


def device_name() -> str:
    """torch.cuda.get_device_name(0), or "cpu" without a CUDA device."""
    return torch.cuda.get_device_name(0) if device_available() else "cpu"
