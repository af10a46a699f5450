"""Which torch device the engines run on.

Counterpart of swarm_tpu/device.py: reports whether a CUDA device is
present and its name. CUDA initialisation errors propagate.
"""

import torch


def device_available() -> bool:
    """True when a CUDA device is present."""
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none (the CPU is
    never chosen silently: a caller that wants it asks for it)."""
    if not device_available():
        raise RuntimeError(
            "swarm_tpu_torch found no CUDA device; to run on the CPU ask "
            "for it: run(..., device='cpu') or SWARM_TORCH_DEVICE=cpu")
    return torch.device("cuda", 0)


def card_ready() -> bool:
    """Whether this process already holds the CUDA context and the
    loaded kernel library: the resident server, or a run after another
    in one process. A process that does not pays for both at its first
    use of a card engine, so the dispatch rules of the d=1 network
    (ops/neighbors.py) and of the d>=2 engine (models/general.py) move
    to the card at a larger size then."""
    from . import _build

    return torch.cuda.is_initialized() and _build.loaded()


def device_name() -> str:
    """torch.cuda.get_device_name(0), or "cpu" without a CUDA device."""
    return torch.cuda.get_device_name(0) if device_available() else "cpu"
