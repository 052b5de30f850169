"""Device resolution for every entry point of the port.

The port runs on the card.  The CPU is taken only when the caller asks for
it by name (the tests do), never as a quiet fallback for a missing GPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; raises if CUDA is asked for (explicitly or
    by default) and no GPU is present.  A CUDA device comes back with its
    index (the current device when none was given); ``"cpu"`` is honoured
    as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
