"""Device resolution for the port's entry points.

An entry point runs on ``cuda`` unless its caller asks for another device.
Without a card it raises: it never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must exist, or this raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the port's plain PyTorch path on the CPU"
        )
    return dev


def canonical_device(device: str | torch.device | None = None) -> torch.device:
    """:func:`resolve_device`, with a CUDA device's index filled in (the
    current device's), so that two names of one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
