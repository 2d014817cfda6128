"""Mesh construction (the port's copy of `repro.launch.mesh`).

Functions, not module-level constants: importing this module touches no
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh


def visible_devices(device=None) -> list[torch.device]:
    """Every visible device of ``device``'s type (default ``cuda``): the
    cards ``cuda:0..n-1``, or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 devices a pod; 2 pods = 512 with a leading "pod" axis
    ("pod" composes with "data" for data-parallel math; "model" stays
    inside a pod). Built from ``devices`` (default: every visible card);
    raises when there are fewer than the shape needs, as ``jax.make_mesh``
    does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = visible_devices() if devices is None else list(devices)
    need = math.prod(shape)
    if len(devices) < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} devices, "
                         f"{len(devices)} given")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(shape), axes)


def make_test_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh (the reference's axis names) whose every
    entry is the run's one device (default ``cuda``; ``device="cpu"`` for
    the CPU): shards share it, one CUDA stream a shard on a card."""
    dev = resolve_device(device)
    arr = np.empty((data, model), dtype=object)
    arr.fill(dev)
    return Mesh(arr, ("data", "model"))
