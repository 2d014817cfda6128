"""MIREX on PyTorch and CUDA: the port of the JAX/Pallas package `repro`.

The port mirrors `repro` module for module where a module is ported. Plain
tensor code is PyTorch; the lexical scan and the dense score + top-k run as
CUDA C++ kernels written for Hopper (`repro_torch/kernels/csrc/`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU
tensors every
kernel wrapper runs its plain PyTorch version, on CUDA tensors it launches
the kernel or raises.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
