"""Kernels of the port: hand-written CUDA C++ for Hopper, each beside its
plain PyTorch version. This slice holds `lexical_scan` (replacing the Pallas
`lexical_scan_topk_pallas`); the dense `score_topk` and the two flash
kernels wait for later slices."""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
