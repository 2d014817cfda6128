"""Kernels of the port: hand-written CUDA C++ for Hopper, each beside its
plain PyTorch version: `lexical_scan` (replacing the Pallas
`lexical_scan_topk_pallas`) and `score_topk` (replacing `score_topk_pallas`).
The two flash kernels wait for the models slice."""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
