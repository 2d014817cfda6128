"""Kernels of the port: hand-written CUDA C++ for Hopper, each beside its
plain PyTorch version: `lexical_scan` (replacing the Pallas
`lexical_scan_topk_pallas`), `score_topk` (replacing `score_topk_pallas`),
`flash_attn` (replacing `flash_attention_pallas`) and `flash_decode`
(replacing `flash_decode_pallas`)."""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
