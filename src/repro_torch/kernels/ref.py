"""Plain PyTorch versions of the port's kernels, gathered in one place.

Each lives beside its kernel; this module re-exports them for tests and
benchmarks (as `repro.kernels.ref` gathers the reference's oracles).
"""

from repro_torch.kernels.flash_attn import flash_attention_ref
from repro_torch.kernels.flash_decode import flash_decode_ref
from repro_torch.kernels.lexical_scan import lexical_scan_topk_ref
from repro_torch.kernels.score_topk import score_topk_ref

__all__ = ["flash_attention_ref", "flash_decode_ref", "lexical_scan_topk_ref", "score_topk_ref"]
