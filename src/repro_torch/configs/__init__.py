"""Architecture registry of the port: ``get_config`` and ``reduced_config``.

The port holds the paper's own system, ``mirex`` (what `launch.serve`
reads in search mode), and the LMs of `repro.configs`: the dense
``gemma2-2b``, ``gemma2-27b`` and ``h2o-danube-1.8b`` and the MoE
``qwen3-moe-30b-a3b`` and ``dbrx-132b`` (LM serving). The GNN and the
recsys models wait for their slices; asking for one raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.archs import (
    dbrx_132b,
    gemma2_2b,
    gemma2_27b,
    h2o_danube_1_8b,
    mirex,
    qwen3_moe_30b_a3b,
)
from repro_torch.configs.base import MirexConfig, TransformerConfig

_MODULES = {
    "dbrx-132b": dbrx_132b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "gemma2-27b": gemma2_27b,
    "gemma2-2b": gemma2_2b,
    "mirex": mirex,
}
_LATER_SLICES = {
    "pna": "GNN",
    "dcn-v2": "recsys", "fm": "recsys", "mind": "recsys", "sasrec": "recsys",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> MirexConfig | TransformerConfig:
    if arch in _LATER_SLICES:
        raise NotImplementedError(
            f"the {arch!r} config waits for the {_LATER_SLICES[arch]} slice of the port")
    try:
        return _MODULES[arch].config()
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}") from None


def reduced_config(arch: str) -> MirexConfig | TransformerConfig:
    """Tiny same-family config for CPU smoke tests, as `repro.configs`
    reduces it: same structure (window pattern, soft caps, GQA), reduced
    dims."""
    cfg = get_config(arch)
    if isinstance(cfg, TransformerConfig):
        return dataclasses.replace(
            cfg,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
            head_dim=16 if cfg.head_dim is not None else None,
            d_ff=128,
            vocab=512,
            n_experts=4 if cfg.is_moe else 0,
            top_k=2 if cfg.is_moe else 0,
            sliding_window=8 if cfg.sliding_window is not None else None,
            dtype="float32",
            remat_chunk=1,
            grad_accum=1,
            opt_dtype="float32",
            q_block=16,
        )
    return dataclasses.replace(cfg, vocab=512, k=16, chunk_size=64, max_doc_len=32, dense_dim=32)
