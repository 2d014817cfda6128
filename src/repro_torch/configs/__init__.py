"""Architecture registry of the port: ``get_config``, ``family``,
``shapes_for`` and ``reduced_config``.

The port holds every architecture of `repro.configs`: the paper's own
system, ``mirex`` (what `launch.serve` reads in search mode), the LMs (the
dense ``gemma2-2b``, ``gemma2-27b`` and ``h2o-danube-1.8b`` and the MoE
``qwen3-moe-30b-a3b`` and ``dbrx-132b``), the GNN ``pna`` and the recsys
models ``fm``, ``dcn-v2``, ``mind`` and ``sasrec``. ``input_specs`` and the
cells built from the shapes wait for the lowering tools (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.archs import (
    dbrx_132b,
    dcn_v2,
    fm,
    gemma2_2b,
    gemma2_27b,
    h2o_danube_1_8b,
    mind,
    mirex,
    pna,
    qwen3_moe_30b_a3b,
    sasrec,
)
from repro_torch.configs import shapes as _shapes
from repro_torch.configs.base import (
    GNNConfig, MirexConfig, RecsysConfig, ShapeSpec, TransformerConfig,
)

_MODULES = {
    "dbrx-132b": dbrx_132b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "gemma2-27b": gemma2_27b,
    "gemma2-2b": gemma2_2b,
    "pna": pna,
    "dcn-v2": dcn_v2,
    "fm": fm,
    "mind": mind,
    "sasrec": sasrec,
    "mirex": mirex,
}

ARCH_IDS = tuple(_MODULES)

Config = MirexConfig | TransformerConfig | GNNConfig | RecsysConfig


def get_config(arch: str) -> Config:
    try:
        return _MODULES[arch].config()
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}") from None


def family(arch: str) -> str:
    cfg = get_config(arch)
    if isinstance(cfg, TransformerConfig):
        return "lm"
    if isinstance(cfg, GNNConfig):
        return "gnn"
    if isinstance(cfg, RecsysConfig):
        return "recsys"
    return "mirex"


def shapes_for(arch: str) -> dict[str, ShapeSpec]:
    return {
        "lm": _shapes.LM_SHAPES,
        "gnn": _shapes.GNN_SHAPES,
        "recsys": _shapes.RECSYS_SHAPES,
        "mirex": _shapes.MIREX_SHAPES,
    }[family(arch)]


def reduced_config(arch: str) -> Config:
    """Tiny same-family config for CPU smoke tests, as `repro.configs`
    reduces it: same structure (window pattern, soft caps, GQA, MoE-ness,
    interaction type), reduced dims."""
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
    if isinstance(cfg, GNNConfig):
        return dataclasses.replace(cfg, n_layers=2, d_hidden=16)
    if isinstance(cfg, RecsysConfig):
        return dataclasses.replace(
            cfg,
            embed_dim=8,
            vocab_per_field=64,
            n_items=128,
            mlp_dims=(32, 16) if cfg.mlp_dims else (),
            seq_len=12 if cfg.seq_len else 0,
        )
    return dataclasses.replace(cfg, vocab=512, k=16, chunk_size=64, max_doc_len=32, dense_dim=32)
