"""Architecture registry of the port: ``get_config``, ``family``,
``shapes_for``, ``all_cells``, ``input_specs`` and ``reduced_config``.

The port holds every architecture of `repro.configs`: the paper's own
system, ``mirex`` (what `launch.serve` reads in search mode), the LMs (the
dense ``gemma2-2b``, ``gemma2-27b`` and ``h2o-danube-1.8b`` and the MoE
``qwen3-moe-30b-a3b`` and ``dbrx-132b``), the GNN ``pna`` and the recsys
models ``fm``, ``dcn-v2``, ``mind`` and ``sasrec``. ``input_specs`` gives
the batch inputs of a cell as tensors on the ``meta`` device (a shape and a
dtype, no data: the reference's ``jax.ShapeDtypeStruct``), the currency of
the lowering tools (`repro_torch.launch.cells`, ``dryrun``).
"""

from __future__ import annotations

import dataclasses

import torch

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
ASSIGNED_ARCHS = tuple(a for a in ARCH_IDS if a != "mirex")

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


def all_cells(include_mirex: bool = False) -> list[tuple[str, str]]:
    """Every assigned (arch, shape) pair: 40 cells (+ mirex's own 3)."""
    archs = ARCH_IDS if include_mirex else ASSIGNED_ARCHS
    return [(a, s) for a in archs for s in shapes_for(a)]


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


def _sds(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def input_specs(arch: str, shape_name: str) -> dict:
    """Stand-ins on the ``meta`` device for the *batch* inputs of one cell,
    the reference's shapes and dtypes. Parameters, optimizer state and KV
    caches come from the model modules (``param_shapes``,
    ``cache_shapes``); this covers what the data pipeline feeds."""
    cfg = get_config(arch)
    spec = shapes_for(arch)[shape_name]
    d = spec.dims
    kind = spec.kind
    if kind == "train":
        b, s = d["global_batch"], d["seq_len"]
        return {"tokens": _sds((b, s), "int32"), "labels": _sds((b, s), "int32")}
    if kind == "prefill":
        return {"tokens": _sds((d["global_batch"], d["seq_len"]), "int32")}
    if kind == "decode":
        return {"tokens": _sds((d["global_batch"],), "int32"), "t": _sds((), "int32")}
    if kind == "full_graph":
        e = d.get("n_edges_padded", d["n_edges"])
        return {
            "x": _sds((d["n_nodes"], d["d_feat"]), "float32"),
            "src": _sds((e,), "int32"),
            "dst": _sds((e,), "int32"),
            "labels": _sds((d["n_nodes"],), "int32"),
        }
    if kind == "minibatch":
        b = d["batch_nodes"]
        k1, k2 = d["fanout"]
        f = d["d_feat"]
        return {
            "seed_x": _sds((b, f), "float32"),
            "hop1_x": _sds((b, k1, f), "float32"),
            "hop2_x": _sds((b, k1, k2, f), "float32"),
            "labels": _sds((b,), "int32"),
        }
    if kind == "batched_graphs":
        b, n, e, f = d["batch"], d["n_nodes"], d["n_edges"], d["d_feat"]
        return {
            "x": _sds((b, n, f), "float32"),
            "src": _sds((b, e), "int32"),
            "dst": _sds((b, e), "int32"),
            "labels": _sds((b,), "int32"),
        }
    if kind in ("rec_train", "rec_serve"):
        b = d["batch"]
        if cfg.variant in ("fm", "dcn-v2"):
            out = {"sparse_ids": _sds((b, cfg.n_sparse), "int32")}
            if cfg.n_dense:
                out["dense"] = _sds((b, cfg.n_dense), "float32")
            if kind == "rec_train":
                out["labels"] = _sds((b,), "float32")
            return out
        out = {"history": _sds((b, max(cfg.seq_len, 50)), "int32")}
        if kind == "rec_train":
            out["target"] = _sds((b, max(cfg.seq_len, 50)), "int32")
        return out
    if kind == "retrieval":
        n = d["n_candidates"]
        if cfg.variant in ("fm", "dcn-v2"):
            out = {"sparse_ids": _sds((1, cfg.n_sparse), "int32")}
            if cfg.n_dense:
                out["dense"] = _sds((1, cfg.n_dense), "float32")
        else:
            out = {"history": _sds((1, max(cfg.seq_len, 50)), "int32")}
        out["cand_ids"] = _sds((n,), "int32")
        return out
    if kind == "scan":
        return {
            "q_tokens": _sds((d["n_queries"], cfg.max_q_len), "int32"),
            "d_tokens": _sds((d["n_docs"], d["doc_len"]), "int32"),
            "d_len": _sds((d["n_docs"],), "int32"),
        }
    if kind == "dense_scan":
        return {
            "q_vecs": _sds((d["n_queries"], d["dim"]), "float32"),
            "d_vecs": _sds((d["n_docs"], d["dim"]), "float32"),
        }
    raise ValueError(f"unknown cell kind {kind}")
