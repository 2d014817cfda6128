"""Cell builder: (architecture × input shape × mesh) → a step and its
inputs (the port's copy of `repro.launch.cells`).

One place defines, for every assigned cell, the step function, its
abstract inputs and their sharding specs. The inputs are tensors on the
``meta`` device (a shape and a dtype, no data: the reference's
``jax.ShapeDtypeStruct``), so a cell runs without allocating anything; the
dry-run (`launch.dryrun`) runs each step so under an op counter
(`launch.opcount`), and a caller may run a reduced cell on real tensors.
The mesh is the port's `Mesh`, usually of ``meta`` devices
(:func:`meta_mesh`); its shards run one after another, as everywhere in
the port. The specs are tuples of axis groups (`AxisRules.spec`);
``donate`` names the arguments the reference donates to its jitted step
(the port's training step updates parameters and moments in place).

Every cell builds on every mesh: on a production mesh the LM training
cells run the vocabulary- and data-parallel loss
(`models.transformer.make_loss_fn`) and the decode cells the
sequence-sharded cache (`models.transformer.make_serve_step`), each shard's
part in turn.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config, input_specs, shapes_for
from repro_torch.configs.base import GNNConfig, MirexConfig, RecsysConfig, TransformerConfig
from repro_torch.core import scoring, topk
from repro_torch.core.scan import search_local
from repro_torch.distributed.sharding import AxisRules, Mesh, replicated_specs, rules_for_mesh
from repro_torch.launch import train as train_lib
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tfm
from repro_torch.obs import counting
from repro_torch.optim.adamw import AdamWState, adamw_state_shapes, opt_state_specs

# the cells' schedule (the reference's `launch/cells.py:68`)
LR = train_lib.GNN_LR

MESHES = {"1": ((1, 1), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable  # positional args matching abstract_inputs
    abstract_inputs: tuple  # trees (dicts) of meta tensors
    in_specs: tuple  # matching trees of specs (tuples of axis groups)
    donate: tuple[int, ...] = ()
    note: str = ""


def meta_mesh(name: str = "1") -> Mesh:
    """A mesh of ``meta`` devices: ``"1"`` (one H100, a (1, 1) mesh over
    ``("data", "model")``), ``"16x16"`` or ``"2x16x16"`` (the reference's
    production meshes)."""
    shape, axes = MESHES[name]
    arr = np.empty(shape, dtype=object)
    arr.fill(torch.device("meta"))
    return Mesh(arr, axes)


def abstract(tree):
    """Meta tensors for a tree of shapes (`ParamSpec` leaves, dicts,
    `AdamWState`)."""
    if isinstance(tree, AdamWState):
        return AdamWState(*(abstract(t) for t in tree))
    if isinstance(tree, dict):
        return {k: abstract(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def make_train_step(loss_fn, accum_steps: int = 1):
    """One optimizer step at the cells' schedule, the reference's
    signature: ``step(params, opt, batch) -> (params, opt, metrics)``;
    ``accum_steps > 1`` accumulates the microbatches' gradients. It is
    `launch.train.make_train_step`'s step, without gradient compression."""
    step = train_lib.make_train_step(loss_fn, LR, accum_steps=accum_steps)

    def train_step(params, opt, batch):
        ef = torch.zeros((), dtype=torch.float32, device=opt.step.device)
        params, opt, _, metrics = step(params, opt, ef, batch)
        return params, opt, metrics

    return train_step


def _size(mesh: Mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _dp(rules: AxisRules):
    return rules.spec("dp")[0]


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch: str, shape_name: str, mesh: Mesh, rules: AxisRules) -> Cell:
    cfg: TransformerConfig = get_config(arch)
    spec = shapes_for(arch)[shape_name]
    b, s = spec.dims["global_batch"], spec.dims["seq_len"]
    tp_size, dp_size = mesh.shape[rules.tp], _size(mesh, rules.dp)
    pshapes = tfm.param_shapes(cfg)
    pspecs = tfm.param_specs(cfg, rules, tp_size)
    batch_abs = input_specs(arch, shape_name)
    dp = _dp(rules)

    if spec.kind == "train":
        moe_mode = "seq" if s % tp_size == 0 else "train"
        accum = cfg.grad_accum if b % (cfg.grad_accum * dp_size) == 0 else 1
        ctx = tfm.make_context(cfg, mesh, rules, tokens_per_shard=(b // (dp_size * accum)) * s,
                               moe_mode=moe_mode)
        step = make_train_step(tfm.make_loss_fn(ctx), accum_steps=accum)
        opt_abs = adamw_state_shapes(pshapes, moment_dtype=getattr(torch, cfg.opt_dtype))
        return Cell(arch, shape_name, step,
                    (abstract(pshapes), abstract(opt_abs), batch_abs),
                    (pspecs, opt_state_specs(pspecs, pshapes, rules, dp_size),
                     {"tokens": (dp, None), "labels": (dp, None)}),
                    donate=(0, 1), note=f"accum_steps={accum}")

    if spec.kind == "prefill":
        moe_mode = "seq" if s % tp_size == 0 else "train"
        ctx = tfm.make_context(cfg, mesh, rules, tokens_per_shard=(b // dp_size) * s,
                               moe_mode=moe_mode)
        return Cell(arch, shape_name, tfm.make_prefill_step(ctx),
                    (abstract(pshapes), batch_abs["tokens"]), (pspecs, (dp, None)))

    # decode: one new token against a seq_len cache
    moe_mode = "train" if b > 1 else "replicated"
    ctx = tfm.make_context(cfg, mesh, rules,
                           tokens_per_shard=max(b // dp_size, 1) if b > 1 else 1,
                           moe_mode=moe_mode)
    serve = tfm.make_serve_step(ctx, batch=b)
    return Cell(arch, shape_name, serve,
                (abstract(pshapes), abstract(tfm.cache_shapes(cfg, b, s)), batch_abs["tokens"],
                 batch_abs["t"]),
                (pspecs, tfm.cache_specs(cfg, rules, b), (dp,) if b > 1 else (), ()),
                donate=(1,), note=f"moe_mode={moe_mode}" if cfg.is_moe else "")


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_cell(arch: str, shape_name: str, mesh: Mesh, rules: AxisRules) -> Cell:
    spec = shapes_for(arch)[shape_name]
    d = spec.dims
    cfg: GNNConfig = dataclasses.replace(get_config(arch), n_classes=d["n_classes"])
    batch_abs = input_specs(arch, shape_name)
    pshapes = gnn.param_shapes(cfg, d["d_feat"])
    pspecs = replicated_specs(pshapes)
    opt_abs = adamw_state_shapes(pshapes)
    every = (rules.all_axes,)
    step = make_train_step(train_lib.build_gnn(cfg, spec.kind, mesh, rules))
    if spec.kind == "full_graph":
        bspecs = {"x": (None, None), "src": every, "dst": every, "labels": (None,)}
    elif spec.kind == "minibatch":
        bspecs = {k: every for k in batch_abs}
    else:  # batched_graphs
        bspecs = {k: (_dp(rules),) for k in batch_abs}
    return Cell(arch, shape_name, step, (abstract(pshapes), abstract(opt_abs), batch_abs),
                (pspecs, opt_state_specs(pspecs, pshapes, rules, _size(mesh, rules.dp)), bspecs),
                donate=(0, 1))


# ---------------------------------------------------------------------------
# shards over the whole mesh, merged by the butterfly (recsys retrieval, MIREX)
# ---------------------------------------------------------------------------

def _over_mesh(mesh: Mesh, rules: AxisRules, local: Callable[[int], topk.TopKState]):
    """Every shard's ``local(idx)`` (flat shard order over ``rules.all_axes``)
    merged by the reference's tree merge, one stage an axis; every shard
    ends with the global state, so the first one's is returned."""
    axes = rules.all_axes
    shape = tuple(mesh.shape[a] for a in axes)
    probe = mesh.devices.flat[0].type == "meta"
    states = counting.each_shard(math.prod(shape), local, meta=probe)
    merged = topk.merge_across(topk.state_array(states, shape), axes, axes=axes, method="tree")
    return merged.flat[0]


def _recsys_cell(arch: str, shape_name: str, mesh: Mesh, rules: AxisRules) -> Cell:
    cfg: RecsysConfig = get_config(arch)
    spec = shapes_for(arch)[shape_name]
    batch_abs = input_specs(arch, shape_name)
    pshapes = recsys.param_shapes(cfg)
    pspecs = recsys.param_specs(cfg, rules)
    every = (rules.all_axes,)

    if spec.kind == "rec_train":
        def loss_fn(params, batch):
            loss = recsys.train_logits(params, batch, cfg)
            return loss, {"loss": loss}

        opt_abs = adamw_state_shapes(pshapes)
        dp_size = max(mesh.shape[a] for a in rules.dp)
        return Cell(arch, shape_name, make_train_step(loss_fn),
                    (abstract(pshapes), abstract(opt_abs), batch_abs),
                    (pspecs, opt_state_specs(pspecs, pshapes, rules, dp_size),
                     {k: every for k in batch_abs}), donate=(0, 1))

    if spec.kind == "rec_serve":
        def serve(params, batch):
            if cfg.variant == "fm":
                return recsys.fm_forward(params, batch, cfg)
            if cfg.variant == "dcn-v2":
                return recsys.dcn_forward(params, batch, cfg)
            if cfg.variant == "mind":
                return recsys.mind_interests(params, batch["history"], cfg)
            return recsys.sasrec_forward(params, batch["history"], cfg)[:, -1]

        return Cell(arch, shape_name, serve, (abstract(pshapes), batch_abs),
                    (pspecs, {k: every for k in batch_abs}))

    # retrieval: the MIREX scan — candidates over the whole mesh, each
    # shard's score and top-k, then the k-bounded tree merge
    k = 1000
    n_all = _size(mesh, rules.all_axes)
    n_loc = spec.dims["n_candidates"] // n_all

    def retrieve(params, user_batch, cand_ids):
        def local(idx):
            cand = cand_ids[idx * n_loc:(idx + 1) * n_loc]
            if cfg.variant == "dcn-v2":
                scores = recsys.score_block_dcn(params, user_batch, cand, cfg)
            elif cfg.variant == "fm":
                # FM's score is linear in the candidate: q·v_c + w_c (+ a user constant)
                q = recsys.user_query_vector(params, user_batch, cfg)
                scores = (recsys.score_block_dot(q, recsys._rows(params["tables"][-1], cand))
                          + recsys._rows(params["linear"][-1][:, None], cand)[:, 0][None, :])
            elif cfg.variant == "mind":
                caps = recsys.mind_interests(params, user_batch["history"], cfg)
                scores = recsys.score_block_multi_interest(
                    caps, recsys._rows(params["items"], cand))
            else:
                q = recsys.user_query_vector(params, user_batch, cfg)
                scores = recsys.score_block_dot(q, recsys._rows(params["items"], cand))
            state = topk.topk_dense(scores, min(k, scores.shape[-1]))
            return topk.TopKState(state.scores, state.ids + idx * n_loc)

        return _over_mesh(mesh, rules, local)

    user_abs = {kk: v for kk, v in batch_abs.items() if kk != "cand_ids"}
    return Cell(arch, shape_name, retrieve, (abstract(pshapes), user_abs, batch_abs["cand_ids"]),
                (pspecs, {kk: () for kk in user_abs}, every))


# ---------------------------------------------------------------------------
# MIREX cells (the paper's system itself)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _mirex_cell(arch: str, shape_name: str, mesh: Mesh, rules: AxisRules) -> Cell:
    cfg: MirexConfig = get_config(arch)
    spec = shapes_for(arch)[shape_name]
    batch_abs = input_specs(arch, shape_name)
    every = (rules.all_axes,)
    n_loc = spec.dims["n_docs"] // _size(mesh, rules.all_axes)

    if spec.kind == "scan":
        scorer = scoring.get_scorer(cfg.scorer)
        stats_abs = scoring.CollectionStats(
            cf=_meta((cfg.vocab,), torch.int32), df=_meta((cfg.vocab,), torch.int32),
            total_terms=_meta((), torch.int32), n_docs=_meta((), torch.int32),
            avg_doc_len=_meta((), torch.float32))
        n_q = spec.dims["n_queries"]
        q_chunk = min(n_q, 512)  # the reference's query blocks
        lex_chunk = min(1024, n_loc)

        def scan(q_tokens, d_tokens, d_len, stats):
            def local(idx):
                docs = (d_tokens[idx * n_loc:(idx + 1) * n_loc],
                        d_len[idx * n_loc:(idx + 1) * n_loc])
                states = [search_local(q_tokens[a:a + q_chunk], docs, scorer, k=cfg.k,
                                       chunk_size=lex_chunk, stats=stats,
                                       doc_id_offset=idx * n_loc)
                          for a in range(0, n_q, q_chunk)]
                return topk.TopKState(torch.cat([st.scores for st in states]),
                                      torch.cat([st.ids for st in states]))

            return _over_mesh(mesh, rules, local)

        return Cell(arch, shape_name, scan,
                    (batch_abs["q_tokens"], batch_abs["d_tokens"], batch_abs["d_len"], stats_abs),
                    ((), every, every, scoring.CollectionStats(*((),) * 5)))

    # dense_scan
    def dense(q_vecs, d_vecs):
        def local(idx):
            return search_local(q_vecs, d_vecs[idx * n_loc:(idx + 1) * n_loc],
                                scoring.get_scorer("dense_dot"), k=cfg.k,
                                chunk_size=min(cfg.chunk_size, n_loc), doc_id_offset=idx * n_loc)

        return _over_mesh(mesh, rules, local)

    return Cell(arch, shape_name, dense, (batch_abs["q_vecs"], batch_abs["d_vecs"]),
                ((), every))


# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh: Mesh) -> Cell:
    rules = rules_for_mesh(mesh)
    cfg = get_config(arch)
    if isinstance(cfg, TransformerConfig):
        return _lm_cell(arch, shape_name, mesh, rules)
    if isinstance(cfg, GNNConfig):
        return _gnn_cell(arch, shape_name, mesh, rules)
    if isinstance(cfg, RecsysConfig):
        return _recsys_cell(arch, shape_name, mesh, rules)
    return _mirex_cell(arch, shape_name, mesh, rules)
