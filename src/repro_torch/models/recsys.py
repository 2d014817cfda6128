"""RecSys models: DCN-v2, FM, MIND, SASRec — sparse tables + interactions
(the port's copy of `repro.models.recsys`).

* **FM** — pairwise ⟨vᵢ,vⱼ⟩xᵢxⱼ via the O(nk) sum-square trick.
* **DCN-v2** — cross layers ``x_{l+1} = x₀ ⊙ (W xₗ + b) + xₗ``, then an MLP.
* **MIND** — multi-interest capsule routing (B2I dynamic routing); serving
  scores a candidate with the max over interests.
* **SASRec** — causal self-attention over the item history.

Retrieval is the MIREX scan: the candidates are the corpus and the user's
representation the query (:func:`user_query_vector`; the ``score_block_*``
functions score a block of candidates).

Parameters are a dict of tensors in the reference's tree. ``init_params``
draws from a ``torch.Generator``, so its numbers are not the reference's
(`repro_torch.convert.tree_from_numpy` carries the reference's own across).
Lookups follow JAX's indexing (`embedding.jax_index`): the history gathers
clip at 0 as the reference's do, and an id past the end of a table reads
its last row, with no gradient where the id lies outside ``[-n, n)`` (the
reference's gather drops it in the transpose). ``param_specs`` gives the
reference's sharding specs as tuples (every table replicated).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.distributed.sharding import replicated_specs
from repro_torch.models.common import init_dense
from repro_torch.models.embedding import field_embed, jax_index, outside_without_grad
from repro_torch.models.transformer import ParamSpec


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: RecsysConfig) -> dict:
    dt = getattr(torch, cfg.dtype)

    def s(*shape):
        return ParamSpec(shape, dt)

    d = cfg.embed_dim
    if cfg.variant == "fm":
        return {
            "tables": s(cfg.n_sparse, cfg.vocab_per_field, d),
            "linear": s(cfg.n_sparse, cfg.vocab_per_field),
            "bias": s(),
        }
    if cfg.variant == "dcn-v2":
        x0 = cfg.n_dense + cfg.n_sparse * d
        p = {
            "tables": s(cfg.n_sparse, cfg.vocab_per_field, d),
            "cross_w": s(cfg.n_cross_layers, x0, x0),
            "cross_b": s(cfg.n_cross_layers, x0),
        }
        dims = (x0, *cfg.mlp_dims)
        for i in range(len(cfg.mlp_dims)):
            p[f"mlp_w{i}"] = s(dims[i], dims[i + 1])
            p[f"mlp_b{i}"] = s(dims[i + 1])
        p["head_w"] = s(dims[-1], 1)
        p["head_b"] = s(1)
        return p
    if cfg.variant == "mind":
        return {
            "items": s(cfg.n_items, d),
            "bilinear": s(d, d),  # B2I routing map
            "out_w": s(d, d),
            "out_b": s(d),
        }
    if cfg.variant == "sasrec":
        hd = d
        return {
            "items": s(cfg.n_items, d),
            "pos": s(cfg.seq_len, d),
            "blocks": {
                "ln1": s(cfg.n_blocks, d),
                "wq": s(cfg.n_blocks, d, hd),
                "wk": s(cfg.n_blocks, d, hd),
                "wv": s(cfg.n_blocks, d, hd),
                "wo": s(cfg.n_blocks, hd, d),
                "ln2": s(cfg.n_blocks, d),
                "w1": s(cfg.n_blocks, d, 4 * d),
                "b1": s(cfg.n_blocks, 4 * d),
                "w2": s(cfg.n_blocks, 4 * d, d),
                "b2": s(cfg.n_blocks, d),
            },
            "ln_f": s(d),
        }
    raise ValueError(cfg.variant)


def init_params(cfg: RecsysConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Seeded init, as the reference's: matrices normal with std 0.05,
    vectors 0, SASRec's norm scales 1. Drawn on ``device`` from
    ``generator`` (which lives there; seed 0 when None), leaf by leaf in
    the reference's tree order."""
    device = torch.device("cpu" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if len(tree.shape) >= 2:
            return init_dense(generator, tree.shape, tree.dtype, scale=0.05, device=device)
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)

    params = build(param_shapes(cfg))
    if cfg.variant == "sasrec":
        for n in ("ln1", "ln2"):
            params["blocks"][n] = torch.ones_like(params["blocks"][n])
        params["ln_f"] = torch.ones_like(params["ln_f"])
    return params


def param_specs(cfg: RecsysConfig, rules) -> dict:
    """The reference's baseline: every table replicated (they fit: at most
    1.7 GB); the batch goes over the whole mesh."""
    del rules
    return replicated_specs(param_shapes(cfg))


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _rms(x, w):
    v = torch.mean(torch.square(x.float()), -1, keepdim=True)
    return (x.float() * torch.rsqrt(v + 1e-6) * w).to(x.dtype)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as JAX indexes it (wrap negatives once, clamp; an id
    outside ``[-n, n)`` passes no gradient)."""
    ids, n = ids.long(), table.shape[0]
    return outside_without_grad(F.embedding(jax_index(ids, n), table), ids, n, table)


def fm_forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """FM with the sum-square trick: O(F·d) per example. Returns logits [B]."""
    ids = batch["sparse_ids"]  # [B, F]
    e = field_embed(params["tables"], ids)  # [B, F, d]
    lin = field_embed(params["linear"][..., None], ids)[..., 0].sum(-1)  # [B]
    s1 = e.sum(1)  # [B, d]
    s2 = (e * e).sum(1)
    pair = 0.5 * (s1 * s1 - s2).sum(-1)
    return params["bias"] + lin + pair


def dcn_forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    e = field_embed(params["tables"], batch["sparse_ids"])  # [B, F, d]
    b = e.shape[0]
    x0 = torch.cat([batch["dense"], e.reshape(b, -1)], dim=-1)
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * (x @ params["cross_w"][i] + params["cross_b"][i]) + x
    for i in range(len(cfg.mlp_dims)):
        x = torch.relu(x @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"])
    return (x @ params["head_w"] + params["head_b"])[:, 0]


def mind_interests(params, history, cfg: RecsysConfig) -> torch.Tensor:
    """B2I dynamic routing -> interest capsules [B, n_interests, d]. (The
    reference also computes a summed bag of the history that it never
    reads; it is left out.)"""
    mask = history > 0
    e = _rows(params["items"], torch.clamp(history, min=0)) * mask[..., None]  # [B, L, d]
    u_hat = e @ params["bilinear"]  # [B, L, d]
    b_logit = torch.zeros((*history.shape, cfg.n_interests), dtype=torch.float32,
                          device=history.device)  # [B, L, I]

    def squash(v):
        n2 = torch.sum(torch.square(v), -1, keepdim=True)
        return v * (n2 / (1.0 + n2)) / torch.sqrt(n2 + 1e-9)

    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_logit, dim=-1) * mask[..., None]  # [B, L, I]
        z = torch.einsum("bli,bld->bid", w, u_hat)
        caps = squash(z)  # [B, I, d]
        b_logit = b_logit + torch.einsum("bid,bld->bli", caps, u_hat)
    return torch.relu(caps @ params["out_w"] + params["out_b"])


def mind_train_logits(params, batch, cfg: RecsysConfig):
    """Label-aware attention over interests vs the target item (training)."""
    caps = mind_interests(params, batch["history"], cfg)  # [B, I, d]
    tgt = _rows(params["items"], batch["target"][:, -1])  # [B, d]
    att = torch.softmax(torch.einsum("bid,bd->bi", caps, tgt) * 2.0, dim=-1)
    user = torch.einsum("bi,bid->bd", att, caps)
    return user, tgt


def sasrec_forward(params, history, cfg: RecsysConfig) -> torch.Tensor:
    """history [B, S] -> hidden states [B, S, d] (causal)."""
    b, s = history.shape
    d = cfg.embed_dim
    x = _rows(params["items"], torch.clamp(history, min=0)) + params["pos"][None, :s]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=history.device))
    for i in range(cfg.n_blocks):
        blk = {k: v[i] for k, v in params["blocks"].items()}
        y = _rms(x, blk["ln1"])
        q, k, v = y @ blk["wq"], y @ blk["wk"], y @ blk["wv"]
        a = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(d)
        a = torch.where(mask[None], a, torch.full((), -1e30, dtype=a.dtype, device=a.device))
        o = torch.einsum("bqk,bkd->bqd", torch.softmax(a, -1), v) @ blk["wo"]
        x = x + o
        y = _rms(x, blk["ln2"])
        x = x + torch.relu(y @ blk["w1"] + blk["b1"]) @ blk["w2"] + blk["b2"]
    return _rms(x, params["ln_f"])


# ---------------------------------------------------------------------------
# losses / steps
# ---------------------------------------------------------------------------

def bce_loss(logits, labels):
    logits = logits.float()
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def in_batch_softmax_loss(user, items):
    """user [B,d] vs items [B,d] (positives); in-batch negatives."""
    logits = user @ items.T / math.sqrt(user.shape[-1])
    logp = torch.log_softmax(logits.float(), -1)
    return -torch.mean(torch.diagonal(logp))


def train_logits(params, batch, cfg: RecsysConfig):
    """The variant's training loss (a 0-d float32 tensor)."""
    if cfg.variant == "fm":
        return bce_loss(fm_forward(params, batch, cfg), batch["labels"])
    if cfg.variant == "dcn-v2":
        return bce_loss(dcn_forward(params, batch, cfg), batch["labels"])
    if cfg.variant == "mind":
        user, tgt = mind_train_logits(params, batch, cfg)
        return in_batch_softmax_loss(user, tgt)
    if cfg.variant == "sasrec":
        h = sasrec_forward(params, batch["history"], cfg)
        target = batch["target"]
        pos = _rows(params["items"], target)
        # the reference's int32 arithmetic and floor modulo
        neg = _rows(params["items"], torch.remainder(target + 1_234_567, cfg.n_items))
        pos_lg = torch.einsum("bsd,bsd->bs", h, pos)
        neg_lg = torch.einsum("bsd,bsd->bs", h, neg)
        valid = batch["history"] > 0
        zero = torch.zeros((), dtype=pos_lg.dtype, device=pos_lg.device)
        return bce_loss(torch.where(valid, pos_lg, zero), valid.float()) + bce_loss(
            torch.where(valid, neg_lg, zero), torch.zeros_like(neg_lg))
    raise ValueError(cfg.variant)


# ---------------------------------------------------------------------------
# retrieval: per-variant score_block for the MIREX scan
# ---------------------------------------------------------------------------

def user_query_vector(params, batch, cfg: RecsysConfig):
    """Collapse the user side to the representation the scan scores against."""
    if cfg.variant == "fm":
        e = field_embed(params["tables"], batch["sparse_ids"])
        return e.sum(1)  # score(c) = const + lin_c + v_c · Σvᵢ  (linear!)
    if cfg.variant == "mind":
        return mind_interests(params, batch["history"], cfg)  # [B, I, d]
    if cfg.variant == "sasrec":
        return sasrec_forward(params, batch["history"], cfg)[:, -1]  # [B, d]
    raise ValueError(f"{cfg.variant} uses full-forward retrieval")


def score_block_dot(user_vec, cand_embeds):
    return torch.einsum("bd,nd->bn", user_vec, cand_embeds)


def score_block_multi_interest(user_caps, cand_embeds):
    """MIND serving: max over interest capsules [B,I,d] × [N,d] -> [B,N]."""
    s = torch.einsum("bid,nd->bin", user_caps, cand_embeds)
    return s.amax(dim=1)


def score_block_dcn(params, user_batch, cand_ids, cfg: RecsysConfig):
    """DCN retrieval: the full forward for each (user, candidate) of a block,
    the candidate id in the last sparse field; ``user_batch`` has batch 1."""
    n = cand_ids.shape[0]
    dense = user_batch["dense"].expand(n, user_batch["dense"].shape[-1])
    ids = user_batch["sparse_ids"].expand(n, user_batch["sparse_ids"].shape[-1]).clone()
    ids[:, -1] = cand_ids
    return dcn_forward(params, {"dense": dense, "sparse_ids": ids}, cfg)[None, :]
