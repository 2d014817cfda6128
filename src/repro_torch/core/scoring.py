"""Pluggable scoring functions — the paper's ``experimental_score``, on torch.

A scorer is a blocked function ``score_block(query_block, doc_block) ->
scores [n_q, n_d]``. Every lexical scorer decomposes into the shared
term-frequency reduction (:func:`term_frequencies`) plus a declarative
epilogue (`EpilogueMode` + `LexicalEpilogue`, applied by
:func:`apply_epilogue`): the contract the CUDA lexical-scan kernel
(`repro_torch.kernels.lexical_scan`) computes, and what lets one kernel pass
score a whole model grid.

The default lexical scorer is the paper's own: Hiemstra's query-likelihood
language model with a document-length prior:

    score(q, d) = log |d| + sum_{t in q} log(1 + lam * tf(t,d) * |C|
                                                / ((1-lam) * cf(t) * |d|))

Float32 cast points follow the JAX reference (`repro.core.scoring`) one for
one: a Python float meets a float32 tensor as a float32 scalar, and products
of Python floats (``k1 * b``) are formed in double before the cast.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

PAD_TOKEN = -1


class CollectionStats(NamedTuple):
    """Corpus-wide statistics (output of the stats MapReduce job)."""

    cf: torch.Tensor  # [vocab] int32 collection term frequency
    df: torch.Tensor  # [vocab] int32 document frequency
    total_terms: torch.Tensor  # int32 scalar: |C|
    n_docs: torch.Tensor  # int32 scalar
    avg_doc_len: torch.Tensor  # float32 scalar


def safe_queries(q_tokens: torch.Tensor) -> torch.Tensor:
    """Query pads -> ``PAD_TOKEN - 1``, a token that matches nothing (doc pads
    are PAD_TOKEN, real tokens >= 0), replacing the doc-side validity mask."""
    return torch.where(q_tokens == PAD_TOKEN, PAD_TOKEN - 1, q_tokens)


def term_frequencies(
    q_tokens: torch.Tensor, d_tokens: torch.Tensor, *, tile_d: int = 16
) -> torch.Tensor:
    """tf[q, t, d] of each query term in each doc, from raw token ids.

    ``q_tokens [n_q, L_q]``, ``d_tokens [n_d, L_d]`` (PAD_TOKEN-padded) ->
    ``tf [n_q, L_q, n_d]`` float32. The reduction over ``L_d`` runs in
    ``tile_d``-wide steps into an int32 accumulator, so the live intermediate
    is ``[n_q, L_q, n_d, tile_d]`` and the rank-4 cross-product over the whole
    ``L_d`` never exists.
    """
    q_safe = safe_queries(q_tokens)
    n_d, l_d = d_tokens.shape
    acc = torch.zeros((*q_tokens.shape, n_d), dtype=torch.int32, device=d_tokens.device)
    for t0 in range(0, l_d, tile_d):
        tile = d_tokens[:, t0 : t0 + tile_d]  # a short last tile = PAD columns
        eq = q_safe[:, :, None, None] == tile[None, None, :, :]
        acc += eq.sum(dim=-1, dtype=torch.int32)
    return acc.to(torch.float32)


def term_frequencies_dense(q_tokens: torch.Tensor, d_tokens: torch.Tensor) -> torch.Tensor:
    """Rank-4 form of :func:`term_frequencies`, kept as the parity oracle —
    materializes the full ``[n_q, L_q, n_d, L_d]`` equality cross-product."""
    eq = q_tokens[:, :, None, None] == d_tokens[None, None, :, :]
    valid_d = (d_tokens != PAD_TOKEN)[None, None, :, :]
    return (eq & valid_d).sum(dim=-1).to(torch.float32)


# --------------------------------------------------------------- epilogues


@dataclasses.dataclass(frozen=True)
class EpilogueMode:
    """Static (hashable) half of a lexical scorer's epilogue spec.

    ``mode`` picks the per-term transform of ``(weights w, tf, doc len)``:

    * ``"ql"``    — ``log1p(w * tf / |d|)``  (Hiemstra's log-odds)
    * ``"bm25"``  — ``w * tf / (tf + alpha + beta * |d|)``  (BM25 saturation)
    * ``"tfidf"`` — ``w * log1p(tf)``

    ``length_prior`` adds ``log |d|`` (QL LM document prior);
    ``length_norm="rsqrt"`` divides the summed score by ``sqrt(|d|)``.
    """

    mode: str  # "ql" | "bm25" | "tfidf"
    length_prior: bool = False
    length_norm: str = "none"  # "none" | "rsqrt"


class LexicalEpilogue(NamedTuple):
    """Tensor half of the epilogue spec (per model in a grid).

    ``weights [n_q, L_q]`` fold the collection statistics and the query
    validity mask into one per-term table (zero for PAD / zero-frequency
    terms); ``alpha``/``beta`` are the BM25 doc-length normalization
    ``tf + alpha + beta*|d|`` (zero scalars for the other modes).
    """

    weights: torch.Tensor  # [n_q, L_q] float32
    alpha: torch.Tensor  # float32 scalar
    beta: torch.Tensor  # float32 scalar


def apply_epilogue(
    mode: EpilogueMode, ep: LexicalEpilogue, tf: torch.Tensor, d_len: torch.Tensor
) -> torch.Tensor:
    """Score a block from its term frequencies: ``[n_q, L_q, n_d] -> [n_q, n_d]``.

    The CUDA kernel evaluates exactly these float32 operations in exactly
    this order, so the two agree bit for bit on the card: each product and
    quotient rounds on its own (the kernel is built without FMA
    contraction), and the sum over ``L_q`` runs l = 0, 1, 2, ... as written
    out below, never through ``torch.sum``.
    """
    d_len_f = torch.clamp(d_len.to(torch.float32), min=1.0)  # [n_d]
    w = ep.weights[:, :, None]  # [n_q, L_q, 1]
    if mode.mode == "ql":
        per_term = torch.log1p(w * tf / d_len_f[None, None, :])
    elif mode.mode == "bm25":
        norm = ep.alpha + ep.beta * d_len.to(torch.float32)
        per_term = w * tf / (tf + norm[None, None, :])
    elif mode.mode == "tfidf":
        per_term = w * torch.log1p(tf)
    else:
        raise ValueError(f"unknown epilogue mode {mode.mode!r}")
    if per_term.shape[1] == 0:
        score = per_term.new_zeros((per_term.shape[0], per_term.shape[2]))
    else:
        score = per_term[:, 0, :]
        for l in range(1, per_term.shape[1]):
            score = score + per_term[:, l, :]
    if mode.length_prior:
        score = score + torch.log(d_len_f)[None, :]
    if mode.length_norm == "rsqrt":
        score = score / torch.sqrt(d_len_f)[None, :]
    # padded corpus rows (len 0) must never enter the top-k
    return torch.where((d_len > 0)[None, :], score, float("-inf"))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 scalar tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _lookup(table: torch.Tensor, q_tokens: torch.Tensor) -> torch.Tensor:
    return table[torch.clamp(q_tokens, min=0).long()].to(torch.float32)


def ql_lm_epilogue(
    q_tokens: torch.Tensor,
    stats: CollectionStats,
    *,
    lam: float = 0.15,
    length_prior: bool = True,
) -> tuple[EpilogueMode, LexicalEpilogue]:
    """Hiemstra QL LM: ``w = lam * |C| / ((1-lam) * cf)`` per valid term."""
    cf = _lookup(stats.cf, q_tokens)
    q_valid = (q_tokens != PAD_TOKEN) & (cf > 0)
    safe_cf = torch.where(cf > 0, cf, 1.0)
    total = stats.total_terms.to(torch.float32)
    w = (_f32(lam, cf) * total) / (_f32(1.0 - lam, cf) * safe_cf)
    w = torch.where(q_valid, w, 0.0)
    zero = _f32(0.0, cf)
    return EpilogueMode("ql", length_prior=length_prior), LexicalEpilogue(w, zero, zero)


def bm25_epilogue(
    q_tokens: torch.Tensor,
    stats: CollectionStats,
    *,
    k1: float = 1.2,
    b: float = 0.75,
) -> tuple[EpilogueMode, LexicalEpilogue]:
    """Okapi BM25: ``w = idf * (k1+1)``, saturation ``tf + k1(1-b) + (k1 b/avgdl)|d|``."""
    df = _lookup(stats.df, q_tokens)
    n = stats.n_docs.to(torch.float32)
    half = _f32(0.5, df)
    idf = torch.log1p((n - df + half) / (df + half))
    q_valid = (q_tokens != PAD_TOKEN) & (df > 0)
    w = torch.where(q_valid, idf * _f32(k1 + 1.0, df), 0.0)
    avgdl = stats.avg_doc_len.to(torch.float32)
    return EpilogueMode("bm25"), LexicalEpilogue(
        w, _f32(k1 * (1.0 - b), df), _f32(k1 * b, df) / avgdl
    )


def tfidf_epilogue(
    q_tokens: torch.Tensor, stats: CollectionStats
) -> tuple[EpilogueMode, LexicalEpilogue]:
    """ltc tf-idf: ``w = idf``, score scaled by ``1/sqrt(|d|)``."""
    df = _lookup(stats.df, q_tokens)
    n = stats.n_docs.to(torch.float32)
    one = _f32(1.0, df)
    idf = torch.log((n + one) / (df + one))
    q_valid = (q_tokens != PAD_TOKEN) & (df > 0)
    w = torch.where(q_valid, idf, 0.0)
    zero = _f32(0.0, df)
    return EpilogueMode("tfidf", length_norm="rsqrt"), LexicalEpilogue(w, zero, zero)


def hiemstra_lm(q_tokens, d_tokens, d_len, stats, *, lam: float = 0.15,
                length_prior: bool = True, tf: torch.Tensor | None = None):
    """The paper's scorer: query-likelihood LM with length prior."""
    if tf is None:
        tf = term_frequencies(q_tokens, d_tokens)
    mode, ep = ql_lm_epilogue(q_tokens, stats, lam=lam, length_prior=length_prior)
    return apply_epilogue(mode, ep, tf, d_len)


def bm25(q_tokens, d_tokens, d_len, stats, *, k1: float = 1.2, b: float = 0.75,
         tf: torch.Tensor | None = None):
    """Okapi BM25 over the raw-token scan."""
    if tf is None:
        tf = term_frequencies(q_tokens, d_tokens)
    mode, ep = bm25_epilogue(q_tokens, stats, k1=k1, b=b)
    return apply_epilogue(mode, ep, tf, d_len)


def tfidf(q_tokens, d_tokens, d_len, stats, *, tf: torch.Tensor | None = None):
    """Plain ltc-style tf-idf, length-normalized."""
    if tf is None:
        tf = term_frequencies(q_tokens, d_tokens)
    mode, ep = tfidf_epilogue(q_tokens, stats)
    return apply_epilogue(mode, ep, tf, d_len)


def dense_dot(q_vecs: torch.Tensor, d_vecs: torch.Tensor) -> torch.Tensor:
    """Dense inner-product block score, accumulated in float32 (the
    reference's ``dot_general`` with ``preferred_element_type=float32``)."""
    return q_vecs.to(torch.float32) @ d_vecs.to(torch.float32).T


def normalize_rows(vecs: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Each row over its L2 norm plus ``eps``, in float32: the row map of
    :func:`dense_cosine`. Rows are mapped independently, so mapping a whole
    corpus once gives the bits that mapping it chunk by chunk gives."""
    v = vecs.to(torch.float32)
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def dense_cosine(q_vecs: torch.Tensor, d_vecs: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return dense_dot(normalize_rows(q_vecs, eps), normalize_rows(d_vecs, eps))


@dataclasses.dataclass(frozen=True)
class Scorer:
    """A retrieval approach = kind + block function (+ params).

    ``params`` records keyword overrides bound onto ``fn`` (a grid point in
    an experiment); ``base`` names the unparameterized scorer it came from.
    ``epilogue`` is the lexical decomposition contract
    ``(q_tokens, stats) -> (EpilogueMode, LexicalEpilogue)``. ``row_map`` is
    the dense one: every dense scorer is the dot product of query and
    document rows after ``row_map`` (None: the rows as they are), which is
    what lets the dense kernel (`kernels.ops.score_topk`) score them all.
    """

    name: str
    kind: str  # "lexical" | "dense"
    fn: Callable
    base: str | None = None
    params: tuple[tuple[str, object], ...] = ()
    epilogue: Callable | None = None
    row_map: Callable | None = None

    def score_block(self, queries, doc_block, stats: CollectionStats | None = None,
                    *, tf: torch.Tensor | None = None):
        if self.kind == "lexical":
            d_tokens, d_len = doc_block
            if tf is not None:
                return self.fn(queries, d_tokens, d_len, stats, tf=tf)
            return self.fn(queries, d_tokens, d_len, stats)
        return self.fn(queries, doc_block)


SCORERS: dict[str, Scorer] = {
    "ql_lm": Scorer("ql_lm", "lexical", hiemstra_lm, epilogue=ql_lm_epilogue),
    "bm25": Scorer("bm25", "lexical", bm25, epilogue=bm25_epilogue),
    "tfidf": Scorer("tfidf", "lexical", tfidf, epilogue=tfidf_epilogue),
    "dense_dot": Scorer("dense_dot", "dense", dense_dot),
    "dense_cosine": Scorer("dense_cosine", "dense", dense_cosine, row_map=normalize_rows),
}


def get_scorer(name: str) -> Scorer:
    try:
        return SCORERS[name]
    except KeyError:
        raise KeyError(f"unknown scorer {name!r}; available: {sorted(SCORERS)}") from None


def make_variant(base: str, name: str | None = None, **params) -> Scorer:
    """A grid point: ``base`` scorer with keyword parameters bound.

    ``make_variant("bm25", k1=0.9, b=0.4)`` is a *new retrieval approach* in
    the paper's sense — same block contract, new model.
    """
    b = get_scorer(base)
    fn = functools.partial(b.fn, **params) if params else b.fn
    ep, rows = b.epilogue, b.row_map
    if params:  # fn, epilogue and row map share param names
        ep = functools.partial(ep, **params) if ep is not None else None
        rows = functools.partial(rows, **params) if rows is not None else None
    if name is None:
        name = base if not params else (
            base + "(" + ",".join(f"{k}={v}" for k, v in sorted(params.items())) + ")"
        )
    return Scorer(
        name, b.kind, fn, base=base, params=tuple(sorted(params.items())), epilogue=ep,
        row_map=rows,
    )


def lexical_epilogues(
    scorers: tuple[Scorer, ...] | list[Scorer],
    q_tokens: torch.Tensor,
    stats: CollectionStats,
) -> tuple[tuple[EpilogueMode, ...], torch.Tensor, torch.Tensor]:
    """Assemble a grid's epilogue specs for the lexical kernel.

    Returns ``(modes, weights [n_models, n_q, L_q], ab [n_models, 2])``.
    """
    modes, weights, ab = [], [], []
    for s in scorers:
        if s.kind != "lexical" or s.epilogue is None:
            raise ValueError(f"scorer {s.name!r} has no lexical epilogue")
        mode, ep = s.epilogue(q_tokens, stats)
        modes.append(mode)
        weights.append(ep.weights)
        ab.append(torch.stack([ep.alpha, ep.beta]))
    return tuple(modes), torch.stack(weights).contiguous(), torch.stack(ab).contiguous()
