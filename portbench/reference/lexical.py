"""Lexical retrieval by the book, in plain PyTorch.

* collection statistics: cf and df per term, total terms, documents, the
  mean length, counted in int64 (df from the distinct (document, term)
  pairs, not from sorted rows as the program does);
* term frequencies of the query terms, by a table from term to query-term
  column and one ``bincount`` per block of rows;
* Okapi BM25 and Hiemstra's query-likelihood model with a length prior,
  in float32 with each product and quotient rounded on its own and the
  terms added left to right;
* the top k of every (model, query) in the order (score desc, doc id asc),
  exact: a 64-bit key of the score's ordered bits and the complemented id.

``dtype`` is the scoring precision: float32 is the reference, bfloat16 the
control (the precision below the configuration's).
"""

from __future__ import annotations

import dataclasses

import torch

PAD = -1


@dataclasses.dataclass(frozen=True)
class Model:
    """``kind`` is ``"bm25"`` (``k1``, ``b``) or ``"ql"`` (``lam``,
    ``length_prior``)."""

    kind: str
    k1: float = 1.2
    b: float = 0.75
    lam: float = 0.15
    length_prior: bool = True


@dataclasses.dataclass(frozen=True)
class Stats:
    cf: torch.Tensor  # [vocab] int64
    df: torch.Tensor  # [vocab] int64
    total: int
    n_docs: int
    avg: torch.Tensor  # scalar, the scoring dtype


def collection_stats(tokens, lengths, vocab: int, *, block_rows: int = 1 << 19,
                     dtype=torch.float32) -> Stats:
    dev = tokens.device
    cf = torch.zeros(vocab, dtype=torch.int64, device=dev)
    df = torch.zeros(vocab, dtype=torch.int64, device=dev)
    for a in range(0, tokens.shape[0], block_rows):
        blk = tokens[a:a + block_rows]
        valid = blk != PAD
        terms = blk[valid].to(torch.int64)
        cf += torch.bincount(terms, minlength=vocab)
        rows = torch.nonzero(valid)[:, 0]
        pairs = torch.unique(rows * vocab + terms)
        df += torch.bincount(pairs % vocab, minlength=vocab)
    total = int(cf.sum())
    n_docs = int((lengths > 0).sum())
    avg = torch.tensor(total, dtype=dtype, device=dev) / torch.tensor(
        max(n_docs, 1), dtype=dtype, device=dev)
    return Stats(cf=cf, df=df, total=total, n_docs=n_docs, avg=avg)


def query_term_table(queries, vocab: int):
    """``(lut [vocab] int64, slot_u [Q, L] int64, U)``: ``lut[t]`` is term
    ``t``'s column among the U distinct query terms (-1 elsewhere); a PAD
    slot points at column U, which `term_counts` keeps at zero."""
    dev = queries.device
    q = queries.to(torch.int64)
    terms = torch.unique(q[q != PAD])
    lut = torch.full((vocab,), -1, dtype=torch.int64, device=dev)
    lut[terms] = torch.arange(terms.numel(), device=dev)
    slot_u = torch.where(q == PAD, terms.numel(), lut[q.clamp(min=0)])
    return lut, slot_u, int(terms.numel())


def term_counts(tok_block, lut, n_u: int):
    """``[B, U + 1]`` int64: how often each query term occurs in each row
    (the last column, for PAD slots, stays 0)."""
    b = tok_block.shape[0]
    col = torch.where(tok_block == PAD, -1, lut[tok_block.clamp(min=0).to(torch.int64)])
    rows, pos = torch.nonzero(col >= 0, as_tuple=True)
    keys = rows * (n_u + 1) + col[rows, pos]
    return torch.bincount(keys, minlength=b * (n_u + 1)).reshape(b, n_u + 1)


def _scalar(x: float, dtype, dev):
    return torch.tensor(x, dtype=torch.float32, device=dev).to(dtype)


def weights(model: Model, queries, st: Stats, dtype=torch.float32):
    """``(w [Q, L], alpha, beta)`` in ``dtype``; w is 0 on PAD slots and on
    terms the collection does not hold."""
    dev = queries.device
    q = queries.to(torch.int64)
    valid = q != PAD
    if model.kind == "ql":
        cf = st.cf[q.clamp(min=0)].to(torch.float32).to(dtype)
        total = _scalar(float(st.total), dtype, dev)
        w = (_scalar(model.lam, dtype, dev) * total) / (
            _scalar(1.0 - model.lam, dtype, dev) * torch.where(cf > 0, cf, 1.0))
        w = torch.where(valid & (cf > 0), w, 0.0)
        zero = _scalar(0.0, dtype, dev)
        return w, zero, zero
    if model.kind == "bm25":
        df = st.df[q.clamp(min=0)].to(torch.float32).to(dtype)
        n = _scalar(float(st.n_docs), dtype, dev)
        half = _scalar(0.5, dtype, dev)
        idf = torch.log1p((n - df + half) / (df + half))
        w = torch.where(valid & (df > 0), idf * _scalar(model.k1 + 1.0, dtype, dev), 0.0)
        alpha = _scalar(model.k1 * (1.0 - model.b), dtype, dev)
        beta = _scalar(model.k1 * model.b, dtype, dev) / st.avg.to(dtype)
        return w, alpha, beta
    raise ValueError(f"unknown model kind {model.kind!r}")


def score(model: Model, w, alpha, beta, tf, dlen, dtype=torch.float32):
    """Scores from per-slot weights and frequencies: ``w[l]`` and ``tf[l]``
    (one entry a query-term slot) broadcast against the lengths ``dlen``,
    e.g. ``[Q, 1]``, ``[Q, B]`` and ``[B]``; float32, -inf for empty rows."""
    d_raw = dlen.to(torch.float32).to(dtype)
    if model.kind == "ql":
        d = torch.clamp(d_raw, min=1.0)
        terms = [torch.log1p(wl * tl / d) for wl, tl in zip(w, tf)]
    else:
        norm = alpha + beta * d_raw
        terms = [wl * tl / (tl + norm) for wl, tl in zip(w, tf)]
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    if model.kind == "ql" and model.length_prior:
        s = s + torch.log(d)
    return torch.where(dlen > 0, s.to(torch.float32), float("-inf"))


def _keys(scores, ids):
    """(score desc, id asc) as one int64 key, larger first."""
    bits = (scores + 0.0).contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered << 32) | (0xFFFFFFFF - ids)


def _unkey(keys):
    ordered = keys >> 32
    bits = torch.where(ordered < 0, ordered ^ 0x7FFFFFFF, ordered).to(torch.int32)
    return bits.view(torch.float32), 0xFFFFFFFF - (keys & 0xFFFFFFFF)


def _block_rows(n_u: int) -> int:
    return max(1 << 12, min(1 << 17, (1 << 26) // (n_u + 1)))


def topk(tokens, lengths, queries, models, st: Stats, k: int, *, dtype=torch.float32):
    """``(scores float32 [M, Q, k], ids int64 [M, Q, k])``, best first;
    ``(-inf, -1)`` where a list has fewer than k documents."""
    dev = tokens.device
    n, n_q, n_m = tokens.shape[0], queries.shape[0], len(models)
    lut, slot_u, n_u = query_term_table(queries, st.cf.shape[0])
    ws = [weights(m, queries, st, dtype) for m in models]
    best = torch.empty((n_m * n_q, 0), dtype=torch.int64, device=dev)
    step = _block_rows(n_u)
    for a in range(0, n, step):
        b = min(n, a + step)
        cnt = term_counts(tokens[a:b], lut, n_u)
        tf = cnt[:, slot_u.reshape(-1)].reshape(b - a, n_q, -1).permute(1, 2, 0).to(dtype)
        s = torch.stack([score(m, w[:, :, None].unbind(1), al, be, tf.unbind(1), lengths[a:b], dtype)
                         for m, (w, al, be) in zip(models, ws)])
        keys = _keys(s.reshape(n_m * n_q, b - a),
                     torch.arange(a, b, dtype=torch.int64, device=dev))
        best = torch.cat([best, torch.topk(keys, min(k, b - a), dim=1).values], 1)
        best = torch.topk(best, min(k, best.shape[1]), dim=1).values
    s, ids = _unkey(best)
    s, ids = s.reshape(n_m, n_q, -1), ids.reshape(n_m, n_q, -1)
    if s.shape[-1] < k:
        pad = k - s.shape[-1]
        s = torch.cat([s, s.new_full((n_m, n_q, pad), float("-inf"))], -1)
        ids = torch.cat([ids, ids.new_full((n_m, n_q, pad), -1)], -1)
    ids = torch.where(s == float("-inf"), -1, ids)
    return s, ids


def score_docs(tokens, lengths, queries, models, st: Stats, ids, *, dtype=torch.float32,
               block: int = 1 << 16):
    """The reference's score of each listed document: ``ids [M, Q, K]``
    (-1 allowed) -> float32 ``[M, Q, K]``, -inf at -1. Counted directly,
    each row against its own query's terms."""
    dev = tokens.device
    n_m, n_q, kk = ids.shape
    out = torch.full((n_m, n_q, kk), float("-inf"), dtype=torch.float32, device=dev)
    qterm = torch.where(queries == PAD, PAD - 1, queries).to(tokens.dtype)  # PAD matches nothing
    for m, model in enumerate(models):
        w, alpha, beta = weights(model, queries, st, dtype)
        flat = ids[m].reshape(-1)
        qidx = torch.arange(n_q, device=dev).repeat_interleave(kk)
        res = torch.full((flat.numel(),), float("-inf"), dtype=torch.float32, device=dev)
        for a in range(0, flat.numel(), block):
            d = flat[a:a + block]
            q = qidx[a:a + block]
            rows = tokens[d.clamp(min=0)]  # [b, width]
            tf = (rows[:, None, :] == qterm[q][:, :, None]).sum(-1).to(dtype)  # [b, L]
            s = score(model, w[q].unbind(1), alpha, beta, tf.unbind(1),
                      lengths[d.clamp(min=0)], dtype)
            res[a:a + block] = torch.where(d >= 0, s, float("-inf"))
        out[m] = res.reshape(n_q, kk)
    return out
