"""The plain reference against values worked by hand on a tiny corpus."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import lexical as ref

P = ref.PAD
# 4 documents over a vocabulary of 6
TOKENS = torch.tensor([[0, 1, 1, P], [2, 3, P, P], [1, 4, 5, 1], [0, 0, 0, 0]],
                      dtype=torch.int32)
LENGTHS = torch.tensor([3, 2, 4, 4], dtype=torch.int32)
QUERIES = torch.tensor([[1, P], [0, 5]], dtype=torch.int32)


def test_collection_stats_by_hand():
    st = ref.collection_stats(TOKENS, LENGTHS, 6, block_rows=3)
    assert st.cf.tolist() == [5, 4, 1, 1, 1, 1]
    assert st.df.tolist() == [2, 2, 1, 1, 1, 1]
    assert (st.total, st.n_docs) == (13, 4) and float(st.avg) == np.float32(13 / 4)


def test_query_likelihood_by_hand():
    st = ref.collection_stats(TOKENS, LENGTHS, 6)
    m = ref.Model("ql", lam=0.15, length_prior=True)
    s, ids = ref.topk(TOKENS, LENGTHS, QUERIES, [m], st, 4)
    w1 = 0.15 * 13 / (0.85 * 4)  # term 1: cf 4
    want0 = {0: math.log1p(w1 * 2 / 3) + math.log(3), 2: math.log1p(w1 * 2 / 4) + math.log(4),
             1: math.log(2), 3: math.log(4)}
    order = sorted(want0, key=lambda d: (-want0[d], d))
    assert ids[0, 0].tolist() == order
    np.testing.assert_allclose(s[0, 0].numpy(), [want0[d] for d in order], rtol=1e-6)


def test_bm25_by_hand_and_ties_by_id():
    st = ref.collection_stats(TOKENS, LENGTHS, 6)
    m = ref.Model("bm25", k1=1.2, b=0.75)
    s, ids = ref.topk(TOKENS, LENGTHS, QUERIES, [m], st, 4)
    avg = 13 / 4

    def part(df, tf, dl):
        idf = math.log1p((4 - df + 0.5) / (df + 0.5))
        return idf * 2.2 * tf / (tf + 1.2 * 0.25 + 1.2 * 0.75 / avg * dl)

    want1 = {0: part(2, 1, 3), 1: 0.0, 2: part(1, 1, 4), 3: part(2, 4, 4)}
    order = sorted(want1, key=lambda d: (-want1[d], d))
    assert ids[0, 1].tolist() == order
    np.testing.assert_allclose(s[0, 1].numpy(), [want1[d] for d in order], rtol=1e-6)
    # query 0 scores documents 1 and 3 zero: the tie goes to the lower id
    assert ids[0, 0].tolist()[-2:] == [1, 3]


def test_topk_pads_a_short_list_and_scores_listed_docs():
    st = ref.collection_stats(TOKENS, LENGTHS, 6)
    m = ref.Model("ql")
    s, ids = ref.topk(TOKENS, LENGTHS, QUERIES, [m], st, 6)
    assert ids[0, 0, 4:].tolist() == [-1, -1] and torch.isinf(s[0, 0, 4:]).all()
    again = ref.score_docs(TOKENS, LENGTHS, QUERIES, [m], st, ids)
    assert torch.equal(again, s)


def test_blocks_do_not_change_the_answer():
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 50, (3000, 12), generator=g, dtype=torch.int32)
    lengths = torch.randint(1, 13, (3000,), generator=g, dtype=torch.int32)
    tokens = torch.where(torch.arange(12) < lengths[:, None], tokens, P)
    queries = tokens[:20, :3].clone()
    st = ref.collection_stats(tokens, lengths, 50, block_rows=700)
    models = [ref.Model("bm25", k1=0.9, b=0.4), ref.Model("ql")]
    s, ids = ref.topk(tokens, lengths, queries, models, st, 100)
    full = torch.stack([ref.score_docs(tokens, lengths, queries, [m], st,
                                       torch.arange(3000).expand(1, 20, 3000))[0]
                        for m in models])
    key = torch.sort(full, dim=-1, descending=True, stable=True)  # ties keep id order
    np.testing.assert_array_equal(s.numpy(), key.values[..., :100].numpy())
    assert torch.equal(ids, key.indices[..., :100])
    assert torch.equal(ref.score_docs(tokens, lengths, queries, models, st, ids), s)

