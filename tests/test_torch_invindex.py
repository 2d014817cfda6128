"""The inverted-index baseline of the port against the JAX reference, and
the scan against the index, on the CPU.

`invindex` is a host numpy job in both packages: the port's index arrays,
statistics and answers must be the reference's byte for byte (tolerance:
none). The scan (the lexical kernel's plain version) must equal the index
as the reference's own test holds them (``tests/test_scoring.py``): scores
within rtol = atol = 3e-5, ids by `_torch_parity.assert_rankings_close` at
that tolerance (the index's tie order comes from ``argpartition``). A scan
under the index's statistics must give the bits of a scan under the
statistics job's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro.core import anchors as ref_anchors
from repro.core import invindex as ref_invindex
from repro.data import synthetic as ref_synthetic
from repro_torch.core import anchors, invindex, scan, scoring
from repro_torch.data import synthetic

VOCAB = 500
TOL = 3e-5
DEEPER = 8


@pytest.fixture(scope="module")
def corpus():
    return synthetic.make_corpus(n_docs=256, vocab=VOCAB, max_len=24, seed=3)


@pytest.fixture(scope="module")
def both_indexes(corpus):
    return (invindex.build_index(corpus.tokens, corpus.lengths, vocab=VOCAB),
            ref_invindex.build_index(corpus.tokens, corpus.lengths, vocab=VOCAB))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_build_index_is_the_references(corpus, both_indexes):
    idx, ref = both_indexes
    for field in ("offsets", "doc_ids", "tfs", "doc_len"):
        _same(getattr(idx, field), getattr(ref, field))
    assert (idx.n_docs, idx.vocab, idx.nnz) == (ref.n_docs, ref.vocab, ref.nnz)
    # zero-length rows keep a length of 1, as there
    lens = corpus.lengths.copy()
    lens[:3] = 0
    _same(invindex.build_index(corpus.tokens, lens, VOCAB).doc_len,
          ref_invindex.build_index(corpus.tokens, lens, VOCAB).doc_len)


def test_stats_from_index_is_the_references(both_indexes):
    idx, ref = both_indexes
    got, want = invindex.stats_from_index(idx), ref_invindex.stats_from_index(ref)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        _same(g.numpy(), np.asarray(w))
    assert got.total_terms.dtype == torch.int64


@pytest.mark.parametrize("scorer", ["ql_lm", "bm25"])
@pytest.mark.parametrize("params", [{}, {"lam": 0.4, "k1": 0.9, "b": 0.4}])
def test_search_is_the_references(corpus, both_indexes, scorer, params):
    idx, ref = both_indexes
    queries = synthetic.make_queries(corpus, n_queries=12, seed=4)
    got = invindex.search(idx, queries, invindex.stats_from_index(idx), k=8, scorer=scorer,
                          **params)
    want = ref_invindex.search(ref, queries, ref_invindex.stats_from_index(ref), k=8,
                               scorer=scorer, **params)
    for g, w in zip(got, want):
        _same(g, w)
    # statistics from the port's job (torch tensors) and queries as a tensor
    jstats = anchors.collection_stats(torch.as_tensor(corpus.tokens),
                                      torch.as_tensor(corpus.lengths), vocab=VOCAB,
                                      chunk_size=64)
    rstats = ref_anchors.collection_stats(jnp.asarray(corpus.tokens),
                                          jnp.asarray(corpus.lengths), vocab=VOCAB,
                                          chunk_size=64)
    got = invindex.search(idx, torch.as_tensor(queries), jstats, k=8, scorer=scorer, **params)
    want = ref_invindex.search(ref, queries, rstats, k=8, scorer=scorer, **params)
    for g, w in zip(got, want):
        _same(g, w)


def test_search_refuses_other_scorers(both_indexes):
    idx, _ = both_indexes
    q = np.array([[1, 2, -1, -1]], np.int32)
    with pytest.raises(ValueError, match="does not implement 'tfidf'"):
        invindex.search(idx, q, invindex.stats_from_index(idx), k=4, scorer="tfidf")


def test_stats_job_matches_index(corpus, both_indexes):
    idx, _ = both_indexes
    istats = invindex.stats_from_index(idx)
    jstats = anchors.collection_stats(torch.as_tensor(corpus.tokens),
                                      torch.as_tensor(corpus.lengths), vocab=VOCAB,
                                      chunk_size=64)
    assert torch.equal(jstats.cf, istats.cf) and torch.equal(jstats.df, istats.df)
    assert int(jstats.total_terms) == int(istats.total_terms)
    assert int(jstats.n_docs) == int(istats.n_docs)


@pytest.mark.parametrize("scorer", ["ql_lm", "bm25"])
def test_scan_under_index_stats_is_the_scan_under_job_stats(corpus, both_indexes, scorer):
    """The index's ``total_terms`` is int64 and the job's int32, and the
    index divides for ``avg_doc_len`` in float64 where the job does in
    float32: the scan casts both to the same float32 scalars here."""
    idx, _ = both_indexes
    docs = (torch.as_tensor(corpus.tokens), torch.as_tensor(corpus.lengths))
    jstats = anchors.collection_stats(*docs, vocab=VOCAB, chunk_size=64)
    istats = invindex.stats_from_index(idx)
    q = torch.as_tensor(synthetic.make_queries(corpus, n_queries=12, seed=4))
    a, b = (scan.search_local(q, docs, scoring.get_scorer(scorer), k=8, chunk_size=64, stats=s)
            for s in (istats, jstats))
    assert a.scores.numpy().tobytes() == b.scores.numpy().tobytes()
    assert torch.equal(a.ids, b.ids)


@pytest.mark.parametrize("scorer", ["ql_lm", "bm25"])
@pytest.mark.parametrize("n_docs, max_len, k", [(256, 24, 8), (2048, 48, 10), (4096, 64, 100)])
def test_scan_equals_index(scorer, n_docs, max_len, k):
    """The whole-engine oracle: the scan's ranking is the index's within
    3e-5 (ids by the near-tie rule, the index ranked 8 places deeper)."""
    vocab = 4096 if n_docs > 256 else VOCAB
    corpus = synthetic.make_corpus(n_docs=n_docs, vocab=vocab, max_len=max_len, seed=5)
    idx = invindex.build_index(corpus.tokens, corpus.lengths, vocab=vocab)
    istats = invindex.stats_from_index(idx)
    queries = synthetic.make_queries(corpus, n_queries=16, seed=6)
    state = scan.search_local(
        torch.as_tensor(queries), (torch.as_tensor(corpus.tokens),
                                   torch.as_tensor(corpus.lengths)),
        scoring.get_scorer(scorer), k=k, chunk_size=256 if n_docs > 256 else 64, stats=istats,
    )
    want_s, want_i = invindex.search(idx, queries, istats, k=k + DEEPER, scorer=scorer)
    assert_rankings_close(state.scores.numpy(), state.ids.numpy(), want_s, want_i,
                          what=scorer, tol=TOL)
    # the reference's own corpus generator, byte for byte the port's
    ref_corpus = ref_synthetic.make_corpus(n_docs=n_docs, vocab=vocab, max_len=max_len, seed=5)
    assert ref_corpus.tokens.tobytes() == corpus.tokens.tobytes()
