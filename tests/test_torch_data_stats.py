"""The port's synthetic data and statistics job against the JAX reference.

The generators must be byte-identical for every seed (the port replays the
reference's numpy draws; only the row fill, the Zipf inversion and the qrels'
term counting are vectorized), and the statistics job is exact integers with
``avg_doc_len`` bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anchors as ref_anchors
from repro.data import synthetic as ref_synthetic
from repro_torch.core import anchors
from repro_torch.data import synthetic


@pytest.fixture()
def small_draw_chunk(monkeypatch):
    # several inversion chunks per corpus, so the chunked replay is exercised
    monkeypatch.setattr(synthetic, "_DRAW_CHUNK", 997)


@pytest.mark.parametrize("seed", [0, 1, 5, 11])
def test_corpus_queries_qrels_byte_identical(seed, small_draw_chunk):
    kw = dict(n_docs=300 + seed, vocab=257, max_len=20, min_len=3, seed=seed)
    want = ref_synthetic.make_corpus(**kw)
    got = synthetic.make_corpus(**kw)
    assert got.tokens.dtype == want.tokens.dtype and got.tokens.tobytes() == want.tokens.tobytes()
    assert got.lengths.tobytes() == want.lengths.tobytes()
    q_want = ref_synthetic.make_queries(want, n_queries=17, seed=seed + 1)
    q_got = synthetic.make_queries(got, n_queries=17, seed=seed + 1)
    assert q_got.tobytes() == q_want.tobytes()
    g_want = ref_synthetic.make_graded_qrels(want, q_want, per_query=25, seed=seed + 2)
    g_got = synthetic.make_graded_qrels(got, q_got, per_query=25, seed=seed + 2)
    assert g_got.dtype == g_want.dtype and g_got.tobytes() == g_want.tobytes()
    b_want = ref_synthetic.make_qrels(want, q_want, per_query=7, seed=seed + 2)
    b_got = synthetic.make_qrels(got, q_got, per_query=7, seed=seed + 2)
    assert b_got.tobytes() == b_want.tobytes()


def test_top_by_density_matches_argsort_with_ties():
    rng = np.random.default_rng(0)
    for _ in range(50):
        # a coarse palette forces exact ties: the full-sort branch must run
        dens = rng.integers(0, 4, size=200).astype(np.float64) / 4
        got = synthetic._top_by_density(dens, 10)
        np.testing.assert_array_equal(got, np.argsort(-dens)[:10])
        dens = rng.random(500)
        np.testing.assert_array_equal(
            synthetic._top_by_density(dens, 25), np.argsort(-dens)[:25]
        )
    np.testing.assert_array_equal(synthetic._top_by_density(np.ones(3), 5), [0, 1, 2])


@pytest.mark.parametrize("chunk", [32, 128, 384])
def test_collection_stats_exact(chunk):
    corpus = ref_synthetic.make_corpus(n_docs=384, vocab=500, max_len=24, seed=3)
    toks = corpus.tokens.copy()
    lens = corpus.lengths.copy()
    toks[-20:] = -1  # zero-length rows are not documents
    lens[-20:] = 0
    want = ref_anchors.collection_stats(
        jnp.asarray(toks), jnp.asarray(lens), vocab=500, chunk_size=chunk
    )
    got = anchors.collection_stats(
        torch.tensor(toks), torch.tensor(lens), vocab=500, chunk_size=chunk
    )
    for field in ("cf", "df", "total_terms", "n_docs", "avg_doc_len"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        assert g.tobytes() == w.tobytes(), field
    assert int(got.n_docs) == 364


def test_pipeline_helpers_match_reference():
    import jax.numpy as jnp

    from repro.core import pipeline as ref_pipeline
    from repro_torch.core import pipeline

    for n, chunk, per in [(512, 128, 2), (1024, 64, 3), (64, 64, 1)]:
        assert pipeline.segments(n, chunk, per) == ref_pipeline.segments(n, chunk, per)
        assert pipeline.num_chunks(n + 1, chunk) == ref_pipeline.num_chunks(n + 1, chunk)
    assert [pipeline.next_pow2(n) for n in range(9)] == [
        ref_pipeline.next_pow2(n) for n in range(9)
    ]
    toks = np.arange(12, dtype=np.int32).reshape(3, 4)
    lens = np.array([4, 2, 1], np.int32)
    want = ref_pipeline.pad_leading((jnp.asarray(toks), jnp.asarray(lens)), 5, (-1, 0))
    got = pipeline.pad_leading((torch.tensor(toks), torch.tensor(lens)), 5, (-1, 0))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    seen = pipeline.fold_chunks(
        (torch.tensor(toks), torch.tensor(lens)), 1, lambda s, c, start: s + [start], []
    )
    assert seen == [0, 1, 2]
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.fold_chunks(torch.zeros(5), 2, lambda s, c, a: s, None)
