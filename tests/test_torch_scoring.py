"""The port's scoring against the JAX reference, on the CPU.

tf counts are integers and must match exactly; epilogue tables carry the
reference's float32 cast points, so every table built without a
transcendental function (QL weights, every alpha/beta) is bit-equal. The
idf tables of BM25 and tf-idf go through ``log1p``/``log``, where XLA's CPU
implementation and torch's differ in the last place on some inputs, so they
are held to 2 ulp. Scores from `apply_epilogue` are held to rtol = atol =
1e-5 for the same reason (measured: the two ``log1p`` disagree by one ulp on
about 6% of float32 inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scoring as ref_scoring
from repro_torch.core import scoring

VOCAB = 64


def _tokens(rng, n, length, *, pad_frac=0.3):
    toks = rng.integers(0, VOCAB, size=(n, length)).astype(np.int32)
    toks[rng.random((n, length)) < pad_frac] = scoring.PAD_TOKEN
    return toks


def _stats(rng):
    cf = rng.integers(0, 500, VOCAB).astype(np.int32)
    df = np.minimum(cf, rng.integers(0, 200, VOCAB)).astype(np.int32)
    total, n_docs, avg = np.int32(9_731), np.int32(211), np.float32(46.1187)
    ref = ref_scoring.CollectionStats(
        jnp.asarray(cf), jnp.asarray(df), jnp.asarray(total), jnp.asarray(n_docs),
        jnp.asarray(avg),
    )
    port = scoring.CollectionStats(
        torch.tensor(cf), torch.tensor(df), torch.tensor(total), torch.tensor(n_docs),
        torch.tensor(avg),
    )
    return ref, port


@pytest.mark.parametrize("tile_d", [1, 5, 16, 64])
def test_term_frequencies_exact(tile_d):
    rng = np.random.default_rng(tile_d)
    q, d = _tokens(rng, 6, 5), _tokens(rng, 40, 37)
    want = np.asarray(ref_scoring.term_frequencies(jnp.asarray(q), jnp.asarray(d), tile_d=tile_d))
    got = scoring.term_frequencies(torch.tensor(q), torch.tensor(d), tile_d=tile_d).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    assert got.dtype == np.float32


def test_term_frequencies_dense_exact():
    rng = np.random.default_rng(1)
    q, d = _tokens(rng, 5, 4), _tokens(rng, 30, 19)
    want = np.asarray(ref_scoring.term_frequencies_dense(jnp.asarray(q), jnp.asarray(d)))
    got = scoring.term_frequencies_dense(torch.tensor(q), torch.tensor(d)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, scoring.term_frequencies(torch.tensor(q), torch.tensor(d)).numpy()
    )


EPILOGUES = [
    ("ql_lm", {}),
    ("ql_lm", {"lam": 0.5, "length_prior": False}),
    ("bm25", {}),
    ("bm25", {"k1": 0.9, "b": 0.4}),
    ("tfidf", {}),
]


@pytest.mark.parametrize("name,params", EPILOGUES, ids=lambda x: str(x))
def test_epilogue_tables(name, params):
    rng = np.random.default_rng(2)
    ref_stats, port_stats = _stats(rng)
    q = _tokens(rng, 9, 6)
    rm, rep = ref_scoring.get_scorer(name).epilogue(jnp.asarray(q), ref_stats, **params)
    pm, pep = scoring.get_scorer(name).epilogue(torch.tensor(q), port_stats, **params)
    assert (pm.mode, pm.length_prior, pm.length_norm) == (rm.mode, rm.length_prior, rm.length_norm)
    for field in ("alpha", "beta"):
        want = np.asarray(getattr(rep, field), np.float32)
        got = getattr(pep, field).numpy()
        assert got.dtype == np.float32
        assert got.tobytes() == want.tobytes(), field
    want_w = np.asarray(rep.weights)
    got_w = pep.weights.numpy()
    if name == "ql_lm":
        assert got_w.tobytes() == want_w.tobytes()
    else:  # idf through log1p / log: last-place libm differences only
        np.testing.assert_array_max_ulp(got_w, want_w, maxulp=2)
    np.testing.assert_array_equal(got_w == 0, want_w == 0)  # masks agree exactly


@pytest.mark.parametrize("name,params", EPILOGUES, ids=lambda x: str(x))
def test_apply_epilogue_scores(name, params):
    rng = np.random.default_rng(3)
    ref_stats, port_stats = _stats(rng)
    q, d = _tokens(rng, 7, 5), _tokens(rng, 50, 29)
    d_len = (d != scoring.PAD_TOKEN).sum(-1).astype(np.int32)
    d_len[:4] = 0  # zero-length rows score -inf
    rm, rep = ref_scoring.get_scorer(name).epilogue(jnp.asarray(q), ref_stats, **params)
    tf = ref_scoring.term_frequencies(jnp.asarray(q), jnp.asarray(d))
    want = np.asarray(ref_scoring.apply_epilogue(rm, rep, tf, jnp.asarray(d_len)))
    # the port's epilogue on the reference's own tables, then on its own
    ep_from_ref = scoring.LexicalEpilogue(
        torch.tensor(np.asarray(rep.weights)), torch.tensor(np.asarray(rep.alpha)),
        torch.tensor(np.asarray(rep.beta)),
    )
    pm, pep = scoring.get_scorer(name).epilogue(torch.tensor(q), port_stats, **params)
    tf_t = scoring.term_frequencies(torch.tensor(q), torch.tensor(d))
    for ep in (ep_from_ref, pep):
        got = scoring.apply_epilogue(pm, ep, tf_t, torch.tensor(d_len)).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)
    assert np.isneginf(want[:, :4]).all()


def test_scorer_registry_and_variants():
    for name in ("ql_lm", "bm25", "tfidf"):
        assert scoring.get_scorer(name).kind == "lexical"
    v = scoring.make_variant("bm25", k1=0.9, b=0.4)
    r = ref_scoring.make_variant("bm25", k1=0.9, b=0.4)
    assert (v.name, v.base, v.params) == (r.name, r.base, r.params)
    with pytest.raises(KeyError):
        scoring.get_scorer("nope")
    for name in ("dense_dot", "dense_cosine"):
        assert scoring.get_scorer(name).kind == "dense"
    assert scoring.get_scorer("dense_dot").row_map is None
    c = scoring.make_variant("dense_cosine", eps=1e-3)
    assert c.name == ref_scoring.make_variant("dense_cosine", eps=1e-3).name
    x = torch.tensor([[3.0, 4.0]])
    assert torch.equal(c.row_map(x), x / (5.0 + 1e-3))


def test_lexical_epilogues_stack():
    rng = np.random.default_rng(4)
    _, port_stats = _stats(rng)
    q = torch.tensor(_tokens(rng, 3, 4))
    grid = [scoring.get_scorer("ql_lm"), scoring.make_variant("bm25", k1=0.9, b=0.4)]
    modes, weights, ab = scoring.lexical_epilogues(grid, q, port_stats)
    assert [m.mode for m in modes] == ["ql", "bm25"]
    assert tuple(weights.shape) == (2, 3, 4) and tuple(ab.shape) == (2, 2)
    assert weights.is_contiguous() and ab.is_contiguous()
