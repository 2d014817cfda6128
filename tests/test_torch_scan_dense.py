"""Dense scans of the port against the JAX reference, on the CPU.

`scan.search_local` / `search_local_multi` with ``dense_dot`` and
``dense_cosine`` are held against the reference's host fold
(``use_kernel=False``, which scores chunk by chunk through the scorer):
scores within 1e-5, ids equal except at float near-ties (`_torch_parity`,
with the reference ranking taken 8 places deeper). The port follows the
scorer's definition on every device; the reference's kernel path
(``use_kernel=True``) drops the row map of ``dense_cosine`` and returns dot
products, which the last test shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro.cluster import mapreduce as ref_mapreduce
from repro.core import scan as ref_scan
from repro.core import scoring as ref_scoring
from repro.data import synthetic as ref_synthetic
from repro_torch.cluster import mapreduce
from repro_torch.core import scan, scoring, topk
from repro_torch.data import synthetic

DEEPER = 8


def _vectors(seed, n_q=12, n_d=512, dim=48):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n_q, dim)).astype(np.float32)
    d = rng.standard_normal((n_d, dim)).astype(np.float32)
    return q, d


def _ref_host(q, d, name, k, chunk, offset=0):
    state = ref_scan.search_local(
        jnp.asarray(q), jnp.asarray(d), ref_scoring.get_scorer(name), k=k,
        chunk_size=chunk, doc_id_offset=offset, use_kernel=False,
    )
    return np.asarray(state.scores), np.asarray(state.ids)


@pytest.mark.parametrize("name", ["dense_dot", "dense_cosine"])
@pytest.mark.parametrize("chunk", [32, 128])
def test_search_local_matches_reference_host_fold(name, chunk):
    q, d = _vectors(1)
    got = scan.search_local(torch.tensor(q), torch.tensor(d), scoring.get_scorer(name), k=20,
                            chunk_size=chunk, doc_id_offset=1000)
    ws, wi = _ref_host(q, d, name, 20 + DEEPER, chunk, offset=1000)
    assert got.scores.shape == (12, 20) and got.ids.dtype == torch.int32
    assert_rankings_close(got.scores, got.ids, ws, wi, what=f"{name} chunk {chunk}")
    assert int(got.ids.min()) >= 1000


@pytest.mark.parametrize("chunk", [32, 128])
def test_search_local_multi_dense_grid(chunk):
    q, d = _vectors(2)
    names = ["dense_dot", "dense_cosine"]
    grid = [scoring.get_scorer(n) for n in names] + [scoring.make_variant("dense_cosine", eps=0.5)]
    got = scan.search_local_multi(torch.tensor(q), torch.tensor(d), grid, k=16,
                                  chunk_size=chunk, doc_id_offset=64)
    assert got.scores.shape == (3, 12, 16)
    for m, name in enumerate(names):
        ws, wi = _ref_host(q, d, name, 16 + DEEPER, chunk, offset=64)
        assert_rankings_close(got.scores[m], got.ids[m], ws, wi, what=name)
        one = scan.search_local(torch.tensor(q), torch.tensor(d), grid[m], k=16,
                                chunk_size=chunk, doc_id_offset=64)
        assert torch.equal(one.ids, got.ids[m]) and torch.equal(one.scores, got.scores[m])
    want = ref_scan.search_local(
        jnp.asarray(q), jnp.asarray(d), ref_scoring.make_variant("dense_cosine", eps=0.5),
        k=16 + DEEPER, chunk_size=chunk, doc_id_offset=64,
    )
    assert_rankings_close(got.scores[2], got.ids[2], want.scores, want.ids, what="eps=0.5")
    # resume: the second half merged into the first half's state
    first = scan.search_local_multi(torch.tensor(q), torch.tensor(d[:256]), grid, k=16,
                                    chunk_size=chunk, doc_id_offset=64)
    resumed = scan.search_local_multi(torch.tensor(q), torch.tensor(d[256:]), grid, k=16,
                                      chunk_size=chunk, doc_id_offset=64 + 256,
                                      init_state=first)
    assert torch.equal(resumed.ids, got.ids)
    with pytest.raises(ValueError, match="single kind"):
        scan.search_local_multi(torch.tensor(q), torch.tensor(d), [grid[0], scoring.get_scorer("bm25")],
                                k=4, chunk_size=chunk)


def test_map_shard_takes_a_dense_grid():
    q, d = _vectors(3, n_d=256)
    grid = [scoring.get_scorer("dense_dot")]
    got = mapreduce.map_shard(torch.tensor(q), torch.tensor(d), grid, k=10, chunk_size=64,
                              doc_id_offset=512)
    want = ref_mapreduce.map_shard(jnp.asarray(q), jnp.asarray(d),
                                   [ref_scoring.get_scorer("dense_dot")], k=10 + DEEPER,
                                   chunk_size=64, doc_id_offset=512)
    assert_rankings_close(got.scores, got.ids, want.scores, want.ids, what="map_shard")


def test_search_dense_host_matches_reference():
    q, d = _vectors(4, n_d=300)
    got = scan.search_dense_host(torch.tensor(q), torch.tensor(d), 25)
    want = ref_scan.search_dense_host(jnp.asarray(q), jnp.asarray(d), 25 + DEEPER)
    assert_rankings_close(got.scores, got.ids, want.scores, want.ids, what="host oracle")
    # the oracle is the same ranking as the blocked scan
    blocked = scan.search_local(torch.tensor(q), torch.tensor(d), scoring.get_scorer("dense_dot"),
                                k=25, chunk_size=100)
    assert_rankings_close(blocked.scores, blocked.ids, got.scores, got.ids, what="blocked")


@pytest.mark.parametrize("seed", [0, 4, 17])
def test_make_dense_corpus_is_byte_identical(seed):
    got = synthetic.make_dense_corpus(n_docs=300, dim=24, seed=seed)
    want = ref_synthetic.make_dense_corpus(n_docs=300, dim=24, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_reference_kernel_path_drops_the_cosine_row_map():
    """The reference's ``use_kernel=True`` dense scan calls
    ``ops.score_topk(queries, docs)`` directly, so ``dense_cosine`` there
    returns dot-product scores; its host fold returns cosine scores. The
    port follows the scorer (the host fold) on every device."""
    q, d = _vectors(5, n_d=256)
    cos, dot = ref_scoring.get_scorer("dense_cosine"), ref_scoring.get_scorer("dense_dot")
    kw = dict(k=10, chunk_size=128)
    ref_cos_kernel = ref_scan.search_local(jnp.asarray(q), jnp.asarray(d), cos, use_kernel=True, **kw)
    ref_dot_kernel = ref_scan.search_local(jnp.asarray(q), jnp.asarray(d), dot, use_kernel=True, **kw)
    np.testing.assert_array_equal(np.asarray(ref_cos_kernel.scores), np.asarray(ref_dot_kernel.scores))
    np.testing.assert_array_equal(np.asarray(ref_cos_kernel.ids), np.asarray(ref_dot_kernel.ids))
    assert np.abs(np.asarray(ref_cos_kernel.scores)).max() > 1.5  # not cosines
    got = scan.search_local(torch.tensor(q), torch.tensor(d), scoring.get_scorer("dense_cosine"),
                            use_kernel=True, **kw)
    assert float(got.scores.abs().max()) <= 1.0
    ws, wi = _ref_host(q, d, "dense_cosine", 10 + DEEPER, 128)
    assert_rankings_close(got.scores, got.ids, ws, wi, what="port cosine = reference host fold")
    assert topk.valid_mask(got).all()
