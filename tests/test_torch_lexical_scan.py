"""The lexical scan of the port against the JAX reference's kernel.

On the CPU the port's `ops.lexical_scan_topk` runs its plain PyTorch
version; the reference's `ops.lexical_scan_topk` runs its Pallas kernel in
interpret mode, as the reference's own tests run it. Same numpy inputs, made
from a seed, through both: scores within 1e-5 and ids equal except at float
near-ties (`_torch_parity`). The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py`` (and by
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro.core import anchors as ref_anchors
from repro.core import scan as ref_scan
from repro.core import scoring as ref_scoring
from repro.core import topk as ref_topk
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import scan, scoring
from repro_torch.kernels import lexical_scan, ops

GRID = [
    ("ql_lm", {}),
    ("ql_lm", {"lam": 0.5, "length_prior": False}),
    ("bm25", {}),
    ("bm25", {"k1": 0.9, "b": 0.4}),
    ("tfidf", {}),
]


def _grids():
    ref = [ref_scoring.make_variant(b, **p) for b, p in GRID]
    port = [scoring.make_variant(b, **p) for b, p in GRID]
    return ref, port


def _inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l_d + 1, size=n_d).astype(np.int32)
    lens[rng.choice(n_d, size=n_empty, replace=False)] = 0
    toks = rng.integers(0, vocab, size=(n_d, l_d)).astype(np.int32)
    toks[np.arange(l_d)[None, :] >= lens[:, None]] = scoring.PAD_TOKEN
    q = rng.integers(0, vocab, size=(n_q, l_q)).astype(np.int32)
    q[np.arange(l_q)[None, :] >= rng.integers(1, l_q + 1, size=n_q)[:, None]] = -1
    return q, toks, lens


def _both(q, toks, lens, vocab, *, k, block_d, tile_d):
    ref_grid, port_grid = _grids()
    ref_stats = ref_anchors.collection_stats(
        jnp.asarray(toks), jnp.asarray(lens), vocab=vocab, chunk_size=toks.shape[0]
    )
    modes, w, ab = ref_scoring.lexical_epilogues(ref_grid, jnp.asarray(q), ref_stats)
    want = ref_ops.lexical_scan_topk(
        jnp.asarray(q), w, ab, jnp.asarray(toks), jnp.asarray(lens),
        modes=modes, k=k, block_d=block_d, tile_d=tile_d,
    )
    # the port on the reference's own epilogue tables, carried across
    p_modes, p_w, p_ab = convert.epilogues_from_numpy(modes, np.asarray(w), np.asarray(ab))
    got = ops.lexical_scan_topk(
        torch.tensor(q), p_w, p_ab, torch.tensor(toks), torch.tensor(lens),
        modes=p_modes, k=k, block_d=block_d, tile_d=tile_d,
    )
    return got, want


# name, seed, n_d, L_d, n_q, L_q, vocab, zero-length rows, k, block_d, tile_d
CASES = [
    ("zero_length_rows_k_not_pow2", 1, 192, 23, 5, 5, 30, 40, 37, 64, 16),
    ("k_above_docs", 2, 64, 16, 4, 3, 12, 8, 100, 64, 16),
    ("ld_not_multiple_of_tile", 3, 128, 21, 6, 4, 20, 10, 16, 32, 8),
    ("bm25_ties_small_vocab", 4, 256, 12, 6, 4, 5, 30, 50, 128, 16),
    ("all_zero_length", 5, 32, 8, 3, 2, 5, 32, 10, 32, 16),
    ("k_one", 6, 96, 10, 4, 4, 9, 5, 1, 32, 16),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_scan_matches_reference_kernel(case):
    name, seed, n_d, l_d, n_q, l_q, vocab, n_empty, k, block_d, tile_d = case
    q, toks, lens = _inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty)
    (gs, gi), (ws, wi) = _both(q, toks, lens, vocab, k=k, block_d=block_d, tile_d=tile_d)
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    assert_rankings_close(gs.numpy(), gi.numpy(), ws, wi, what=name)
    # zero-length rows never rank; empty slots are (-inf, -1)
    zero = set(np.flatnonzero(lens == 0).tolist())
    assert not zero & set(gi[gi >= 0].tolist())
    assert ((gi == -1) == torch.isneginf(gs)).all()


def test_block_geometry_changes_no_bit():
    q, toks, lens = _inputs(7, 256, 19, 5, 4, 25, 20)
    ref_grid, port_grid = _grids()
    stats = convert.stats_from_numpy(
        [np.asarray(x) for x in ref_anchors.collection_stats(
            jnp.asarray(toks), jnp.asarray(lens), vocab=25, chunk_size=256)]
    )
    modes, w, ab = scoring.lexical_epilogues(port_grid, torch.tensor(q), stats)
    args = (torch.tensor(q), w, ab, torch.tensor(toks), torch.tensor(lens))
    base = lexical_scan.lexical_scan_topk_ref(*args, modes=modes, k=24, block_d=256, tile_d=16)
    for block_d, tile_d in [(32, 1), (64, 7), (128, 32)]:
        s, i = lexical_scan.lexical_scan_topk_ref(
            *args, modes=modes, k=24, block_d=block_d, tile_d=tile_d)
        assert torch.equal(i, base[1]) and torch.equal(s.view(torch.int32), base[0].view(torch.int32))


def test_scan_resume_and_offset_match_reference():
    """search_local_multi with init_state (a resumed segment) and a doc-id
    offset, through both packages."""
    vocab = 40
    q, toks, lens = _inputs(8, 256, 16, 6, 4, vocab, 16)
    ref_grid, port_grid = _grids()
    ref_stats = ref_anchors.collection_stats(
        jnp.asarray(toks), jnp.asarray(lens), vocab=vocab, chunk_size=64)
    stats = convert.stats_from_numpy([np.asarray(x) for x in ref_stats])
    half = 128
    ref_first = ref_scan.search_local_multi(
        jnp.asarray(q), (jnp.asarray(toks[:half]), jnp.asarray(lens[:half])), ref_grid,
        k=20, chunk_size=64, stats=ref_stats, use_kernel=True)
    want = ref_scan.search_local_multi(
        jnp.asarray(q), (jnp.asarray(toks[half:]), jnp.asarray(lens[half:])), ref_grid,
        k=20, chunk_size=64, stats=ref_stats, doc_id_offset=half,
        init_state=ref_first, use_kernel=True)
    init = convert.state_from_numpy(
        ref_topk.TopKState(np.asarray(ref_first.scores), np.asarray(ref_first.ids)))
    got = scan.search_local_multi(
        torch.tensor(q), (torch.tensor(toks[half:]), torch.tensor(lens[half:])), port_grid,
        k=20, chunk_size=64, stats=stats, doc_id_offset=half, init_state=init)
    assert_rankings_close(got.scores, got.ids, want.scores, want.ids, what="resume")
    # the whole corpus in one pass is the same ranking
    whole = scan.search_local_multi(
        torch.tensor(q), (torch.tensor(toks), torch.tensor(lens)), port_grid,
        k=20, chunk_size=64, stats=stats)
    assert_rankings_close(whole.scores, whole.ids, want.scores, want.ids, what="one pass")
    single = scan.search_local(
        torch.tensor(q), (torch.tensor(toks), torch.tensor(lens)), port_grid[2],
        k=20, chunk_size=64, stats=stats)
    assert torch.equal(single.ids, whole.ids[2])


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, toks, lens = _inputs(9, 64, 8, 3, 2, 10, 4)
    stats = convert.stats_from_numpy([np.asarray(x) for x in ref_anchors.collection_stats(
        jnp.asarray(toks), jnp.asarray(lens), vocab=10, chunk_size=64)])
    _, port_grid = _grids()
    modes, w, ab = scoring.lexical_epilogues(port_grid, torch.tensor(q), stats)
    before = dict(ops.LAUNCHES)
    got = ops.lexical_scan_topk(torch.tensor(q), w, ab, torch.tensor(toks), torch.tensor(lens),
                                modes=modes, k=8, block_d=32)
    want = lexical_scan.lexical_scan_topk_ref(
        torch.tensor(q), w, ab, torch.tensor(toks), torch.tensor(lens), modes=modes, k=8,
        block_d=32)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert ops.LAUNCHES == before


def test_wrapper_checks_its_arguments():
    q = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.zeros((1, 2, 3))
    ab = torch.zeros((1, 2))
    d = torch.zeros((8, 4), dtype=torch.int32)
    dl = torch.ones(8, dtype=torch.int32)
    modes = (scoring.EpilogueMode("bm25"),)
    with pytest.raises(TypeError, match="dtype"):
        ops.lexical_scan_topk(q.long(), w, ab, d, dl, modes=modes, k=2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.lexical_scan_topk(q, w, ab, torch.zeros((4, 8), dtype=torch.int32).T, dl,
                              modes=modes, k=2)
    with pytest.raises(ValueError, match="modes"):
        ops.lexical_scan_topk(q, w, ab, d, dl, modes=modes * 2, k=2, block_d=8)
    with pytest.raises(ValueError, match="divisible"):
        ops.lexical_scan_topk(q, w, ab, d, dl, modes=modes, k=2, block_d=3)
    with pytest.raises(NotImplementedError, match="packing slice"):
        ops.lexical_scan_topk(q, w, ab, d, dl, modes=modes, k=2, pack_spec=object())


def test_launch_geometry():
    geo = lexical_scan.launch_geometry(5, 64, 4, 262_144, 128, 1000, 16_384, 16)
    assert geo["k_pad"] == 1024 and geo["tile_docs"] == 32 and geo["n_splits"] == 16
    assert geo["group"] == 5 and geo["smem"] <= lexical_scan.SMEM_LIMIT
    many = lexical_scan.launch_geometry(40, 64, 4, 262_144, 128, 1000, 16_384, 16)
    assert 1 <= many["group"] < 40 and many["smem"] <= lexical_scan.SMEM_LIMIT
    assert lexical_scan.launch_geometry(5, 4, 4, 8192, 24, 3000, 4096, 16)["group"] == 3
    with pytest.raises(ValueError, match="at most k"):
        lexical_scan.launch_geometry(1, 1, 1, 64, 8, lexical_scan.MAX_K + 1, 64, 16)
    with pytest.raises(ValueError, match="exceed the grid"):
        lexical_scan.launch_geometry(1, 1, 1, 1 << 20, 8, 10, 8, 16)
    assert lexical_scan.mode_codes((
        scoring.EpilogueMode("ql", length_prior=True),
        scoring.EpilogueMode("bm25"),
        scoring.EpilogueMode("tfidf", length_norm="rsqrt"),
    )) == [4, 1, 10]
