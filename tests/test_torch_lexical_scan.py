"""The lexical scan of the port against the JAX reference's kernel.

On the CPU the port's `ops.lexical_scan_topk` runs its plain PyTorch
version; the reference's `ops.lexical_scan_topk` runs its Pallas kernel in
interpret mode, as the reference's own tests run it. Same numpy inputs, made
from a seed, through both: scores within 1e-5 and ids equal except at float
near-ties (`_torch_parity`). Packed token matrices (``pack_spec``: uint8,
uint16 and int32 bit-planes) go through both the same way, and within the
port the packed plain version must equal the unpacked one bit for bit. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro.core import anchors as ref_anchors
from repro.core import packing as ref_packing
from repro.core import scan as ref_scan
from repro.core import scoring as ref_scoring
from repro.core import topk as ref_topk
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import packing, pipeline, scan, scoring
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


def _both(q, toks, lens, vocab, *, k, block_d, tile_d, pack=None):
    """The reference's kernel (interpret mode) and the port's plain version
    on the same inputs; with ``pack`` (a token_pack mode) both take the
    reference's packed matrix and spec."""
    ref_grid, port_grid = _grids()
    ref_stats = ref_anchors.collection_stats(
        jnp.asarray(toks), jnp.asarray(lens), vocab=vocab, chunk_size=toks.shape[0]
    )
    modes, w, ab = ref_scoring.lexical_epilogues(ref_grid, jnp.asarray(q), ref_stats)
    ref_spec = spec = None
    d = toks
    if pack is not None:
        ref_spec = ref_packing.make_spec(vocab, toks.shape[1], pack)
        spec = packing.make_spec(vocab, toks.shape[1], pack)
        d = ref_packing.pack_tokens(toks, ref_spec)
    want = ref_ops.lexical_scan_topk(
        jnp.asarray(q), w, ab, jnp.asarray(d), jnp.asarray(lens),
        modes=modes, k=k, block_d=block_d, tile_d=tile_d, pack_spec=ref_spec,
    )
    # the port on the reference's own epilogue tables, carried across
    p_modes, p_w, p_ab = convert.epilogues_from_numpy(modes, np.asarray(w), np.asarray(ab))
    got = ops.lexical_scan_topk(
        torch.tensor(q), p_w, p_ab, torch.as_tensor(d), torch.tensor(lens),
        modes=p_modes, k=k, block_d=block_d, tile_d=tile_d, pack_spec=spec,
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


@pytest.mark.parametrize("pack", ["8", "16", "bitpack"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_packed_plain_scan_matches_reference_kernel(case, pack):
    """The packed path (the reference's Pallas kernel decoding the packed
    tile in interpret mode; the port's plain version unpacking each block)
    under the parity rule, and bit-equal to the port's unpacked call."""
    name, seed, n_d, l_d, n_q, l_q, vocab, n_empty, k, block_d, tile_d = case
    q, toks, lens = _inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty)
    (gs, gi), (ws, wi) = _both(q, toks, lens, vocab, k=k, block_d=block_d, tile_d=tile_d,
                               pack=pack)
    assert_rankings_close(gs.numpy(), gi.numpy(), ws, wi, what=f"{name} {pack}")
    (us, ui), _ = _both(q, toks, lens, vocab, k=k, block_d=block_d, tile_d=tile_d)
    assert torch.equal(gi, ui) and torch.equal(gs.view(torch.int32), us.view(torch.int32))


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


def test_the_counters_name_each_of_the_kernels_counts():
    """`COUNTERS` has a name for each uint64 the kernel adds to (its
    ``kCounters``)."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "lexical_scan.cu").read_text()
    assert int(re.search(r"constexpr int kCounters = (\d+);", src).group(1)) == len(
        lexical_scan.COUNTERS) == len(set(lexical_scan.COUNTERS))


def test_the_counters_keep_their_first_eight_in_order():
    """The term-score and epilogue counters come after the flush counters,
    whose names and places readers already know."""
    assert lexical_scan.COUNTERS[:8] == (
        "passes_need", "passes_scheduled", "passes_rows", "passes_final", "list_flushes",
        "candidates", "flush_cycles", "loop_cycles")
    assert lexical_scan.COUNTERS[8:] == ("term_scores", "term_uses", "epilogue_cycles")


@pytest.mark.parametrize("shape, most_groups", [
    pytest.param(shape, most, id="x".join(map(str, shape))) for shape, most in (
        ((1, 64, 8), (1, 1)), ((5, 64, 4), (1, 1)), ((1, 128, 4), (1, 1)),
        ((1, 2500, 4), (9, 9)), ((1, 5000, 4), (18, 17)))
])
def test_the_term_table_keeps_one_query_group(shape, most_groups):
    """Each warp's matched terms and their scores fit beside the rest: a
    serving block (64 x 8, 128 x 4, one model) and a mirex-8M segment's 5
    models x 64 x 4 stay one query group with tile_d 16, unpacked and in
    mirex's 17-bit planes. Fig. 2's scans (2,500 and 5,000 queries) take no
    more groups, and so read the corpus no more often, than the per-term
    query masks the table replaced left room for."""
    n_models, n_q, l_q = shape
    spec = packing.make_spec(65_536, 128, "auto")
    for most, (l_d, pack_spec) in zip(most_groups, ((128, None), (spec.packed_width, spec))):
        geo = lexical_scan.launch_geometry(n_models, n_q, l_q, 1 << 22, l_d, 1000, 16_384, 16,
                                           pack_spec=pack_spec)
        assert geo["n_groups"] <= most and geo["group"] * geo["n_groups"] >= n_q
        assert geo["smem"] <= lexical_scan.SMEM_LIMIT


@pytest.mark.parametrize("n_q", [64, 32])
def test_a_serving_block_keeps_one_query_group_and_its_tile(n_q):
    """A served block of the cells' shape (one model, 64 or 32 queries of 8
    terms, rows of 128 tokens, tile_d 16) stays one query group of 32-row
    tiles: the collection is scanned once a block."""
    geo = lexical_scan.launch_geometry(1, n_q, 8, 12_582_912, 128, 1000, 16_384, 16)
    assert geo["n_groups"] == 1 and geo["group"] == n_q and geo["tile_docs"] == 32
    assert geo["smem"] <= lexical_scan.SMEM_LIMIT


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
    # a packed matrix must have the spec's width and dtype, in either version
    spec = packing.make_spec(8, 4, "auto")  # u8, 4 columns
    packed = torch.as_tensor(packing.pack_tokens(d.numpy(), spec))
    got = ops.lexical_scan_topk(q, w, ab, packed, dl, modes=modes, k=2, block_d=8,
                                pack_spec=spec)
    want = ops.lexical_scan_topk(q, w, ab, d, dl, modes=modes, k=2, block_d=8)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    with pytest.raises(TypeError, match="dtype"):
        ops.lexical_scan_topk(q, w, ab, d, dl, modes=modes, k=2, block_d=8, pack_spec=spec)
    wide = packing.make_spec(8, 5, "auto")
    with pytest.raises(ValueError, match="packed width 4 != spec 5"):
        ops.lexical_scan_topk(q, w, ab, packed, dl, modes=modes, k=2, block_d=8,
                              pack_spec=wide)
    for version in (lexical_scan.lexical_scan_topk_ref, lexical_scan.lexical_scan_topk_cuda):
        with pytest.raises(TypeError, match="pack mode u8"):
            version(q, w, ab, d, dl, modes=modes, k=2, block_d=8, tile_d=16, pack_spec=spec)
        with pytest.raises(ValueError, match="packed width"):
            version(q, w, ab, packed, dl, modes=modes, k=2, block_d=8, tile_d=16,
                    pack_spec=wide)


def test_launch_geometry():
    geo = lexical_scan.launch_geometry(5, 64, 4, 262_144, 128, 1000, 16_384, 16)
    # one query group: every CTA holds all 5 x 64 lists and stages each tile once
    assert geo["n_groups"] == 1 and geo["group"] == 64
    assert geo["k_pad"] == 1024 and geo["tile_docs"] == 32 and geo["cap"] == 128
    assert geo["smem"] <= lexical_scan.SMEM_LIMIT and geo["flush_rows"] == 16_384
    # one CTA per SM, taking the tiles in turn; no more CTAs than tiles
    assert geo["n_splits"] == 132
    assert lexical_scan.launch_geometry(5, 7, 5, 300, 23, 37, 100, 16)["n_splits"] == 10
    serve = lexical_scan.launch_geometry(1, 128, 4, 1 << 23, 128, 1000, 16_384, 16)
    assert serve["n_groups"] == 1 and serve["smem"] <= lexical_scan.SMEM_LIMIT
    assert 1 << serve["log2h"] >= 2 * 128 * 4  # the term table: at most half full
    # tile_d rounds up to a whole warp of rows
    assert lexical_scan.launch_geometry(5, 7, 5, 300, 23, 37, 100, 33)["tile_docs"] == 64
    # too many query terms for one CTA: groups, each within the shared memory
    many = lexical_scan.launch_geometry(5, 4000, 8, 8192, 24, 10, 4096, 16)
    assert many["n_groups"] > 1 and many["group"] * many["n_groups"] >= 4000
    assert many["smem"] <= lexical_scan.SMEM_LIMIT
    with pytest.raises(ValueError, match="at most k"):
        lexical_scan.launch_geometry(1, 1, 1, 64, 8, lexical_scan.MAX_K + 1, 64, 16)
    with pytest.raises(ValueError, match="does not fit"):
        lexical_scan.launch_geometry(1, 1, 1, 64, 1 << 16, 10, 64, 16)
    assert lexical_scan.mode_codes((
        scoring.EpilogueMode("ql", length_prior=True),
        scoring.EpilogueMode("bm25"),
        scoring.EpilogueMode("tfidf", length_norm="rsqrt"),
    )) == [4, 1, 10]


def test_launch_geometry_sizes_the_ring_from_packed_bytes():
    """A packed row stages as its bytes: 68 int32 words a row for mirex's
    17-bit planes at L 128, 23 bytes a row in uint8."""
    spec = packing.make_spec(65_536, 128, "auto")
    assert spec.mode == "bitpack" and spec.packed_width == 68
    packed = lexical_scan.launch_geometry(5, 64, 4, 262_144, 68, 1000, 16_384, 16,
                                          pack_spec=spec)
    plain = lexical_scan.launch_geometry(5, 64, 4, 262_144, 128, 1000, 16_384, 16)
    assert packed["row_bytes"] == 68 * 4 and plain["row_bytes"] == 128 * 4
    assert plain["smem"] - packed["smem"] == 2 * (32 * 512 - 32 * 272)
    u8 = lexical_scan.launch_geometry(1, 4, 4, 300, 23, 10, 100, 16,
                                      pack_spec=packing.make_spec(200, 23, "auto"))
    assert u8["row_bytes"] == 23 and u8["smem"] <= lexical_scan.SMEM_LIMIT


def test_scan_takes_a_packed_corpus():
    """search_local_multi on a PackedCorpus (segments sliced by the scan job
    keep their spec) equals the unpacked scan bit for bit; a dense scorer
    on a packed corpus is refused."""
    vocab = 40
    q, toks, lens = _inputs(10, 256, 23, 6, 4, vocab, 16)
    _, port_grid = _grids()
    stats = convert.stats_from_numpy([np.asarray(x) for x in ref_anchors.collection_stats(
        jnp.asarray(toks), jnp.asarray(lens), vocab=vocab, chunk_size=64)])
    plain = scan.search_local_multi(
        torch.tensor(q), (torch.tensor(toks), torch.tensor(lens)), port_grid,
        k=20, chunk_size=64, stats=stats)
    for mode in ("8", "16", "bitpack"):
        docs = packing.pack_corpus(toks, lens, vocab=vocab, mode=mode).to("cpu")
        got = scan.search_local_multi(torch.tensor(q), docs, port_grid, k=20, chunk_size=64,
                                      stats=stats)
        assert torch.equal(got.ids, plain.ids)
        assert torch.equal(got.scores.view(torch.int32), plain.scores.view(torch.int32))
        tail = scan.search_local_multi(
            torch.tensor(q), pipeline.tree_map(lambda x: x[128:], docs), port_grid, k=20,
            chunk_size=64, stats=stats, doc_id_offset=128)
        want = scan.search_local_multi(
            torch.tensor(q), (torch.tensor(toks[128:]), torch.tensor(lens[128:])), port_grid,
            k=20, chunk_size=64, stats=stats, doc_id_offset=128)
        assert torch.equal(tail.ids, want.ids)
    with pytest.raises(ValueError, match="packed corpus holds tokens"):
        scan.search_local(torch.zeros((2, 8)), docs, scoring.get_scorer("dense_dot"), k=2,
                          chunk_size=64)
