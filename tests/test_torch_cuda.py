"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is ``cuda``-marked and skips without a card. The file imports
no JAX (the machine with the card has none), so it runs there on its own:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

The lexical scan must agree with its plain version to the bit, and its
packed-tile path with the unpacked kernel on the unpacked tokens; the dense
score + top-k within 1e-5 with ids equal except at float near-ties
(`_torch_parity`, the plain ranking taken 8 places deeper), and to the bit
on integer-valued inputs, rows narrower than its 128-byte stage included;
the flash attention and decode kernels (every attention route; decode with ``t`` on the host and on the card, and
replayed from a CUDA graph) within 3e-4 / 3e-5 in float32 and 3e-2 in
bfloat16 (the reference's tolerances), and the reduced LM on the card
within 1e-4 / 1e-5 of the CPU; its serve step with ``t`` on the card makes
no host sync. The pipelined executor on the card: host → card prefetch on a
copy stream equals the slices within its memory bound, the snapshot
checkpoints equal the synchronous job's, two workers on two streams give
the synchronous job's bits under seeded chaos, launches count exactly under
threads, and a segment fold makes no host sync. The anchor job on the card
gives the CPU's bytes, a grid's pass gives each model's single pass, and
the index ranks as the scan. The mesh on one card (every shard ``cuda:0``,
one CUDA stream a shard): `search_mesh` gives the one-shard scan's bytes
whatever the caller's stream is still doing, with no host sync, and the
sharded session the resident session's rows in the same bytes of memory;
the reduced MoE LM on the card is within 1e-4 / 1e-5 of the CPU and its
decode step makes no host sync. The decode kernel's mergeable partial over
each shard of a split cache holds to its plain version (an empty shard:
``o = 0``, ``lse = -inf``), and the reduced LM's step over a
sequence-sharded cache on the card holds to the CPU's with no host sync. Training: the flash kernel under autograd
gives the CPU's gradients (float32 within 1e-4 / 1e-5, bfloat16 within
3e-2), and two driver runs and a crash resumed from a checkpoint give the
same bytes on the card. The dense session pads its corpus once (the
wrapper's bits, no corpus-sized allocation a block); the ragged bag and
the reduced GNN in every regime repeat their bytes on the card, and the GNN
holds to the CPU (float64 within 1e-5, float32 logits within 2e-4 / 2e-5).
The lexical kernel's counters move on every launch into the array the call
passes, and a traced session's block carries its own launch's counts, also when two
blocks are launched back to back behind a busy card (no host sync, each
collected to its own bytes); its term scores,
shared by the slots that hold a term with the same weight's bits, keep the
plain version's bits in every token layout, and the term counters count
what the inputs say they must.
``chip_smoke.py`` makes the same checks at the full width.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro_torch.core import anchors, packing, scoring
from repro_torch.kernels import _build, flash_attn, flash_decode, lexical_scan, ops, score_topk

GRID = [
    ("ql_lm", {}),
    ("ql_lm", {"lam": 0.5, "length_prior": False}),
    ("bm25", {}),
    ("bm25", {"k1": 0.9, "b": 0.4}),
    ("tfidf", {}),
]
DEEPER = 8


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lexical_inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l_d + 1, size=n_d).astype(np.int32)
    lens[rng.choice(n_d, size=n_empty, replace=False)] = 0
    toks = rng.integers(0, vocab, size=(n_d, l_d)).astype(np.int32)
    toks[np.arange(l_d)[None, :] >= lens[:, None]] = scoring.PAD_TOKEN
    q = rng.integers(0, vocab, size=(n_q, l_q)).astype(np.int32)
    q[np.arange(l_q)[None, :] >= rng.integers(1, l_q + 1, size=n_q)[:, None]] = -1
    return q, toks, lens


def _zero_counters(dev) -> torch.Tensor:
    """A zeroed array for one launch's counts (`lexical_scan.COUNTERS`)."""
    return torch.zeros(len(lexical_scan.COUNTERS), dtype=torch.int64, device=dev)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_bitwise():
    dev = _card()
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    for seed, (n_d, l_d, k, block_d, tile_d) in enumerate(
        [(300, 23, 37, 100, 16), (64, 16, 100, 64, 16), (2048, 64, 64, 256, 64),
         (512, 300, 30, 256, 32), (8192, 24, 3000, 4096, 16)]
    ):
        q, toks, lens = _lexical_inputs(seed, n_d, l_d, 7, 5, 30, n_d // 8)
        d, dl, qt = (torch.tensor(x, device=dev) for x in (toks, lens, q))
        stats = anchors.collection_stats(d, dl, 30, chunk_size=n_d)
        modes, w, ab = scoring.lexical_epilogues(grid, qt, stats)
        before = ops.LAUNCHES["lexical_scan_topk"]
        ks, ki = ops.lexical_scan_topk(qt, w, ab, d, dl, modes=modes, k=k,
                                       block_d=block_d, tile_d=tile_d)
        ps, pi = lexical_scan.lexical_scan_topk_ref(qt, w, ab, d, dl, modes=modes, k=k,
                                                    block_d=block_d, tile_d=tile_d)
        assert ops.LAUNCHES["lexical_scan_topk"] == before + 1
        assert torch.equal(ki, pi)
        assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))


@pytest.mark.cuda
def test_cuda_lexical_scan_counters():
    """The kernel's counters move on every launch, into the zeroed array the
    call passes: at least one candidate flushed for each slot of each final
    list, flush cycles within the loop's, a flush pass at least every fourth
    tile of a CTA and one final pass a CTA; the outputs stay the plain
    version's bits."""
    dev = _card()
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    for seed, (n_d, l_d, k, block_d, tile_d) in enumerate(
        [(300, 23, 37, 100, 16), (2048, 64, 64, 256, 64), (8192, 24, 3000, 4096, 16),
         (65536, 16, 100, 65536, 32)]
    ):
        q, toks, lens = _lexical_inputs(900 + seed, n_d, l_d, 7, 5, 30, 0)
        d, dl, qt = (torch.tensor(x, device=dev) for x in (toks, lens, q))
        stats = anchors.collection_stats(d, dl, 30, chunk_size=n_d)
        modes, w, ab = scoring.lexical_epilogues(grid, qt, stats)
        got = _zero_counters(dev)
        ks, ki = ops.lexical_scan_topk(qt, w, ab, d, dl, modes=modes, k=k,
                                       block_d=block_d, tile_d=tile_d, counters=got)
        got = dict(zip(lexical_scan.COUNTERS, got.tolist()))
        ps, pi = lexical_scan.lexical_scan_topk_ref(qt, w, ab, d, dl, modes=modes, k=k,
                                                    block_d=block_d, tile_d=tile_d)
        assert torch.equal(ki, pi)
        assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
        geo = lexical_scan.launch_geometry(
            len(grid), 7, 5, n_d, l_d, k, block_d, tile_d,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        assert geo["n_groups"] == 1
        n_splits, tiles = geo["n_splits"], -(-n_d // geo["tile_docs"])
        per_cta = [-(-(tiles - c) // n_splits) for c in range(n_splits)]
        passes = sum(got[c] for c in ("passes_need", "passes_scheduled", "passes_rows",
                                      "passes_final"))
        assert got["passes_final"] == n_splits, got
        assert passes >= sum(-(-t // 4) for t in per_cta) + n_splits, got
        assert got["candidates"] >= len(grid) * 7 * min(k, n_d), got
        assert got["list_flushes"] >= len(grid) * 7, got
        assert 0 < got["flush_cycles"] <= got["loop_cycles"], got
        assert 0 < got["epilogue_cycles"] <= got["loop_cycles"], got
        assert got["term_uses"] >= got["term_scores"], got


# the token layouts the kernel stages: int32 rows, uint8 and uint16 rows, bit-planes
PACKS = (None, "8", "16", "bitpack")


def _term_counts(q, toks, lens, w, ab, modes):
    """The term counters one launch adds. For each row and model: one use a
    matched slot; one score a distinct matched term, and one more a matched
    slot of each list that holds a weight that is not finite or whose bits
    differ from its term's first slot's (slots taken l-major, as the kernel
    lays them out); but where a bm25 norm is not positive, one score a
    matched slot and none for the terms."""
    n_q, l_q = q.shape
    flat = np.where(q == scoring.PAD_TOKEN, scoring.PAD_TOKEN - 1, q).T.ravel()
    wt = w.cpu().numpy().astype(np.float32).transpose(0, 2, 1).reshape(w.shape[0], -1)
    bits = wt.view(np.uint32)
    first = np.array([np.flatnonzero(flat == t)[0] for t in flat])
    apart = (bits != bits[:, first]) | ~np.isfinite(wt)
    self_slots = np.tile(apart.reshape(w.shape[0], l_q, n_q).any(axis=1), (1, l_q))
    ab = ab.cpu().numpy().astype(np.float32)
    bm25 = np.array([m.mode == "bm25" for m in modes])
    scores = uses = 0
    for row, dlen in zip(toks, lens):
        hit = np.isin(flat, row)
        n_hit, n_terms = int(hit.sum()), len(set(flat[hit].tolist()))
        norm_ok = ~bm25 | (ab[:, 0] + ab[:, 1] * np.float32(dlen) > 0)
        scores += int(np.where(norm_ok, n_terms + self_slots[:, hit].sum(axis=1), n_hit).sum())
        uses += w.shape[0] * n_hit
    return scores, uses


def _every_layout(q, toks, lens, w, ab, modes, vocab, k=40, block_d=1024, tile_d=16):
    """The kernel in each token layout (`PACKS`) against the plain version,
    to the bit; its counters agree across layouts and with `_term_counts`.
    Returns the counters of one launch."""
    dev = _card()
    n_d, l_d = toks.shape
    geo = lexical_scan.launch_geometry(w.shape[0], q.shape[0], q.shape[1], n_d, l_d, k, block_d,
                                       tile_d)
    assert geo["n_groups"] == 1  # one launch: `_term_counts` counts one query group
    d, dl, qt = (torch.tensor(x, device=dev) for x in (toks, lens, q))
    w, ab = w.to(dev), ab.to(dev)
    ws, wi = lexical_scan.lexical_scan_topk_ref(qt, w, ab, d, dl, modes=modes, k=k,
                                                block_d=block_d, tile_d=tile_d)
    want = _term_counts(q, toks, lens, w, ab, modes)
    for mode in PACKS:
        spec = None if mode is None else packing.make_spec(vocab, l_d, mode)
        tok = d if spec is None else torch.as_tensor(packing.pack_tokens(toks, spec), device=dev)
        got = _zero_counters(dev)
        ks, ki = ops.lexical_scan_topk(qt, w, ab, tok, dl, modes=modes, k=k, block_d=block_d,
                                       tile_d=tile_d, pack_spec=spec, counters=got)
        got = dict(zip(lexical_scan.COUNTERS, got.tolist()))
        assert torch.equal(ki, wi), mode
        assert torch.equal(ks.view(torch.int32), ws.view(torch.int32)), mode
        assert (got["term_scores"], got["term_uses"]) == want, (mode, got, want)
        assert 0 < got["epilogue_cycles"] <= got["loop_cycles"], (mode, got)
    return got


def _frequent(toks) -> int:
    return int(np.bincount(toks[toks >= 0]).argmax())


@pytest.mark.cuda
def test_cuda_kernel_shares_a_term_of_every_query():
    """All 64 queries hold the corpus's most frequent term, a third of them
    twice: one score of it a row and model serves every slot that holds it."""
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    q, toks, lens = _lexical_inputs(960, 4096, 64, 64, 8, 200, 256)
    q[:, 0] = q[::3, 1] = _frequent(toks)
    stats = anchors.collection_stats(torch.tensor(toks), torch.tensor(lens), 200, chunk_size=4096)
    modes, w, ab = scoring.lexical_epilogues(grid, torch.tensor(q), stats)
    got = _every_layout(q, toks, lens, w, ab, modes, 200)
    assert got["term_uses"] > 2 * got["term_scores"], got


@pytest.mark.cuda
def test_cuda_kernel_scores_a_term_apart_where_its_weight_differs():
    """The same term with other weights in some queries (hand-made: scaled
    up and down, +0 against -0) scores apart from its first slot's weight;
    the slots that keep that weight share its score."""
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    q, toks, lens = _lexical_inputs(961, 2048, 48, 32, 4, 200, 64)
    common = _frequent(toks)
    q[:4, 0] = q[1, 2] = common
    q[6, 0] = q[7, 0] = q[8, 1] = (common + 1) % 200
    stats = anchors.collection_stats(torch.tensor(toks), torch.tensor(lens), 200, chunk_size=2048)
    modes, w, ab = scoring.lexical_epilogues(grid, torch.tensor(q), stats)
    w = w.clone()
    w[:, 1, 0] *= 1.5
    w[:, 2, 0] *= 0.5
    w[:, 1, 2] = w[:, 0, 0]
    w[:, 6, 0], w[:, 7, 0], w[:, 8, 1] = 0.0, -0.0, 0.0
    got = _every_layout(q, toks, lens, w, ab, modes, 200)
    assert got["term_uses"] > got["term_scores"] > 0, got


@pytest.mark.cuda
def test_cuda_kernel_shares_terms_across_a_mixed_grid():
    """ql, bm25 and tf-idf models in one call, one bm25 with a norm that is
    negative for rows under 20 tokens (where its zero path takes the general
    expression, so every list of the row scores each slot itself)."""
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    q, toks, lens = _lexical_inputs(962, 4096, 40, 48, 6, 150, 128)
    q[::2, 0] = _frequent(toks)
    stats = anchors.collection_stats(torch.tensor(toks), torch.tensor(lens), 150, chunk_size=4096)
    modes, w, ab = scoring.lexical_epilogues(grid, torch.tensor(q), stats)
    assert [m.mode for m in modes] == ["ql", "ql", "bm25", "bm25", "tfidf"]
    ab = ab.clone()
    ab[3] = torch.tensor([-0.3, 1.0 / 64])  # never 0 nor -tf: -0.3 is no multiple of 1/64
    got = _every_layout(q, toks, lens, w, ab, modes, 150)
    assert got["term_uses"] > got["term_scores"], got


@pytest.mark.cuda
def test_cuda_kernel_with_no_shared_term_scores_each_slot():
    """Queries whose 128 terms are all distinct: one score a matched slot,
    as many as scoring each slot on its own."""
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    _, toks, lens = _lexical_inputs(963, 4096, 64, 1, 1, 200, 64)
    q = np.random.default_rng(963).permutation(200)[:128].reshape(32, 4).astype(np.int32)
    stats = anchors.collection_stats(torch.tensor(toks), torch.tensor(lens), 200, chunk_size=4096)
    modes, w, ab = scoring.lexical_epilogues(grid, torch.tensor(q), stats)
    got = _every_layout(q, toks, lens, w, ab, modes, 200)
    assert got["term_uses"] == got["term_scores"] > 0, got


@pytest.mark.cuda
def test_cuda_kernel_keeps_its_bits_on_signed_infinite_and_long_queries():
    """Weights and norms at the edges of the epilogue's zero path, in one
    launch beside ordinary lists: PAD-padded queries of mixed lengths (their
    pads weigh +0), a list with a negative weight, one with a -0 weight, one
    with an infinite weight (its term is in every non-empty row, so no score
    is NaN), a bm25 model whose norm is not positive on short rows; then a
    block of queries of 33 terms. Every layout keeps the plain version's
    bits and the term counters `_term_counts` predicts."""
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    vocab = 153  # 150 drawn, then three terms of one query each
    q, toks, lens = _lexical_inputs(964, 4096, 40, 48, 8, 150, 128)
    rows = np.arange(len(toks))
    toks[:, 0] = np.where(lens > 0, 152, toks[:, 0])
    toks[:, 1] = np.where((lens > 1) & (rows % 2 == 0), 150, toks[:, 1])
    toks[:, 2] = np.where((lens > 2) & (rows % 3 == 0), 151, toks[:, 2])
    q[3, 0], q[4, 1], q[5, 0] = 150, 151, 152
    stats = anchors.collection_stats(torch.tensor(toks), torch.tensor(lens), vocab,
                                     chunk_size=4096)
    modes, w, ab = scoring.lexical_epilogues(grid, torch.tensor(q), stats)
    w = w.clone()
    w[:, 3, 0], w[:, 4, 1], w[:, 5, 0] = -0.25, -0.0, float("inf")
    ab = ab.clone()
    ab[3] = torch.tensor([-0.3, 1.0 / 64])  # never 0 nor -tf: -0.3 is no multiple of 1/64
    got = _every_layout(q, toks, lens, w, ab, modes, vocab)
    assert got["term_uses"] > got["term_scores"] > 0, got
    q33 = _lexical_inputs(965, 1, 1, 12, 33, 150, 0)[0]
    modes, w, ab = scoring.lexical_epilogues(grid, torch.tensor(q33), stats)
    got = _every_layout(q33, toks, lens, w, ab, modes, vocab)
    assert got["term_uses"] >= got["term_scores"] > 0, got


@pytest.mark.cuda
def test_cuda_traced_lexical_session_carries_its_blocks_counts():
    """A traced block's ``session.search`` span carries its own launch's
    counts (an untraced block before it counts nowhere)."""
    from repro_torch import obs
    from repro_torch.serve.session import LexicalSession

    dev = _card()
    q, toks, lens = _lexical_inputs(950, 4096, 24, 8, 4, 50, 0)
    session = LexicalSession(toks, lens, "ql_lm", k=20, chunk_size=4096, vocab=50,
                             token_pack="none", device=dev)
    untraced = session.search(q)
    with obs.session() as (tr, _):
        traced = [session.search(q) for _ in range(2)]
    first, second = (s.attrs for s in tr.spans("session.search"))
    assert first["passes_final"] == second["passes_final"] > 0, (first, second)
    assert 0 < first["flush_cycles"] <= first["loop_cycles"]
    for state in traced:
        assert torch.equal(state.ids, untraced.ids)
        assert torch.equal(state.scores.view(torch.int32), untraced.scores.view(torch.int32))


@pytest.mark.cuda
def test_cuda_lexical_session_launches_two_blocks_before_collecting():
    """Two blocks launched back to back behind a busy card return without a
    host sync and before the card reaches them; collected, each gives its
    own ``search`` bytes in host memory of its own, and, traced, each
    block's ``session.search`` carries the counts of that block run alone."""
    from repro_torch import obs
    from repro_torch.serve.session import LexicalSession

    dev = _card()
    qa, toks, lens = _lexical_inputs(951, 4096, 24, 8, 4, 50, 0)
    qb = _lexical_inputs(952, 4096, 24, 8, 6, 50, 0)[0]
    session = LexicalSession(toks, lens, "ql_lm", k=20, chunk_size=4096, vocab=50,
                             token_pack="none", device=dev)
    want = [session.search(q) for q in (qa, qb)]
    with obs.session() as (tr, _):
        [session.search(q) for q in (qa, qb)]
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)  # the card is busy for about a second
        torch.cuda.set_sync_debug_mode("error")
        try:
            handles = [session.launch(q) for q in (qa, qb)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not any(h.done() for h in handles)
        got = [session.collect(h) for h in handles]
    assert all(h.done() for h in handles)
    for g, w in zip(got, want):
        assert not g.scores.is_pinned() and not g.ids.is_pinned()
        assert torch.equal(g.ids, w.ids)
        assert torch.equal(g.scores.view(torch.int32), w.scores.view(torch.int32))
    searches = [s.attrs for s in tr.spans("session.search")]
    alone, launched = searches[:2], searches[2:]
    exact = ("passes_final", "term_scores", "term_uses")
    assert alone[0]["term_scores"] != alone[1]["term_scores"], alone
    for a, b in zip(alone, launched):
        assert {n: b[n] for n in exact} == {n: a[n] for n in exact}, (a, b)
        assert 0 < b["flush_cycles"] <= b["loop_cycles"]


# n_d, L_d, vocab, token_pack, first row (rows before it sliced off), k, block_d, tile_d
PACKED_CASES = [
    (301, 23, 200, "8", 1, 37, 300, 16),  # uint8 rows starting off a 4-byte boundary
    (2048, 128, 255, "auto", 0, 50, 512, 48),
    (1025, 23, 60_000, "16", 1, 40, 512, 40),  # uint16 rows off a 4-byte boundary
    (512, 300, 2048, "auto", 0, 30, 256, 32),
    (1024, 23, 1, "bitpack", 0, 20, 256, 16),  # 1 bit: every token is term 0
    (4096, 128, 65_536, "auto", 0, 100, 1024, 33),  # mirex's 17 bits
    (2048, 300, 200_000, "auto", 0, 40, 512, 16),  # 18 bits
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PACKED_CASES, ids=lambda c: f"{c[3]}-v{c[2]}-L{c[1]}")
def test_cuda_packed_kernel_matches_unpacked_kernel_bitwise(case):
    """The packed-tile path (uint8 / uint16 rows, bit-planes) against the
    unpacked kernel on the unpacked tokens and against the plain version:
    equal to the bit, with zero-length rows and a launch counted each."""
    dev = _card()
    n_d, l_d, vocab, mode, first, k, block_d, tile_d = case
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    q, toks, lens = _lexical_inputs(800 + n_d, n_d, l_d, 9, 4, vocab, n_d // 10)
    spec = packing.make_spec(vocab, l_d, mode)
    d, dl, qt = (torch.tensor(x, device=dev) for x in (toks, lens, q))
    p = torch.as_tensor(packing.pack_tokens(toks, spec), device=dev)
    d, dl, p = d[first:], dl[first:], p[first:]
    stats = anchors.collection_stats(d, dl, vocab, chunk_size=d.shape[0])
    modes, w, ab = scoring.lexical_epilogues(grid, qt, stats)
    before = ops.LAUNCHES["lexical_scan_topk"]
    ks, ki = ops.lexical_scan_topk(qt, w, ab, p, dl, modes=modes, k=k, block_d=block_d,
                                   tile_d=tile_d, pack_spec=spec)
    assert ops.LAUNCHES["lexical_scan_topk"] == before + 1
    for other in (
        ops.lexical_scan_topk(qt, w, ab, d, dl, modes=modes, k=k, block_d=block_d,
                              tile_d=tile_d),
        lexical_scan.lexical_scan_topk_ref(qt, w, ab, p, dl, modes=modes, k=k,
                                           block_d=block_d, tile_d=tile_d, pack_spec=spec),
    ):
        assert torch.equal(ki, other[1])
        assert torch.equal(ks.view(torch.int32), other[0].view(torch.int32))


@pytest.mark.cuda
def test_cuda_packed_lexical_session_matches_unpacked():
    """A session with its corpus resident in 17-bit planes answers as the
    unpacked session does, bit for bit, in the serving buckets."""
    from repro_torch.data import synthetic
    from repro_torch.serve import LexicalSession

    _card()
    corpus = synthetic.make_corpus(n_docs=16_384, vocab=65_536, max_len=128, seed=3)
    kw = {"k": 1000, "chunk_size": 16_384, "vocab": 65_536}
    plain = LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", **kw)
    packed = LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", token_pack="auto", **kw)
    assert packed.pack_mode == "bitpack"
    assert packed.resident_corpus_bytes == 16_384 * (68 + 1) * 4
    for n in (8, 128):
        q = synthetic.make_queries(corpus, n_queries=n, seed=n)
        before = ops.LAUNCHES["lexical_scan_topk"]
        got, want = packed.search(q), plain.search(q)
        assert ops.LAUNCHES["lexical_scan_topk"] == before + 2
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32))


def _rows(seed, shape, dtype, dev):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.tensor(x, device=dev).to(dtype)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    dev = _card()
    cases = [  # n_q, n_d, dim, k, block_d, dtype
        (8, 256, 64, 5, 128, torch.float32), (16, 512, 128, 32, 128, torch.bfloat16),
        (128, 1024, 256, 32, 128, torch.float32), (5, 64, 32, 100, 64, torch.float32),
        (3, 4096, 64, 1000, 512, torch.float32), (70, 2048, 256, 64, 256, torch.bfloat16),
    ]
    for n, (nq, nd, dim, k, block_d, dtype) in enumerate(cases):
        q, d = _rows(n, (nq, dim), dtype, dev), _rows(100 + n, (nd, dim), dtype, dev)
        before = ops.LAUNCHES["score_topk"]
        ks, ki = ops.score_topk(q, d, k=k, block_d=block_d)
        ps, pi = score_topk.score_topk_ref(q, d, k=k + DEEPER, block_d=block_d)
        assert ops.LAUNCHES["score_topk"] == before + 1
        assert_rankings_close(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), what=str(cases[n]))
    rng = np.random.default_rng(11)
    q = torch.tensor(rng.integers(-3, 4, (40, 128)).astype(np.float32), device=dev)
    q[3] = 0.0
    d = torch.tensor(rng.integers(-3, 4, (8192, 128)).astype(np.float32), device=dev)
    ks, ki = ops.score_topk(q, d, k=300, block_d=1024)
    ps, pi = score_topk.score_topk_ref(q, d, k=300, block_d=1024)
    assert torch.equal(ki, pi)
    assert torch.equal((ks + 0.0).view(torch.int32), (ps + 0.0).view(torch.int32))
    assert torch.equal(ki[3], torch.arange(300, dtype=torch.int32, device=dev))
    # rows narrower than the kernel's 128-byte stage (8 and 40 float32, 24
    # bfloat16) are zero-padded by the wrapper: the plain version's bits
    for dim, dtype in ((8, torch.float32), (40, torch.float32), (24, torch.bfloat16)):
        qn, dn = q[:, :dim].to(dtype).contiguous(), d[:, :dim].to(dtype).contiguous()
        ks, ki = ops.score_topk(qn, dn, k=50, block_d=1024)
        ps, pi = score_topk.score_topk_ref(qn, dn, k=50, block_d=1024)
        assert torch.equal(ki, pi), dim
        assert torch.equal((ks + 0.0).view(torch.int32), (ps + 0.0).view(torch.int32)), dim


@pytest.mark.cuda
def test_cuda_score_topk_serving_buckets():
    """The serving buckets 8, 64 and 128 at k 1000 (one pass over the corpus
    each), against the plain version; a block with zero query rows; integer-
    valued rows in float32 and bfloat16 bit-equal; and a query's scores and
    ids the same bits whichever bucket it runs in."""
    dev = _card()
    n_d, dim, k = 16_384, 256, 1000
    d = _rows(500, (n_d, dim), torch.float32, dev)
    q = _rows(501, (128, dim), torch.float32, dev)
    q[5] = 0.0
    runs = {}
    for n_q in (8, 64, 128):
        ks, ki = ops.score_topk(q[:n_q].contiguous(), d, k=k, block_d=1024)
        ps, pi = score_topk.score_topk_ref(q[:n_q].contiguous(), d, k=k + DEEPER, block_d=1024)
        assert_rankings_close(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), what=f"bucket {n_q}")
        assert torch.equal(ki[5], torch.arange(k, dtype=torch.int32, device=dev))
        runs[n_q] = (ks, ki)
    for n_q in (8, 64):
        assert torch.equal(runs[n_q][1], runs[128][1][:n_q])
        assert torch.equal(runs[n_q][0].view(torch.int32), runs[128][0][:n_q].view(torch.int32))
    rng = np.random.default_rng(502)
    for dtype in (torch.float32, torch.bfloat16):
        qi = torch.tensor(rng.integers(-3, 4, (128, dim)).astype(np.float32), device=dev).to(dtype)
        di = torch.tensor(rng.integers(-3, 4, (n_d, dim)).astype(np.float32), device=dev).to(dtype)
        ks, ki = ops.score_topk(qi, di, k=k, block_d=4096)
        ps, pi = score_topk.score_topk_ref(qi, di, k=k, block_d=4096)
        assert torch.equal(ki, pi), dtype
        assert torch.equal((ks + 0.0).view(torch.int32), (ps + 0.0).view(torch.int32)), dtype


@pytest.mark.cuda
def test_cuda_lexical_scan_128_queries_bitwise():
    """128 queries (repeated terms across queries) over many tiles and every
    epilogue: bit-equal to the plain version."""
    dev = _card()
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    q, toks, lens = _lexical_inputs(600, 8192, 40, 128, 4, 60, 300)
    q[64:] = q[:64]  # the second half repeats the first
    d, dl, qt = (torch.tensor(x, device=dev) for x in (toks, lens, q))
    stats = anchors.collection_stats(d, dl, 60, chunk_size=8192)
    modes, w, ab = scoring.lexical_epilogues(grid, qt, stats)
    for block_d, tile_d in ((8192, 16), (1024, 64)):
        ks, ki = ops.lexical_scan_topk(qt, w, ab, d, dl, modes=modes, k=200,
                                       block_d=block_d, tile_d=tile_d)
        ps, pi = lexical_scan.lexical_scan_topk_ref(qt, w, ab, d, dl, modes=modes, k=200,
                                                    block_d=block_d, tile_d=tile_d)
        assert torch.equal(ki, pi), (block_d, tile_d)
        assert torch.equal(ks.view(torch.int32), ps.view(torch.int32)), (block_d, tile_d)


@pytest.mark.cuda
def test_cuda_scan_kernels_on_two_streams():
    """Calls of each scan kernel on two streams at once equal the same calls
    made one after the other: every call's thresholds, locks and buffers are
    its own."""
    dev = _card()
    grid = [scoring.make_variant(b, **p) for b, p in GRID]
    q, toks, lens = _lexical_inputs(700, 4096, 32, 32, 4, 50, 100)
    d, dl, qt = (torch.tensor(x, device=dev) for x in (toks, lens, q))
    stats = anchors.collection_stats(d, dl, 50, chunk_size=4096)
    modes, w, ab = scoring.lexical_epilogues(grid, qt, stats)
    dq = [_rows(710 + n, (64, 128), torch.float32, dev) for n in range(2)]
    dd = _rows(720, (8192, 128), torch.float32, dev)

    def both(n):
        lex = ops.lexical_scan_topk(qt[n::2].contiguous(), w[:, n::2].contiguous(), ab, d, dl,
                                    modes=modes, k=300, block_d=1024)
        return lex, ops.score_topk(dq[n], dd, k=500, block_d=1024)

    alone = [both(n) for n in range(2)]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    together = []
    for n, stream in enumerate(streams):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            together.append([both(n) for _ in range(3)])
    torch.cuda.synchronize()
    for n in range(2):
        for got in together[n]:
            for (gs, gi), (ws, wi) in zip(got, alone[n]):
                assert torch.equal(gi, wi) and torch.equal(gs.view(torch.int32), ws.view(torch.int32))


# b, s, h, kv, hd, causal, window, cap, block_q, block_k, dtype
FLASH_CASES = [
    (2, 128, 4, 4, 32, True, None, None, 64, 64, torch.float32),
    (2, 256, 4, 2, 64, True, 64, None, 64, 64, torch.float32),
    (2, 256, 8, 1, 32, True, 32, 50.0, 64, 64, torch.float32),
    (1, 256, 8, 4, 256, True, 100, 50.0, 128, 128, torch.float32),
    (1, 256, 4, 2, 80, False, 60, None, 64, 64, torch.float32),
    (1, 128, 4, 2, 32, True, None, None, 64, 64, torch.bfloat16),
    (2, 256, 4, 2, 64, True, 64, 30.0, 64, 64, torch.bfloat16),
    (1, 512, 8, 4, 256, True, 200, 50.0, 128, 128, torch.bfloat16),
    (1, 512, 8, 4, 256, True, None, 50.0, 64, 64, torch.bfloat16),
    (1, 512, 8, 2, 80, True, 100, None, 128, 64, torch.bfloat16),
    (1, 256, 32, 16, 128, False, None, 50.0, 128, 128, torch.bfloat16),
    # the wgmma route (head_dim 64 / 128 / 256): one 128-row block, S under
    # one block, no causal mask, windows that cross 64- and 128-key tiles,
    # and a ring that wraps many times
    (2, 128, 4, 2, 64, False, None, None, 64, 64, torch.bfloat16),
    (2, 64, 4, 2, 64, True, None, 50.0, 64, 64, torch.bfloat16),
    (2, 256, 8, 2, 64, True, 70, 30.0, 64, 64, torch.bfloat16),
    (1, 512, 4, 4, 128, False, 200, None, 128, 128, torch.bfloat16),
    (1, 384, 8, 2, 128, True, 130, 50.0, 128, 128, torch.bfloat16),
    (1, 128, 8, 4, 256, False, None, 50.0, 128, 128, torch.bfloat16),
    (1, 384, 8, 4, 256, True, 100, 50.0, 128, 128, torch.bfloat16),
    (1, 1024, 8, 4, 256, True, None, None, 128, 128, torch.bfloat16),
]
# b, s, kv, g, hd, t, window, cap, block_s, dtype
DECODE_CASES = [
    (2, 512, 2, 2, 32, 300, None, None, 128, torch.float32),
    (2, 1024, 4, 1, 32, 1023, 128, None, 128, torch.float32),
    (2, 512, 1, 8, 32, 0, None, None, 128, torch.float32),
    (2, 512, 1, 8, 32, 0, None, None, 128, torch.bfloat16),
    (2, 700, 8, 4, 80, 650, 300, 50.0, 256, torch.bfloat16),
    (2, 1100, 4, 2, 256, 1030, None, 50.0, 512, torch.bfloat16),
    (2, 1100, 4, 2, 256, 1030, 512, 50.0, 256, torch.float32),
]


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain_version():
    dev = _card()
    for n, (b, s, h, kv, hd, causal, window, cap, bq, bk, dtype) in enumerate(FLASH_CASES):
        q = _rows(n, (b, s, h, hd), dtype, dev)
        k, v = _rows(50 + n, (b, s, kv, hd), dtype, dev), _rows(90 + n, (b, s, kv, hd), dtype, dev)
        before = ops.LAUNCHES["flash_attention"]
        got = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                                  block_q=bq, block_k=bk)
        assert ops.LAUNCHES["flash_attention"] == before + 1
        want = flash_attn.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
        tol = 3e-4 if dtype == torch.float32 else 3e-2
        atol = 3e-5 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=atol,
                                   msg=str(FLASH_CASES[n]))
    q = torch.zeros((1, 256, 4, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())


@pytest.mark.cuda
def test_cuda_flash_decode_matches_plain_version():
    dev = _card()
    for n, (b, s, kv, g, hd, t, window, cap, bs, dtype) in enumerate(DECODE_CASES):
        q = _rows(n, (b, kv * g, hd), dtype, dev)
        kc, vc = _rows(50 + n, (b, s, kv, hd), dtype, dev), _rows(90 + n, (b, s, kv, hd), dtype, dev)
        before = ops.LAUNCHES["flash_decode"]
        got = ops.flash_decode(q, kc, vc, t, window=window, cap=cap, block_s=bs)
        assert ops.LAUNCHES["flash_decode"] == before + 1
        want = flash_decode.flash_decode_ref(q, kc, vc, t, window=window, cap=cap)
        tol = 3e-4 if dtype == torch.float32 else 3e-2
        atol = 3e-5 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=atol,
                                   msg=str(DECODE_CASES[n]))
    with pytest.raises(ValueError, match="outside a cache"):
        ops.flash_decode(q, kc, vc, s)


@pytest.mark.cuda
def test_cuda_flash_decode_device_t_matches_plain_version():
    """``t`` as a device int32 at 0, at both sides of a split edge and at the
    last slot, windows narrower than one split and across one: the kernel
    equals its host-int call bit for bit and the plain version within the
    reference's tolerances."""
    dev = _card()
    b, s, kv, g, hd = 2, 1100, 4, 2, 256
    block, _ = flash_decode.split_plan(s, None, b * kv, _build.sm_count(dev), 512)
    for n, dtype in enumerate((torch.float32, torch.bfloat16)):
        q = _rows(200 + n, (b, kv * g, hd), dtype, dev)
        kc, vc = _rows(210 + n, (b, s, kv, hd), dtype, dev), _rows(220 + n, (b, s, kv, hd), dtype, dev)
        for window in (None, 5, block + 3):
            for t in (0, block - 1, block, s - 1):
                t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
                got = ops.flash_decode(q, kc, vc, t_dev, window=window, cap=50.0)
                host = ops.flash_decode(q, kc, vc, t, window=window, cap=50.0)
                assert torch.equal(got, host), (dtype, window, t)
                want = flash_decode.flash_decode_ref(q, kc, vc, t, window=window, cap=50.0)
                tol = 3e-4 if dtype == torch.float32 else 3e-2
                atol = 3e-5 if dtype == torch.float32 else 3e-2
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=atol,
                                           msg=str((dtype, window, t)))
    assert flash_decode.take_error(dev) == 0
    # a device t outside the cache: NaN outputs and the error word, no raise
    bad = ops.flash_decode(q, kc, vc, torch.tensor(s, dtype=torch.int32, device=dev))
    assert torch.isnan(bad.float()).all()
    assert flash_decode.take_error(dev) == 1
    assert flash_decode.take_error(dev) == 0


@pytest.mark.cuda
def test_cuda_flash_decode_partials_match_plain_version_per_shard():
    """A cache cut into 4 shards (each a view of its positions): every
    shard's ``(o, lse)`` at positions ``<= t - 1`` against the plain
    version (o within the reference's tolerances, lse within 1e-4 / 1e-5),
    a shard with no allowed position ``o = 0`` and ``lse = -inf`` with no
    NaN, and the shards merged by log-sum-exp the whole cache's partial."""
    from repro_torch.models import attention

    dev = _card()
    b, s, kv, g, hd, n = 2, 1024, 4, 2, 256, 4
    s_loc = s // n
    for m, dtype in enumerate((torch.float32, torch.bfloat16)):
        q = _rows(300 + m, (b, kv * g, hd), dtype, dev)
        kc, vc = _rows(310 + m, (b, s, kv, hd), dtype, dev), _rows(320 + m, (b, s, kv, hd), dtype, dev)
        tol = 3e-4 if dtype == torch.float32 else 3e-2
        atol = 3e-5 if dtype == torch.float32 else 3e-2
        for t, window, cap in ((0, None, None), (300, None, 50.0), (512, 100, 50.0),
                               (1023, 200, None), (700, None, None)):
            t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
            parts = []
            for i in range(n):
                cols = slice(i * s_loc, (i + 1) * s_loc)
                before = ops.LAUNCHES["flash_decode"]
                o, lse = ops.flash_decode(q, kc[:, cols], vc[:, cols], t_dev, window=window,
                                          cap=cap, pos0=i * s_loc, cache_len=s,
                                          include_t=False, lse=True)
                assert ops.LAUNCHES["flash_decode"] == before + 1
                want_o, want_lse = flash_decode.flash_decode_ref(
                    q, kc[:, cols], vc[:, cols], t, window=window, cap=cap, pos0=i * s_loc,
                    include_t=False, lse=True)
                assert not torch.isnan(o).any() and not torch.isnan(lse).any()
                lo, hi = flash_decode.allowed_range(t, window, pos0=i * s_loc, s=s_loc,
                                                    include_t=False)
                if hi < lo:
                    assert torch.equal(o, torch.zeros_like(o)) and torch.isneginf(lse).all()
                torch.testing.assert_close(o, want_o, rtol=tol, atol=atol, msg=str((t, i)))
                torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5, msg=str((t, i)))
                parts.append(attention.kernel_partial(o, lse))
            if t > 0:
                whole, _ = flash_decode.flash_decode_ref(q, kc, vc, t, window=window, cap=cap,
                                                         include_t=False, lse=True)
                _, l_g, o_g = attention.lse_combine(*(torch.stack(x) for x in zip(*parts)))
                torch.testing.assert_close(o_g / l_g[..., None], whole, rtol=tol, atol=atol)
    assert flash_decode.take_error(dev) == 0


@pytest.mark.cuda
def test_cuda_sequence_sharded_serve_step_matches_the_cpu_without_host_sync():
    """The reduced gemma2-2b on a (1, 4) mesh of the card (the cache's
    sequence over 4 shards, each a view): logits within 1e-4 / 1e-5 of the
    same step on a (1, 4) CPU mesh, and with ``t`` a device int32 no host
    sync."""
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tfm

    dev = _card()
    cfg = reduced_config("gemma2-2b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    steps, caches = {}, {}
    for d in ("cpu", "cuda"):
        mesh = make_test_mesh(1, 4, device=d)
        steps[d] = tfm.make_serve_step(tfm.make_context(cfg, mesh, rules_for_mesh(mesh)), batch=2)
        caches[d] = tfm.init_cache(cfg, 2, 32, device=d)
    on_card = {k: (v.to(dev) if isinstance(v, torch.Tensor) else {n: w.to(dev) for n, w in
                                                                   v.items()})
               for k, v in params.items()}
    tok = torch.ones(2, dtype=torch.int64)
    t_dev = torch.zeros((), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    for t in range(20):
        want, caches["cpu"] = steps["cpu"](params, caches["cpu"], tok, t)
        tok_d = tok.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, caches["cuda"] = steps["cuda"](on_card, caches["cuda"], tok_d, t_dev)
            t_dev.add_(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5, msg=str(t))
        tok = torch.argmax(want, dim=-1)
    assert flash_decode.take_error(dev) == 0


@pytest.mark.cuda
def test_cuda_flash_decode_graph_replays_at_two_positions():
    """One call captured in a CUDA graph, replayed after writing two values
    of ``t`` into the same device tensor: each replay equals the plain
    version at that ``t``."""
    dev = _card()
    b, s, kv, g, hd = 4, 2048, 4, 2, 256
    q = _rows(300, (b, kv * g, hd), torch.bfloat16, dev)
    kc, vc = _rows(301, (b, s, kv, hd), torch.bfloat16, dev), _rows(302, (b, s, kv, hd), torch.bfloat16, dev)
    t_dev = torch.tensor(7, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # first calls (build, attributes) outside the capture
        ops.flash_decode(q, kc, vc, t_dev, window=1000, cap=50.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_decode(q, kc, vc, t_dev, window=1000, cap=50.0)
    for t in (1500, 300):
        t_dev.fill_(t)
        graph.replay()
        torch.cuda.synchronize()
        want = flash_decode.flash_decode_ref(q, kc, vc, t, window=1000, cap=50.0)
        torch.testing.assert_close(out.float(), want.float(), rtol=3e-2, atol=3e-2, msg=str(t))


@pytest.mark.cuda
def test_cuda_flash_decode_graph_and_streams_share_no_state():
    """A call captured at 8 (batch, KV head) pairs, then an eager call at 16
    and calls on two streams at once, then the replay: every output equals
    the plain version (the counters that find each pair's merging CTA are
    the call's own, never a shared buffer a graph or another stream holds)."""
    dev = _card()
    s, kv, g, hd = 2048, 4, 2, 256
    bf16 = torch.bfloat16

    def inputs(seed, b):
        return (_rows(seed, (b, kv * g, hd), bf16, dev), _rows(seed + 1, (b, s, kv, hd), bf16, dev),
                _rows(seed + 2, (b, s, kv, hd), bf16, dev))

    def check(got, args, t, msg):
        want = flash_decode.flash_decode_ref(*args, t, cap=50.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2, msg=msg)

    small, large = inputs(400, 2), inputs(410, 4)
    t_dev = torch.tensor(1800, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(*small, t_dev, cap=50.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.flash_decode(*small, t_dev, cap=50.0)
    check(ops.flash_decode(*large, t_dev, cap=50.0), large, 1800, "16 pairs after the capture")
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for stream, args in zip(streams, (small, large)):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append([ops.flash_decode(*args, 2047 - i, cap=50.0) for i in range(8)])
    torch.cuda.synchronize()
    for args, got in zip((small, large), outs):
        for i, o in enumerate(got):
            check(o, args, 2047 - i, f"two streams, t {2047 - i}")
    graph.replay()
    torch.cuda.synchronize()
    check(replayed, small, 1800, "replay after the larger call")


@pytest.mark.cuda
def test_cuda_lm_serving_matches_the_cpu():
    """The reduced gemma2-2b in float32 (head_dim 16: the float32 kernels)
    on the card and on the CPU, from the same weights: prefill logits and
    cache, then 6 greedy decode steps past the window."""
    from repro_torch.configs import reduced_config
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tfm

    dev = _card()
    cfg = reduced_config("gemma2-2b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = {k: v.to(dev) if isinstance(v, torch.Tensor) else {n: w.to(dev) for n, w in v.items()}
               for k, v in params.items()}
    tokens = torch.tensor(synthetic.make_lm_batch(batch=2, seq_len=64, vocab=cfg.vocab)["tokens"])
    results = {}
    for where, p in (("cpu", params), ("cuda", on_card)):
        before = dict(ops.LAUNCHES)
        logits, cache = tfm.make_prefill_step(cfg)(p, tokens.to(p["embed"].device))
        full = tfm.init_cache(cfg, 2, 80, device=p["embed"].device)
        full["k"][:, :, :64], full["v"][:, :, :64] = cache["k"], cache["v"]
        step = tfm.make_serve_step(cfg, batch=2)
        seen = [logits.cpu()]
        tok = torch.argmax(logits, dim=-1)
        for t in range(64, 70):
            logits, full = step(p, full, tok, t)
            tok = torch.argmax(logits, dim=-1)
            seen.append(logits.cpu())
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        results[where] = (seen, full["k"].cpu(), launched)
    assert results["cpu"][2] == {k: 0 for k in ops.LAUNCHES}
    assert results["cuda"][2]["flash_attention"] == cfg.n_layers
    assert results["cuda"][2]["flash_decode"] == cfg.n_layers * 6
    for a, b in zip(results["cpu"][0], results["cuda"][0]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(results["cuda"][1], results["cpu"][1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_serve_step_with_device_t_makes_no_host_sync():
    """The reduced gemma2-2b on the card: steps with ``t`` a device int32
    (advanced in place) run under ``set_sync_debug_mode("error")`` and give
    the host-int steps' logits, tokens and cache bit for bit."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tfm

    dev = _card()
    cfg = reduced_config("gemma2-2b")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = tfm.make_serve_step(cfg, batch=2)
    caches = [tfm.init_cache(cfg, 2, 24, device=dev), tfm.init_cache(cfg, 2, 24, device=dev)]
    tok_h = tok_d = torch.ones(2, dtype=torch.int64, device=dev)
    t_dev = torch.zeros((), dtype=torch.int32, device=dev)
    step(params, tfm.init_cache(cfg, 2, 24, device=dev), tok_d, t_dev)  # first calls: builds
    torch.cuda.synchronize()
    for t in range(12):
        want, caches[0] = step(params, caches[0], tok_h, t)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, caches[1] = step(params, caches[1], tok_d, t_dev)
            tok_d = torch.argmax(got, dim=-1)
            t_dev.add_(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        tok_h = torch.argmax(want, dim=-1)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), t
        assert torch.equal(tok_d, tok_h), t
    for name in ("k", "v"):
        assert torch.equal(caches[0][name], caches[1][name])


def _scan_collection(dev, seed=900, n_d=8192, l_d=32, n_q=16, vocab=300):
    """A lexical corpus on the host and on the card, its statistics and
    queries on the card, and a three-model grid."""
    q, toks, lens = _lexical_inputs(seed, n_d, l_d, n_q, 4, vocab, n_d // 16)
    host = (torch.tensor(toks), torch.tensor(lens))
    docs = tuple(x.to(dev) for x in host)
    stats = anchors.collection_stats(*docs, vocab, chunk_size=1024)
    grid = [scoring.make_variant(b, **p) for b, p in GRID[:3]]
    return host, docs, stats, torch.tensor(q, device=dev), grid


@pytest.mark.cuda
def test_cuda_prefetch_host_to_card_on_a_copy_stream():
    """A host corpus streams to the card segment by segment, on the
    producer's copy stream: every segment equals its slice, pinned source or
    not, and the card holds at most depth + 1 segments of it at a time."""
    from repro_torch.core import pipeline

    dev = _card()
    host = (torch.arange(64 * 4096 * 16, dtype=torch.int32).reshape(64 * 4096, 16),
            torch.arange(64 * 4096, dtype=torch.int32))
    segs = pipeline.segments(64 * 4096, 4096, 4)  # 16 segments of 1 MiB + lengths
    seg_bytes = 4 * 4096 * (16 + 1) * 4
    for source in (host, tuple(x.pin_memory() for x in host)):
        for depth in (1, 2, 3):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for (a, b), seg in zip(segs, pipeline.prefetch_segments(source, segs, device=dev,
                                                                     depth=depth)):
                assert seg[0].device.type == "cuda"
                s0 = seg[0].sum(dtype=torch.int64)  # read on the consumer's stream
                assert torch.equal(seg[0].cpu(), host[0][a:b]) and torch.equal(seg[1].cpu(),
                                                                               host[1][a:b])
                assert int(s0) == int(host[0][a:b].sum(dtype=torch.int64))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            assert peak <= (depth + 1) * seg_bytes + (1 << 20), (depth, peak)


@pytest.mark.cuda
def test_cuda_snapshot_checkpoint_while_the_next_fold_runs(tmp_path):
    """The pipelined job snapshots each state on the fold's stream and
    launches the next fold at once; its checkpoints are the synchronous
    job's byte for byte. The snapshot alone keeps its value when the
    state's block is reused at once on the same stream."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import cluster

    dev = _card()
    host, docs, stats, q, grid = _scan_collection(dev)
    kw = dict(k=200, chunk_size=1024, segment_chunks=1, stats=stats)
    runs = {}
    for pipelined in (False, True):
        out = tmp_path / str(pipelined)
        runs[pipelined] = cluster.run_scan_job(q, docs, grid, ckpt_dir=str(out),
                                               keep_checkpoints=8, pipelined=pipelined, **kw)
    def files(root):
        return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}

    assert files(tmp_path / "False") == files(tmp_path / "True")
    assert torch.equal(runs[True].state.ids, runs[False].state.ids)

    state = runs[True].state
    want = (state.scores.cpu(), state.ids.cpu())
    snap = ckpt.snapshot(state)
    del state, runs
    for _ in range(4):  # reuse the freed blocks on the same stream at once
        torch.full(want[0].shape, -7.0, device=dev), torch.full(want[1].shape, -7, device=dev,
                                                                dtype=torch.int32)
    got = snap.wait()
    assert torch.equal(got.scores, want[0]) and torch.equal(got.ids, want[1])


@pytest.mark.cuda
def test_cuda_two_workers_on_two_streams_are_bit_equal(tmp_path):
    """Two scheduler workers on one card (two CUDA streams), the corpus on
    the card or streamed from the host, with a seeded chaos schedule: the
    merged state is the synchronous one-shard run's, bit for bit."""
    from repro_torch import cluster
    from repro_torch.cluster import FaultSchedule

    dev = _card()
    host, docs, stats, q, grid = _scan_collection(dev, seed=901)
    kw = dict(k=200, chunk_size=1024, segment_chunks=1, stats=stats)
    want = cluster.run_sharded_scan_job(q, docs, grid, n_shards=1, pipelined=False, **kw)
    for n, corpus in enumerate((docs, tuple(x.pin_memory() for x in host))):
        for seed in (0, 1):
            sched = FaultSchedule.random(seed, n_shards=4, n_segments=2)
            got = cluster.run_sharded_scan_job(
                q, corpus, grid, n_shards=4, devices=[dev], max_workers=2, max_retries=2,
                speculative=True, faults=sched, backoff_base=0.01,
                ckpt_dir=str(tmp_path / f"{n}-{seed}"), **kw,
            )
            assert got.scheduler.n_workers == 2
            assert torch.equal(got.state.ids, want.state.ids), (n, seed)
            assert torch.equal(got.state.scores.view(torch.int32),
                               want.state.scores.view(torch.int32)), (n, seed)


@pytest.mark.cuda
def test_cuda_launches_count_exactly_under_threads():
    """Two workers launch the lexical kernel from two threads: the count is
    one a segment folded, none lost."""
    from repro_torch import cluster

    dev = _card()
    _, docs, stats, q, grid = _scan_collection(dev, seed=902)
    ops.reset_launches()
    job = cluster.run_sharded_scan_job(q, docs, grid, k=100, chunk_size=512, segment_chunks=1,
                                       stats=stats, n_shards=8, devices=[dev], max_workers=2)
    torch.cuda.synchronize()
    assert job.segments_run == 16
    assert ops.LAUNCHES["lexical_scan_topk"] == job.segments_run


@pytest.mark.cuda
def test_cuda_segment_fold_and_snapshot_make_no_host_sync():
    """The pipelined job's per-segment work on the card — the fold (the
    grid's epilogue weights, the kernel, the merge) and the checkpoint
    snapshot — never makes the host wait for the device, so the host runs
    ahead of the card by whole segments."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.cluster import mapreduce
    from repro_torch.core import topk

    dev = _card()
    _, docs, stats, q, grid = _scan_collection(dev, seed=903)
    fold = mapreduce.segment_fold(grid, k=200, chunk_size=1024)
    state = topk.init(200, (len(grid), q.shape[0]), device=dev)
    state = fold(state, q, tuple(x[:1024] for x in docs), stats, 0)  # builds the kernel
    torch.cuda.synchronize()
    want = fold(state, q, tuple(x[1024:2048] for x in docs), stats, 1024)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fold(state, q, tuple(x[1024:2048] for x in docs), stats, 1024)
        snap = ckpt.snapshot(got)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = snap.wait()
    assert torch.equal(got.ids, want.ids) and torch.equal(host.ids, want.ids.cpu())
    assert torch.equal(host.scores.view(torch.int32), want.scores.cpu().view(torch.int32))


@pytest.mark.cuda
def test_cuda_anchor_job_is_the_cpus():
    """The anchor job on the card gives the CPU's rows and lengths byte for
    byte, wrapped negative destinations and collisions included, and the
    link graph drawn on the card is the CPU's."""
    from repro_torch.data import synthetic

    dev = _card()
    dst, toks = synthetic.make_links(n_docs=4096, n_links=1 << 16, vocab=4096, seed=1)
    dst_c, toks_c = synthetic.make_links(n_docs=4096, n_links=1 << 16, vocab=4096, seed=1,
                                         device=dev)
    assert dst.tobytes() == dst_c.tobytes() and toks.tobytes() == toks_c.tobytes()
    dst[:64] = np.arange(-64, 0)  # these wrap onto rows 4032..4095
    dst[64:72] = [4096, 5000, -4097, -9999, 4095, 4095, 0, 0]
    for max_anchor_len in (64, 7):
        want = anchors.extract_anchors(torch.as_tensor(dst), torch.as_tensor(toks),
                                       n_docs=4096, max_anchor_len=max_anchor_len)
        got = anchors.extract_anchors(torch.as_tensor(dst, device=dev),
                                      torch.as_tensor(toks, device=dev),
                                      n_docs=4096, max_anchor_len=max_anchor_len)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_grid_pass_and_index_agree():
    """On the card a 4-model pass gives each model's single pass bit for
    bit (the amortization curve's parity), the curve's clock stops after the
    kernel, and the index, given statistics on the card, ranks as the scan."""
    from _torch_parity import assert_rankings_close
    from repro_torch.core import invindex, scan
    from repro_torch.data import synthetic
    from repro_torch.experiments import bench

    dev = _card()
    corpus = synthetic.make_corpus(n_docs=8192, vocab=4096, max_len=64, seed=11)
    queries = synthetic.make_queries(corpus, n_queries=32, seed=12)
    docs = (torch.as_tensor(corpus.tokens, device=dev), torch.as_tensor(corpus.lengths, device=dev))
    stats = anchors.collection_stats(*docs, vocab=4096, chunk_size=1024)
    q = torch.as_tensor(queries, device=dev)
    grid = [scoring.make_variant("ql_lm", lam=lam) for lam in (0.05, 0.15, 0.3, 0.5)]
    multi = scan.search_local_multi(q, docs, tuple(grid), k=20, chunk_size=1024, stats=stats)
    for m, s in enumerate(grid):
        single = scan.search_local(q, docs, s, k=20, chunk_size=1024, stats=stats)
        assert torch.equal(multi.ids[m], single.ids)
        assert torch.equal(multi.scores[m].view(torch.int32), single.scores.view(torch.int32))
    payload = bench.amortization_curve(q, docs, grid, k=20, chunk_size=1024, stats=stats,
                                       sizes=(1, 2, 4), repeats=2)
    assert payload["curve"][0]["speedup_vs_independent"] == 1.0
    assert all(p["wall_s"] > 0 for p in payload["curve"])
    idx = invindex.build_index(corpus.tokens, corpus.lengths, vocab=4096)
    istats = invindex.stats_from_index(idx)
    want_s, want_i = invindex.search(idx, queries, type(stats)(*(t.to(dev) for t in istats)),
                                     k=20 + DEEPER)
    got = scan.search_local(q, docs, scoring.get_scorer("ql_lm"), k=20, chunk_size=1024,
                            stats=type(stats)(*(t.to(dev) for t in istats)))
    assert_rankings_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(), want_s, want_i,
                          tol=3e-5)


def _card_mesh(dev, shape, names):
    from repro_torch.distributed.sharding import Mesh

    arr = np.empty(shape, dtype=object)
    arr.fill(dev)
    return Mesh(arr, names)


@pytest.mark.cuda
def test_cuda_search_mesh_orders_its_streams():
    """Each shard's stream waits for the caller's stream (the queries are
    written there after a long sleep), the merge waits for every shard's
    stream, and the result is the one-shard scan's bytes, one kernel launch
    a shard; the shards' streams are not the caller's."""
    from repro_torch import cluster
    from repro_torch.core import scan

    dev = _card()
    _, docs, stats, q, grid = _scan_collection(dev, seed=904)
    want = scan.search_local_multi(q, docs, grid, k=100, chunk_size=1024, stats=stats)
    host_q = q.cpu().pin_memory()
    for shape, names in (((4,), ("data",)), ((2, 2), ("data", "model")), ((1,), ("data",))):
        fn = cluster.search_mesh(_card_mesh(dev, shape, names), q, docs, grid, k=100,
                                 chunk_size=1024, stats=stats)
        assert all(s is not None and s != torch.cuda.current_stream() for s in fn.streams)
        fn(q, docs, stats)  # first call: the kernel is built
        late = torch.zeros_like(q)
        torch.cuda.synchronize()
        before = ops.LAUNCHES["lexical_scan_topk"]
        torch.cuda._sleep(50_000_000)  # the caller's stream is busy for a while
        late.copy_(host_q, non_blocking=True)
        got = fn(late, docs, stats)
        assert torch.equal(got.ids, want.ids), shape
        assert torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32)), shape
        assert ops.LAUNCHES["lexical_scan_topk"] - before == len(fn.devices)


@pytest.mark.cuda
def test_cuda_search_mesh_makes_no_host_sync():
    from repro_torch import cluster

    dev = _card()
    _, docs, stats, q, grid = _scan_collection(dev, seed=905)
    fn = cluster.search_mesh(_card_mesh(dev, (2, 2), ("data", "model")), q, docs, grid,
                             k=100, chunk_size=1024, stats=stats)
    want = fn(q, docs, stats)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(q, docs, stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)


@pytest.mark.cuda
def test_cuda_sharded_session_is_the_resident_session():
    from repro_torch.serve import LexicalSession, ShardedLexicalSession

    dev = _card()
    host, _, stats, q, _ = _scan_collection(dev, seed=906)
    queries = q.cpu().numpy()
    for pack in ("none", "auto"):
        base = LexicalSession(*host, "ql_lm", k=50, chunk_size=1024, stats=stats,
                              token_pack=pack)
        sharded = ShardedLexicalSession(_card_mesh(dev, (4,), ("data",)), *host, "ql_lm",
                                        k=50, chunk_size=1024, stats=stats, token_pack=pack)
        assert sharded.resident_corpus_bytes == base.resident_corpus_bytes
        a, b = base.search(queries), sharded.search(queries)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores), pack


@pytest.mark.cuda
def test_cuda_moe_lm_matches_the_cpu_and_decodes_without_host_sync():
    """The reduced qwen3-moe-30b-a3b (float32) on the card against the CPU:
    prefill and 8 decode steps within 1e-4 / 1e-5; then decode steps with
    ``t`` on the card make no host sync and give the host-int steps' bits."""
    from repro_torch.configs import reduced_config
    from repro_torch.data import synthetic
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.models import transformer as tfm

    dev = _card()
    cfg = reduced_config("qwen3-moe-30b-a3b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3))
    on_card = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
               for k, v in params.items()}
    tokens = torch.as_tensor(synthetic.make_lm_batch(batch=2, seq_len=32, vocab=cfg.vocab,
                                                     seed=3)["tokens"])
    out = {}
    for where, p in (("cpu", params), ("cuda", on_card)):
        mesh = _card_mesh(torch.device(where), (1, 1), ("data", "model"))
        rules = rules_for_mesh(mesh)
        prefill = tfm.make_prefill_step(tfm.make_context(cfg, mesh, rules, tokens_per_shard=64,
                                                         moe_mode="seq"))
        step = tfm.make_serve_step(tfm.make_context(cfg, mesh, rules, tokens_per_shard=2),
                                   batch=2)
        logits, cache = prefill(p, tokens.to(where))
        full = tfm.init_cache(cfg, 2, 48, device=where)
        full["k"][:, :, :32], full["v"][:, :, :32] = cache["k"], cache["v"]
        seq = [logits.cpu()]
        for t in range(32, 40):
            logits, full = step(p, full, torch.argmax(seq[-1], -1).to(where), t)
            seq.append(logits.cpu())
        out[where] = (seq, step, full)
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    _, step, full = out["cuda"]
    copy = {n: x.clone() for n, x in full.items()}
    tok = torch.argmax(out["cuda"][0][-1], -1).to(dev)
    t_dev = torch.tensor(40, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    for t in range(40, 44):
        want, full = step(on_card, full, tok, t)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, copy = step(on_card, copy, tok, t_dev)
            t_dev.add_(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), t
        tok = torch.argmax(want, -1)


# ---------------------------------------------------------------------------
# the training slice: flash attention with a gradient, a deterministic step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,window,cap", [
    (torch.float32, 64, 32, 50.0), (torch.bfloat16, 80, 64, None),
    (torch.bfloat16, 64, None, 30.0)], ids=["f32-cap", "bf16-hd80-window", "bf16-hd64-cap"])
def test_cuda_flash_attention_train_gradients_match_the_cpu(dtype, hd, window, cap):
    """The autograd function on the card (the kernel's forward, no graph of
    its own) gives the CPU's gradients: float32 within 1e-4 / 1e-5,
    bfloat16 within 3e-2 (the products' operands round to bfloat16)."""
    dev = _card()
    g = torch.Generator().manual_seed(hd)
    b, s, h, kv = 2, 256, 8, 2
    q, k, v = (torch.randn((b, s, n, hd), generator=g).to(dtype) for n in (h, kv, kv))
    do = torch.randn((b, s, h, hd), generator=g).to(dtype)

    def grads(where):
        xs = [x.to(where).requires_grad_(True) for x in (q, k, v)]
        out = ops.flash_attention_train(*xs, window=window, cap=cap, block_q=64, block_k=64,
                                        bwd_block=64)
        return torch.autograd.grad(out, xs, do.to(where))

    before = ops.LAUNCHES["flash_attention"]
    card = grads(dev)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    tol = {"rtol": 1e-4, "atol": 1e-5} if dtype == torch.float32 else {"rtol": 3e-2,
                                                                       "atol": 3e-2}
    for got, want in zip(card, grads("cpu")):
        torch.testing.assert_close(got.cpu().float(), want.float(), **tol)


@pytest.mark.cuda
def test_cuda_training_steps_are_deterministic(tmp_path):
    """Two runs of the driver on the card give the same bytes (embedding and
    MoE gathers through F.embedding, whose backward sorts), and a crash
    resumed from a checkpoint gives the straight run's bytes."""
    from repro_torch.launch import train as train_cli

    _card()
    for arch in ("gemma2-2b", "qwen3-moe-30b-a3b", "fm"):
        kw = dict(steps=4, batch=2, seq=64, ckpt_every=2, device="cuda")
        a, b = train_cli.train(arch, **kw), train_cli.train(arch, **kw)
        with pytest.raises(RuntimeError, match="injected"):
            train_cli.train(arch, ckpt_dir=str(tmp_path / arch), fail_at_step=3, **kw)
        c = train_cli.train(arch, ckpt_dir=str(tmp_path / arch), **kw)
        for x in (b, c):
            for tree in ("params", "m", "v"):
                got = x["params"] if tree == "params" else getattr(x["opt"], tree)
                want = a["params"] if tree == "params" else getattr(a["opt"], tree)
                for p, q in zip(_tree_leaves(want), _tree_leaves(got)):
                    assert torch.equal(_bits(p), _bits(q)), (arch, tree)


def _bits(t):
    return t.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# the dense session's resident pad; the GNN and the segment reduce
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, 24, 40])
def test_cuda_dense_session_pads_its_corpus_once(dim):
    """A row narrower than the kernel's 128-byte stage: the session pads
    its resident vectors once, so a block gives the bits of the wrapper's
    own pad (the path before) and allocates nothing the corpus's size."""
    from repro_torch.core import scan
    from repro_torch.serve.session import DenseSession

    dev = _card()
    rng = np.random.default_rng(dim)
    vecs = rng.standard_normal((1 << 20, dim)).astype(np.float32)
    q = rng.standard_normal((64, dim)).astype(np.float32)
    for scorer in ("dense_dot", "dense_cosine"):
        sess = DenseSession(vecs, scorer, k=100, chunk_size=4096, device=dev)
        assert sess.dim == dim and sess._vectors.shape[1] == 32 * (-(-dim // 32))
        before = scan.search_local(torch.as_tensor(q, device=dev),
                                   torch.as_tensor(vecs, device=dev),
                                   scoring.get_scorer(scorer), k=100, chunk_size=4096)
        sess.search(q)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got = sess.search(q)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated(dev) - base < vecs.nbytes
        assert torch.equal(got.scores, before.scores.cpu()), scorer
        assert torch.equal(got.ids, before.ids.cpu()), scorer


@pytest.mark.cuda
def test_cuda_embedding_bag_ragged_is_deterministic():
    """Two calls of the ragged bag (sum, mean, max) and their gradients give
    the same bytes on the card, and the CPU's values within 1e-6."""
    from repro_torch.models import embedding

    dev = _card()
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.standard_normal((500, 64)).astype(np.float32))
    values = torch.tensor(rng.integers(0, 500, 200_000))
    segs = torch.tensor(np.sort(rng.integers(0, 1000, 200_000)))
    for mode in ("sum", "mean", "max"):
        runs = []
        for _ in range(2):
            t = table.to(dev).requires_grad_(True)
            out = embedding.embedding_bag_ragged(t, values.to(dev), segs.to(dev), 1000,
                                                 mode=mode)
            grad, = torch.autograd.grad(out.sum() * 0.5, t)
            runs.append((out.detach().cpu(), grad.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*runs)), mode
        want = embedding.embedding_bag_ragged(table, values, segs, 1000, mode=mode)
        torch.testing.assert_close(runs[0][0], want, rtol=1e-6, atol=1e-6)


def _gnn_regimes(dev, dtype):
    """Reduced-``pna`` logits functions of every regime on ``dev``, from one
    seeded graph and batch: full graph; bucketed and scatter on (1,) and
    (4,) meshes of ``dev``; sampled; batched."""
    from repro_torch.configs import reduced_config
    from repro_torch.data import graph_prep, synthetic
    from repro_torch.distributed.sharding import Mesh, rules_for_mesh
    from repro_torch.models import gnn

    cfg = reduced_config("pna")
    g = synthetic.make_graph(n_nodes=64, n_edges=512, d_feat=9, seed=4)
    rng = np.random.default_rng(1)
    # random features: no fanout group of repeated neighbours, whose zero
    # variance gives the reference's own NaN (tests/test_torch_gnn.py)
    sb = {"seed_x": rng.standard_normal((16, 9)), "hop1_x": rng.standard_normal((16, 5, 9)),
          "hop2_x": rng.standard_normal((16, 5, 3, 9))}
    mol = (rng.standard_normal((4, 10, 9)), rng.integers(0, 10, (4, 20)),
           rng.integers(0, 10, (4, 20)))

    def t(a):
        a = torch.as_tensor(np.asarray(a))
        return (a.to(dtype) if a.is_floating_point() else a).to(dev)

    out = {"full": lambda p: gnn.forward_full_graph(p, t(g["x"]), t(g["src"]), t(g["dst"]),
                                                    cfg),
           "sampled": lambda p: gnn.forward_sampled(p, t(sb["seed_x"]), t(sb["hop1_x"]),
                                                    t(sb["hop2_x"]), cfg),
           "batched": lambda p: gnn.forward_batched_graphs(p, *map(t, mol), cfg)}
    for n in (1, 4):
        arr = np.empty((n,), dtype=object)
        arr.fill(torch.device(dev))
        mesh = Mesh(arr, ("data",))
        bs, bd, _ = graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=64, n_shards=n)
        for mode, (s, d) in (("bucketed", (bs, bd)), ("scatter", (g["src"], g["dst"]))):
            fwd = gnn.make_sharded_full_graph(mesh, rules_for_mesh(mesh), cfg, mode=mode)
            out[f"{mode}{n}"] = (lambda f, s, d: lambda p: f(p, t(g["x"]), t(s), t(d)))(fwd, s, d)
    return cfg, out, t(g["y"] % cfg.n_classes)


def _gnn_logits_and_grads(dev, dtype):
    from repro_torch.models import gnn

    cfg, regimes, y = _gnn_regimes(dev, dtype)
    params = gnn.init_params(cfg, 9, torch.Generator().manual_seed(0))
    res = {}
    for name, fn in regimes.items():
        p = {k: (v.to(dev, dtype).requires_grad_(True) if not isinstance(v, dict) else
                 {kk: vv.to(dev, dtype).requires_grad_(True) for kk, vv in v.items()})
             for k, v in params.items()}
        logits = fn(p)
        labels = y[:logits.shape[0]]
        leaves = _tree_leaves(p)
        grads = torch.autograd.grad(gnn.xent_loss(logits, labels), leaves)
        res[name] = [logits.detach().cpu()] + [gr.cpu() for gr in grads]
    return res


@pytest.mark.cuda
def test_cuda_gnn_matches_the_cpu_and_repeats_its_bytes():
    """Reduced ``pna`` in every regime on the card against the CPU: float64
    logits and every gradient leaf within 1e-5 (the CPU tests' TOL); float32
    logits within 1e-5 of their largest (float32 rounding grows ~60x a
    layer under the reference's init, so an element near zero may miss an
    elementwise limit); two runs on the card give the same bytes."""
    _card()
    for dtype in (torch.float64, torch.float32):
        card = _gnn_logits_and_grads("cuda", dtype)
        cpu = _gnn_logits_and_grads("cpu", dtype)
        again = _gnn_logits_and_grads("cuda", dtype)
        for name in cpu:
            if dtype == torch.float64:
                for got, want in zip(card[name], cpu[name]):
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                               msg=lambda m: f"{name}: {m}")
            else:
                got, want = card[name][0], cpu[name][0]
                assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), name
            for a, b in zip(card[name], again[name]):
                assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.cuda
def test_cuda_the_meta_count_of_a_danube_step_reckons_its_peak_memory():
    """`launch.opcount` on meta tensors reckons one training step's peak
    live bytes: h2o-danube-1.8b at full width and 2 layers, 2 x 2,048
    tokens, the train driver's step; within 25% of the card's
    ``max_memory_allocated`` over the same step (parameters, moments and
    batch included on both sides)."""
    import dataclasses

    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch import cells, opcount
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), n_layers=2)
    b, s = 2, 2048
    schedule = adamw.cosine_schedule(1e-3, warmup=1, total=4)

    def step_on(mesh):
        loss_fn, _, _ = train_cli.build_lm(cfg, mesh, rules_for_mesh(mesh), batch=b, seq=s, seed=0)
        return train_cli.make_train_step(loss_fn, schedule)

    shapes = tfm.param_shapes(cfg)
    meta_args = (cells.abstract(shapes), cells.abstract(adamw.adamw_state_shapes(shapes)),
                 torch.empty((), device="meta"),
                 {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
                  "labels": torch.empty((b, s), dtype=torch.int32, device="meta")})
    with opcount.OpCounter(1) as counter:
        counter.track(meta_args)
        step_on(cells.meta_mesh("1"))(*meta_args)
    reckoned = counter.result()["peak_bytes"]

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what earlier tests left on the card
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw.adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    ef = torch.zeros((), device=dev)
    step = step_on(make_test_mesh(1, 1, device="cuda"))
    step(params, opt, ef, batch)  # the first step's library workspaces stay out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, ef, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    assert abs(reckoned / measured - 1) <= 0.25, (reckoned, measured)
