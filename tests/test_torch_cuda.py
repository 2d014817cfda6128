"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is ``cuda``-marked and skips without a card. The file imports
no JAX (the machine with the card has none), so it runs there on its own:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

The lexical scan must agree with its plain version to the bit, and its
packed-tile path with the unpacked kernel on the unpacked tokens; the dense
score + top-k within 1e-5 with ids equal except at float near-ties
(`_torch_parity`, the plain ranking taken 8 places deeper), and to the bit
on integer-valued inputs; the flash attention and decode kernels (every
attention route; decode with ``t`` on the host and on the card, and
replayed from a CUDA graph) within 3e-4 / 3e-5 in float32 and 3e-2 in
bfloat16 (the reference's tolerances), and the reduced LM on the card
within 1e-4 / 1e-5 of the CPU; its serve step with ``t`` on the card makes
no host sync. The pipelined executor on the card: host → card prefetch on a
copy stream equals the slices within its memory bound, the snapshot
checkpoints equal the synchronous job's, two workers on two streams give
the synchronous job's bits under seeded chaos, launches count exactly under
threads, and a segment fold makes no host sync. ``chip_smoke.py`` makes the
same checks at the full width.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro_torch.core import anchors, packing, scoring
from repro_torch.kernels import flash_attn, flash_decode, lexical_scan, ops, score_topk

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
    with pytest.raises(ValueError, match="128 bytes"):
        ops.score_topk(q[:, :8].contiguous(), d[:, :8].contiguous(), k=5, block_d=1024)


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
    block, _ = flash_decode.split_plan(s, None, b * kv, flash_decode.sm_count(dev), 512)
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
