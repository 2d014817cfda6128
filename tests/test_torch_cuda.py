"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is ``cuda``-marked and skips without a card. The file imports
no JAX (the machine with the card has none), so it runs there on its own:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

The lexical scan must agree with its plain version to the bit; the dense
score + top-k within 1e-5 with ids equal except at float near-ties
(`_torch_parity`, the plain ranking taken 8 places deeper), and to the bit
on integer-valued inputs; the flash attention and decode kernels within
3e-4 / 3e-5 in float32 and 3e-2 in bfloat16 (the reference's tolerances),
and the reduced LM on the card within 1e-4 / 1e-5 of the CPU. ``chip_smoke.py`` makes the same checks at the
full width.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro_torch.core import anchors, scoring
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
