"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is ``cuda``-marked and skips without a card. The file imports
no JAX (the machine with the card has none), so it runs there on its own:

    python -m pytest -q -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The lexical scan must agree with its plain version to the bit; the dense
score + top-k within 1e-5 with ids equal except at float near-ties
(`_torch_parity`, the plain ranking taken 8 places deeper), and to the bit
on integer-valued inputs. ``chip_smoke.py`` makes the same checks at the
full width.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro_torch.core import anchors, scoring
from repro_torch.kernels import lexical_scan, ops, score_topk

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
