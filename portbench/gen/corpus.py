"""The Zipf corpus, on the device: the pattern of the program's
`data/synthetic.make_corpus` (lengths uniform in [min_len, max_len], token
ids drawn by inverting the Zipf CDF), written for a torch.Generator so that
a corpus of tens of millions of rows is made on the card in seconds."""

from __future__ import annotations

import torch

from portbench.gen import PAD, generator


def zipf_cdf(vocab: int, alpha: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -alpha, 0)
    return cdf / cdf[-1]


def make_corpus(cfg: dict, *, seed: int, device, rows_per_step: int = 1 << 20):
    """``(tokens [n_docs, max_doc_len] int32, PAD-padded; lengths [n_docs]
    int32)`` from ``cfg``'s ``n_docs``, ``min_doc_len``, ``max_doc_len``,
    ``vocab`` and ``zipf_alpha``."""
    n, width, vocab = cfg["n_docs"], cfg["max_doc_len"], cfg["vocab"]
    g = generator(seed, "corpus", device)
    lengths = torch.randint(cfg["min_doc_len"], width + 1, (n,), generator=g,
                            device=device, dtype=torch.int32)
    cdf = zipf_cdf(vocab, cfg["zipf_alpha"], device)
    tokens = torch.empty((n, width), dtype=torch.int32, device=device)
    cols = torch.arange(width, device=device)
    for a in range(0, n, rows_per_step):
        b = min(n, a + rows_per_step)
        u = torch.rand((b - a, width), generator=g, device=device, dtype=torch.float64)
        ids = torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1).to(torch.int32)
        tokens[a:b] = torch.where(cols < lengths[a:b, None], ids, PAD)
    return tokens, lengths
