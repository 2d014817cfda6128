"""Queries drawn from document text (as the program's
`data/synthetic.make_queries`): a random document, then random positions in
it. Query lengths follow a fixed histogram, shuffled by the seed, so every
seed asks for the same amount of work."""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen import PAD, generator


def length_pattern(hist: dict) -> np.ndarray:
    """The histogram ``{"length": count}`` written out, shortest first."""
    return np.concatenate([np.full(int(c), int(l), np.int64) for l, c in
                           sorted(hist.items(), key=lambda kv: int(kv[0]))])


def make_queries(tokens, lengths, *, n: int, hist: dict, max_q_len: int, seed: int,
                 stream: str = "queries"):
    """``[n, max_q_len]`` int32, PAD-padded, on the corpus's device. Every
    run of ``sum(hist)`` consecutive rows has the histogram's lengths."""
    dev = tokens.device
    g = generator(seed, stream, dev)
    pattern = torch.as_tensor(length_pattern(hist), device=dev)
    if int(pattern.max()) > max_q_len:
        raise ValueError(f"query length {int(pattern.max())} > max_q_len {max_q_len}")
    lens = pattern[torch.arange(n, device=dev) % pattern.numel()]
    lens = lens[torch.randperm(n, generator=g, device=dev)]
    docs = torch.randint(0, tokens.shape[0], (n,), generator=g, device=dev)
    dlen = lengths[docs].to(torch.int64)
    u = torch.rand((n, max_q_len), generator=g, device=dev, dtype=torch.float64)
    pos = torch.minimum((u * dlen[:, None]).to(torch.int64), dlen[:, None] - 1)
    terms = tokens[docs[:, None], pos]
    cols = torch.arange(max_q_len, device=dev)
    return torch.where(cols < lens[:, None], terms, PAD).to(torch.int32)
