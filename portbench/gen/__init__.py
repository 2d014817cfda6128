"""Inputs made from the run's seed on its device: corpus, queries,
arrivals. The program and the reference get the same tensors."""

import zlib

import numpy as np

PAD = -1


def sub_seed(seed: int, stream: str) -> int:
    """A 64-bit seed for one named stream of one run's seed (any integer)."""
    words = [seed % (1 << 64), zlib.crc32(stream.encode())]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def generator(seed: int, stream: str, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g
