"""Carry the JAX package's state across: its numpy arrays as the port's tensors.

The reference keeps collection statistics, top-k states and epilogue specs
as arrays; ``np.asarray`` of them gives numpy arrays, and these functions
turn those into the port's tensors on a given device, dtypes unchanged.
(Checkpoints need no conversion: both packages write the same on-disk
layout, see `repro_torch.checkpoint`.)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scoring import CollectionStats, EpilogueMode
from repro_torch.core.topk import TopKState


def _t(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)  # a copy: jax's views are read-only


def stats_from_numpy(stats, device="cpu") -> CollectionStats:
    """A ``CollectionStats`` of numpy arrays -> the port's, on ``device``."""
    return CollectionStats(*(_t(x, device) for x in stats))


def state_from_numpy(state, device="cpu") -> TopKState:
    """A ``TopKState`` of numpy arrays -> the port's, on ``device``."""
    return TopKState(scores=_t(state.scores, device), ids=_t(state.ids, device))


def epilogues_from_numpy(modes, weights, ab, device="cpu"):
    """``(modes, weights [n_models, n_q, L_q], ab [n_models, 2])`` from
    `repro.core.scoring.lexical_epilogues` -> the port's, on ``device``.
    Modes are matched field by field, so the reference's own
    ``EpilogueMode`` objects carry over."""
    modes = tuple(
        EpilogueMode(m.mode, length_prior=m.length_prior, length_norm=m.length_norm)
        for m in modes
    )
    return modes, _t(weights, device), _t(ab, device)
