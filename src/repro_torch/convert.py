"""Carry the JAX package's state across: its numpy arrays as the port's tensors.

The reference keeps collection statistics, top-k states, epilogue specs and
dense vectors, LM parameters and KV caches as arrays; ``np.asarray`` of
them gives numpy arrays, and these functions turn those into the port's
tensors on a given device, dtypes unchanged.
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


def vectors_from_numpy(vecs, device="cpu") -> torch.Tensor:
    """Dense vectors ``[n, dim]``, float32 or bfloat16, -> the port's.

    JAX's bfloat16 reaches numpy as ``ml_dtypes.bfloat16``, which torch does
    not take; its 16-bit patterns are carried across and viewed as
    ``torch.bfloat16``, so every value arrives bit for bit.
    """
    arr = np.asarray(vecs)
    if arr.dtype.name != "bfloat16" and arr.dtype != np.float32:
        raise TypeError(f"dense vectors must be float32 or bfloat16, got {arr.dtype}")
    return _float_array(arr, device)


def _float_array(arr, device) -> torch.Tensor:
    """A float32 or bfloat16 array as a tensor, bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(arr).view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    return _t(arr, device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _float_array(tree, device)


def params_from_numpy(params, device="cpu") -> dict:
    """The reference's LM parameter pytree (`repro.models.transformer.
    init_params`, leaves through ``np.asarray``) -> the port's dict of
    tensors on ``device``, bfloat16 bit for bit; a MoE config's four
    expert leaves (``router``, ``w_gate``, ``w_up``, ``w_down``) come
    across with the rest, in the reference's layouts."""
    return _tree(params, device)


def cache_from_numpy(cache, device="cpu") -> dict:
    """The reference's KV cache ``{"k", "v"}`` of ``[L,B,S,KV,hd]`` arrays
    -> the port's, on ``device``, bfloat16 bit for bit."""
    return _tree(cache, device)
