"""Public wrappers for the port's kernels: the device picks the path.

A wrapper given CPU tensors runs its kernel's plain PyTorch version; given
CUDA tensors it launches the hand-written CUDA kernel or raises. There is no
fallback, no backend switch and no environment variable: a CUDA tensor never
reaches a plain version, and a failed build or launch is an error.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card (plain integers; runs on the CPU never count), so that a run can show
its main path went through the kernels.

Block geometry defaults to the active `repro_torch.tune.TuningConfig`, as
in the reference (`repro.kernels.ops`); it only regroups value-deterministic
merges, so it changes speed, never a bit of the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lexical_scan as _lexical
from repro_torch.kernels import score_topk as _dense
from repro_torch.tune import config as tune_config

LAUNCHES: dict[str, int] = {"lexical_scan_topk": 0, "score_topk": 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_cuda(name: str, tensors: dict, dtypes: dict) -> torch.device:
    dev = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor, got {type(t).__name__}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != dtypes[arg]:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtypes[arg]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


def score_topk(q, d, *, k: int, block_d: int | None = None, merge: str = "bitonic"):
    """Streaming dense score + top-k (MIREX map+combine) -> ``(scores, ids)
    [n_q, k]``, ids local to ``d``, ``(-inf, -1)`` in empty slots.

    ``q [n_q, dim]`` and ``d [n_d, dim]`` share a dtype, float32 or
    bfloat16; scores accumulate in float32. ``block_d=None`` takes the
    active tuning's ``dense_block_d`` (1024 when untuned); ``n_d`` must be a
    multiple of it. ``merge`` names one of the reference's two combiners,
    ``"bitonic"`` (the k-bounded merge) and ``"concat"`` (the full re-sort),
    which give the same result: both names are accepted and compute that
    one result.
    """
    if merge not in ("bitonic", "concat"):
        raise ValueError(f"unknown merge {merge!r}; expected 'bitonic' or 'concat'")
    if block_d is None:
        block_d = tune_config.active().config.dense_block_d or 1024
    for arg, t in (("q", q), ("d", d)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"score_topk: {arg} must be a tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"score_topk: {arg} must be contiguous")
    if q.device != d.device:
        raise ValueError(f"score_topk: d on {d.device}, expected {q.device}")
    if q.device.type == "cpu":
        return _dense.score_topk_ref(q, d, k=k, block_d=block_d)
    if q.device.type != "cuda":
        raise ValueError(f"score_topk: no kernel for device {q.device}")
    out = _dense.score_topk_cuda(q, d, k=k, block_d=block_d)
    LAUNCHES["score_topk"] += 1
    return out


def lexical_scan_topk(
    q_tokens, weights, ab, d_tokens, d_len, *, modes, k: int,
    block_d: int | None = None, tile_d: int | None = None, pack_spec=None,
):
    """Multi-model lexical scan (shared tf + per-model scorer epilogues +
    top-k). -> ``(scores, ids) [n_models, n_q, k]``, ids local to
    ``d_tokens``, ``(-inf, -1)`` in empty slots.

    ``modes`` is the tuple of `scoring.EpilogueMode`; build all three
    arguments from a scorer grid with `scoring.lexical_epilogues`.
    ``block_d``/``tile_d`` default to the active tuning's ``lex_block_d`` /
    ``lex_tile_d`` (512 / 16 when untuned). Packed token tiles
    (``pack_spec``) wait for the packing slice.
    """
    if pack_spec is not None:
        raise NotImplementedError(
            "packed token tiles (pack_spec) wait for the packing slice of the port"
        )
    if block_d is None or tile_d is None:
        cfg = tune_config.active().config
        if block_d is None:
            block_d = cfg.lex_block_d or 512
        if tile_d is None:
            tile_d = cfg.lex_tile_d
    dev = _check_cuda(
        "lexical_scan_topk",
        {"q_tokens": q_tokens, "weights": weights, "ab": ab,
         "d_tokens": d_tokens, "d_len": d_len},
        {"q_tokens": torch.int32, "weights": torch.float32, "ab": torch.float32,
         "d_tokens": torch.int32, "d_len": torch.int32},
    )
    if q_tokens.dim() != 2 or weights.dim() != 3 or d_tokens.dim() != 2:
        raise ValueError("lexical_scan_topk: q_tokens [n_q, L_q], weights "
                         "[n_models, n_q, L_q], d_tokens [n_d, L_d] expected")
    if dev.type == "cpu":
        return _lexical.lexical_scan_topk_ref(
            q_tokens, weights, ab, d_tokens, d_len,
            modes=modes, k=k, block_d=block_d, tile_d=tile_d,
        )
    if dev.type != "cuda":
        raise ValueError(f"lexical_scan_topk: no kernel for device {dev}")
    out = _lexical.lexical_scan_topk_cuda(
        q_tokens, weights, ab, d_tokens, d_len,
        modes=modes, k=k, block_d=block_d, tile_d=tile_d,
    )
    LAUNCHES["lexical_scan_topk"] += 1
    return out
