"""Public wrappers for the port's kernels: the device picks the path.

A wrapper given CPU tensors runs its kernel's plain PyTorch version; given
CUDA tensors it launches the hand-written CUDA kernel or raises; given
``meta`` tensors (shapes and dtypes, no data) it launches nothing and
returns outputs of the right shapes and dtypes on ``meta``. There is no
fallback, no backend switch and no environment variable: a CUDA tensor never
reaches a plain version, and a failed build or launch is an error.

Each body runs through `repro_torch.obs.counting.kernel`: under an op
counter (the lowering tools) the kernel's work, its module's ``cost(...)``,
is charged to the counter and the body itself is not counted, on every
device; with no counter the body just runs.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card (plain integers; runs on the CPU never count), so that a run can show
its main path went through the kernels. A count is raised under a lock:
the scan job's workers launch from several threads at once.

Block geometry defaults to the active `repro_torch.tune.TuningConfig`, as
in the reference (`repro.kernels.ops`); it only regroups value-deterministic
merges, so it changes speed, never a bit of the result.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import flash_decode as _decode
from repro_torch.kernels import lexical_scan as _lexical
from repro_torch.kernels import score_topk as _dense
from repro_torch.obs import counting
from repro_torch.tune import config as tune_config

LAUNCHES: dict[str, int] = {
    "lexical_scan_topk": 0, "score_topk": 0, "flash_attention": 0, "flash_decode": 0,
}


_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set every launch count to 0."""
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]`` (a read-modify-write, hence the lock)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _launch(name: str, fn, *args, **kwargs):
    """Launch a CUDA kernel and count it."""
    out = fn(*args, **kwargs)
    count_launch(name)
    return out


def _check_cuda(name: str, tensors: dict, dtypes: dict, views: tuple = ()) -> torch.device:
    """One device for every tensor, each of its dtype and contiguous (the
    arguments named in ``views`` may be views; their kernel checks their
    strides)."""
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
        if arg not in views and not t.is_contiguous():
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
    dev = q.device
    if dev.type == "cpu":
        run = lambda: _dense.score_topk_ref(q, d, k=k, block_d=block_d)  # noqa: E731
    elif dev.type == "meta":
        run = lambda: _dense.outputs_meta(q, k=k)  # noqa: E731
    elif dev.type == "cuda":
        run = lambda: _launch("score_topk", _dense.score_topk_cuda, q, d, k=k,  # noqa: E731
                              block_d=block_d)
    else:
        raise ValueError(f"score_topk: no kernel for device {dev}")
    return counting.kernel("score_topk", lambda: _dense.cost(q, d, k=k), run)


def lexical_scan_topk(
    q_tokens, weights, ab, d_tokens, d_len, *, modes, k: int,
    block_d: int | None = None, tile_d: int | None = None, pack_spec=None, counters=None,
):
    """Multi-model lexical scan (shared tf + per-model scorer epilogues +
    top-k). -> ``(scores, ids) [n_models, n_q, k]``, ids local to
    ``d_tokens``, ``(-inf, -1)`` in empty slots.

    ``modes`` is the tuple of `scoring.EpilogueMode`; build all three
    arguments from a scorer grid with `scoring.lexical_epilogues`.
    ``block_d``/``tile_d`` default to the active tuning's ``lex_block_d`` /
    ``lex_tile_d`` (512 / 16 when untuned). With ``pack_spec`` (a
    `packing.PackSpec`), ``d_tokens`` is the packed matrix ``[n_d,
    pack_spec.packed_width]`` of the spec's dtype (uint8, uint16 or int32
    bit-planes), as `packing.pack_tokens` makes it: the plain version
    unpacks it block by block, the kernel decodes each tile on the card, and
    the result is the unpacked call's, bit for bit. A launch counts under
    ``lexical_scan_topk`` either way. ``counters``: on a card, the int64
    array of `lexical_scan.COUNTERS` the kernel adds its counts into, in
    place of the device's own (`lexical_scan.read_counters`); the plain
    version counts nothing.
    """
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
         "d_tokens": torch.int32 if pack_spec is None else pack_spec.torch_dtype(),
         "d_len": torch.int32},
    )
    if q_tokens.dim() != 2 or weights.dim() != 3 or d_tokens.dim() != 2:
        raise ValueError("lexical_scan_topk: q_tokens [n_q, L_q], weights "
                         "[n_models, n_q, L_q], d_tokens [n_d, L_d] expected")
    args = (q_tokens, weights, ab, d_tokens, d_len)
    kw = dict(modes=modes, k=k, block_d=block_d, tile_d=tile_d, pack_spec=pack_spec)
    if dev.type == "cpu":
        run = lambda: _lexical.lexical_scan_topk_ref(*args, **kw)  # noqa: E731
    elif dev.type == "meta":
        run = lambda: _lexical.outputs_meta(q_tokens, weights, k=k)  # noqa: E731
    elif dev.type == "cuda":
        run = lambda: _launch("lexical_scan_topk",  # noqa: E731
                              _lexical.lexical_scan_topk_cuda, *args, **kw, counters=counters)
    else:
        raise ValueError(f"lexical_scan_topk: no kernel for device {dev}")
    return counting.kernel("lexical_scan_topk",
                          lambda: _lexical.cost(*args, k=k, pack_spec=pack_spec), run)


def _same_dtype(name: str, tensors: dict, views: tuple = ()) -> torch.device:
    first = next(iter(tensors.values()))
    dtypes = {arg: first.dtype for arg in tensors}
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {first.dtype} (float32 or bfloat16 expected)")
    return _check_cuda(name, tensors, dtypes, views)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    cap: float | None = None, block_q: int | None = None,
                    block_k: int | None = None):
    """Blockwise attention (causal / sliding window / soft cap / native GQA).
    ``q [B,S,H,hd]``, ``k``/``v [B,S,KV,hd]`` of one dtype, float32 or
    bfloat16 -> ``[B,S,H,hd]``; query head ``h`` reads KV head
    ``h // (H / KV)``.

    ``block_q``/``block_k`` default to the active tuning's
    ``flash_block_q``/``flash_block_k`` (128/128 when untuned); ``S`` must
    be a multiple of both, as in the reference. On the card they are the
    kernel's tile (`flash_attn.check_geometry` says what it takes).
    """
    if block_q is None or block_k is None:
        cfg = tune_config.active().config
        block_q = cfg.flash_block_q if block_q is None else block_q
        block_k = cfg.flash_block_k if block_k is None else block_k
    dev = _same_dtype("flash_attention", {"q": q, "k": k, "v": v})
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q [B,S,H,hd] and k, v [B,S,KV,hd] with KV "
                         f"dividing H expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    s = q.shape[1]
    if s % block_q or s % block_k:
        raise ValueError(f"sequence {s} not divisible by block_q {block_q} / block_k {block_k}")
    if dev.type == "cpu":
        run = lambda: _flash.flash_attention_ref(q, k, v, causal=causal,  # noqa: E731
                                                 window=window, cap=cap)
    elif dev.type == "meta":
        run = lambda: torch.empty_like(q)  # noqa: E731
    elif dev.type == "cuda":
        run = lambda: _launch("flash_attention", _flash.flash_attention_cuda,  # noqa: E731
                              q, k, v, causal=causal, window=window, cap=cap,
                              block_q=block_q, block_k=block_k)
    else:
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    return counting.kernel("flash_attention",
                          lambda: _flash.cost(q, k, v, causal=causal, window=window), run)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward is that call
    (the CUDA kernel on the card, counted in ``LAUNCHES``; the plain version
    on the CPU), the backward `flash_attn.flash_attention_bwd` in torch ops
    on either device, one query block at a time. ``q``, ``k`` and ``v`` are
    saved, not the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, block_q, block_k, bwd_block):
        ctx.save_for_backward(q, k, v)
        ctx.args = {"causal": causal, "window": window, "cap": cap, "block": bwd_block}
        return flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                               block_q=block_q, block_k=block_k)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _flash.flash_attention_bwd(q, k, v, do, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window: int | None = None,
                          cap: float | None = None, block_q: int | None = None,
                          block_k: int | None = None, bwd_block: int = 512):
    """:func:`flash_attention` under autograd: the same forward (the same
    bits as serving's call), and a gradient that recomputes ``bwd_block``
    query rows at a time (`flash_attn.flash_attention_bwd`). The models call
    this; the bare :func:`flash_attention` has no gradient on the card."""
    return _FlashAttention.apply(q, k, v, causal, window, cap, block_q, block_k, bwd_block)


def flash_decode(q, k_cache, v_cache, t, *, window: int | None = None,
                 cap: float | None = None, block_s: int | None = None, pos0: int = 0,
                 cache_len: int | None = None, include_t: bool = True, lse: bool = False):
    """Split-KV single-token decode. ``q [B,H,hd]``, caches ``[B,S,KV,hd]``
    of one dtype -> ``[B,H,hd]``, attending to positions ``<= t``.

    ``t`` is a host ``int`` or a one-element integer tensor. On the card a
    CUDA ``t`` is read by the kernel itself (an int64 one is cast on the
    card first): nothing syncs with the host, the launch shape does not
    depend on ``t``, and the call can be captured in a CUDA graph; a ``t``
    outside ``[0, cache_len)`` then gives NaN outputs and sets the error
    word that `flash_decode.take_error` reads. A host ``t`` (or a CPU
    tensor) is checked here, ``0 <= t < cache_len``, and on the card copied
    to the device once per call. A ``meta`` ``t`` goes with ``meta`` caches.
    ``block_s=None`` takes the active tuning's ``decode_block_s`` (512 when
    untuned), the most positions a split of the kernel takes
    (`flash_decode.split_plan` picks fewer to fill the card). ``S`` need not
    be a multiple of ``block_s``: positions past ``t`` are never read.

    One shard of a sequence-sharded cache: the caches may be views of a
    slice of positions (each position's ``[KV, hd]`` contiguous) whose first
    slot is the global position ``pos0`` of a cache of ``cache_len``
    positions (default ``pos0 + S``); ``include_t=False`` allows positions
    up to ``t - 1`` only; ``lse=True`` returns the mergeable partial ``(o
    float32 [B,H,hd], lse float32 [B,H])`` (`flash_decode` module
    docstring), ``o = 0`` and ``lse = -inf`` where the slice holds no
    allowed position.
    """
    if block_s is None:
        block_s = tune_config.active().config.decode_block_s
    dev = _same_dtype("flash_decode", {"q": q, "k_cache": k_cache, "v_cache": v_cache},
                      views=("k_cache", "v_cache"))
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or q.shape[0] != k_cache.shape[0] or q.shape[2] != k_cache.shape[3] \
            or q.shape[1] % k_cache.shape[2]:
        raise ValueError(f"flash_decode: q [B,H,hd] and caches [B,S,KV,hd] with KV dividing "
                         f"H expected, got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    total = pos0 + k_cache.shape[1] if cache_len is None else cache_len
    if pos0 < 0 or pos0 + k_cache.shape[1] > total:
        raise ValueError(f"flash_decode: a slice of {k_cache.shape[1]} positions from {pos0} "
                         f"outside a cache of {total}")
    shard = {"pos0": pos0, "include_t": include_t, "lse": lse}

    def meta_out():
        if lse:
            return (torch.empty(q.shape, dtype=torch.float32, device=dev),
                    torch.empty(q.shape[:2], dtype=torch.float32, device=dev))
        return torch.empty_like(q)

    if isinstance(t, torch.Tensor):
        if t.numel() != 1 or t.dtype.is_floating_point or t.dtype.is_complex \
                or t.dtype == torch.bool:
            raise TypeError(f"flash_decode: t must be an int or one integer, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if dev.type in ("cuda", "meta") and t.device == dev:
            if dev.type == "meta":
                run = meta_out
            else:
                run = lambda: _launch(  # noqa: E731
                    "flash_decode", _decode.flash_decode_cuda, q, k_cache, v_cache,
                    t.reshape(()).to(torch.int32),  # no copy for an int32 t
                    window=window, cap=cap, block_s=block_s, cache_len=total, **shard)
            return counting.kernel(
                "flash_decode",
                lambda: _decode.cost(q, k_cache, v_cache, None, window=window, cache_len=total,
                                     **shard), run)
    t = int(t)
    if not 0 <= t < total:
        raise ValueError(f"flash_decode: position t={t} outside a cache of {total}")
    if dev.type == "cpu":
        run = lambda: _decode.flash_decode_ref(q, k_cache, v_cache, t,  # noqa: E731
                                               window=window, cap=cap, **shard)
    elif dev.type == "meta":
        run = meta_out
    elif dev.type == "cuda":
        run = lambda: _launch(  # noqa: E731
            "flash_decode", _decode.flash_decode_cuda, q, k_cache, v_cache,
            torch.tensor(t, dtype=torch.int32, device=dev), window=window, cap=cap,
            block_s=block_s, cache_len=total, **shard)
    else:
        raise ValueError(f"flash_decode: no kernel for device {dev}")
    return counting.kernel("flash_decode",
                          lambda: _decode.cost(q, k_cache, v_cache, t, window=window,
                                               cache_len=total, **shard), run)
