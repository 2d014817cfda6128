"""Split-KV single-token decode attention, as the Pallas kernel
`repro.kernels.flash_decode` computes it.

One new token per sequence, ``q [B,H,hd]``, attends over a cache
``[B,S,KV,hd]`` at positions ``<= t`` (and ``t - pos < window``), with an
optional soft cap; query head ``h = kv * G + g`` reads KV head ``kv``.

* :func:`flash_decode_ref`, plain PyTorch: float32 scores over the allowed
  positions, one softmax, probabilities rounded to the cache's dtype before
  the P.V product, accumulated in float32.
* :func:`flash_decode_cuda`, the hand-written CUDA kernel
  (``csrc/flash_decode.cu``): CTAs over (split, KV head, batch) stream
  their positions through cp.async rings with an online softmax, and the
  last CTA of each (batch, KV head) merges the splits' partials.

The kernel reads ``t`` from a device int32, as the TPU kernel reads it from
SMEM: its launch shape (:func:`split_plan`) depends on the cache length,
the window and the SM count, never on ``t``, so a call does not sync with
the host and can be captured in a CUDA graph. The cache length ``S`` need
not be a multiple of anything: positions past ``t`` are never read.

A shard's mergeable partial: the cache may be one shard's slice of a
sequence-sharded cache (a view, any batch stride), whose first slot is the
global position ``pos0``; ``include_t=False`` stops the allowed range at
``t - 1`` (the reference's read-only cache, the new token folded in by the
caller), and ``lse=True`` returns ``(o, lse)``: the output in float32,
unrounded, and each row's natural log-sum-exp ``[B, H]`` float32, which
`repro_torch.models.attention.lse_combine` merges across shards. A shard
with no allowed position gives ``o = 0`` and ``lse = -inf``. ``t`` must lie
in the whole cache, ``[0, cache_len)``.
"""

from __future__ import annotations

import torch

from repro_torch.device import canonical_device
from repro_torch.kernels import _build

NEG = -1e30
MAX_G = 8  # query heads per KV head the kernel holds
MAX_HD = 256
WARPS = 4  # warps per CTA (csrc/flash_decode.cu kWarps)
ROWS, STAGES = 4, 3  # positions per stage and stages of each warp's cp.async ring
WAVES = 4  # CTAs per SM the split plan aims at
SPLIT_ALIGN = 16  # split sizes are rounded up to a multiple of this
MAX_SPLITS = 1024  # splits per (batch, KV head), at most
SMEM_LIMIT = 128 * 1024  # the kernel's dynamic shared-memory permission (csrc kMaxSmem)

# per device: the error word (never freed, so a CUDA graph may hold it)
_ERRORS: dict[torch.device, torch.Tensor] = {}


def allowed_range(t: int, window: int | None, *, pos0: int = 0, s: int | None = None,
                  include_t: bool = True) -> tuple[int, int]:
    """``[lo, hi]``: the positions a token at ``t`` attends to, in the
    slice's own positions (the slice holds ``s`` positions from global
    ``pos0``; ``s=None``: the whole cache from 0). ``hi < lo`` when the
    slice holds none."""
    lo = max(0, t - window + 1) if window is not None else 0
    hi = t if include_t else t - 1
    lo = max(lo, pos0) - pos0
    hi = (hi if s is None else min(hi, pos0 + s - 1)) - pos0
    return lo, hi


def flash_decode_ref(q, k_cache, v_cache, t: int, *, window: int | None = None,
                     cap: float | None = None, pos0: int = 0, include_t: bool = True,
                     lse: bool = False):
    """Plain PyTorch one-token attention over the cache's allowed positions
    (``<= t``, or ``<= t - 1`` without ``include_t``, global positions from
    ``pos0``). With ``lse``: ``(o float32 [B,H,hd], lse float32 [B,H])``,
    ``o = 0`` and ``lse = -inf`` where the slice holds no allowed position."""
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    lo, hi = allowed_range(int(t), window, pos0=pos0, s=k_cache.shape[1], include_t=include_t)
    if hi < lo:
        if not lse:
            raise ValueError(f"no allowed position at t={t} in a slice from {pos0}")
        return (torch.zeros((b, h, hd), dtype=torch.float32, device=q.device),
                torch.full((b, h), -torch.inf, dtype=torch.float32, device=q.device))
    kc = k_cache[:, lo : hi + 1].float()
    vc = v_cache[:, lo : hi + 1].float()
    sc = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(b, kv, g, hd), kc) * hd ** -0.5
    if cap is not None:
        sc = cap * torch.tanh(sc / cap)
    p = torch.softmax(sc, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bkgs,bskd->bkgd", p, vc).reshape(b, h, hd)
    if lse:
        return o, torch.logsumexp(sc, dim=-1).reshape(b, h)
    return o.to(q.dtype)


def cost(q, k_cache, v_cache, t: int | None, *, window: int | None = None, pos0: int = 0,
         cache_len: int | None = None, include_t: bool = True, lse: bool = False) -> dict:
    """The least work of one call (PERF.md's Bound column): the query read
    and the output written once (float32 and the log-sum-exp with ``lse``),
    K and V of the slice's allowed positions read once; ``4 hd`` operations
    a (query head, position) pair. ``t`` on the device cannot be read
    without a sync (and not at all on ``meta``): then the call is counted at
    the whole cache's last position, ``t = cache_len - 1``."""
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if t is None:
        t = (pos0 + s if cache_len is None else cache_len) - 1
    lo, hi = allowed_range(int(t), window, pos0=pos0, s=s, include_t=include_t)
    n_pos = max(hi - lo + 1, 0)
    cls = "bf16" if q.dtype == torch.bfloat16 else "f32"
    out_bytes = 4 * (q.numel() + b * h) if lse else q.element_size() * q.numel()
    return {"flops": {cls: 4 * b * h * hd * n_pos},
            "bytes": q.element_size() * (q.numel() + 2 * b * n_pos * kv * hd) + out_bytes}


def split_plan(s: int, window: int | None, pairs: int, n_sm: int, max_block: int
               ) -> tuple[int, int]:
    """``(block_s, n_splits)`` of a launch over a cache of ``s`` positions
    for ``pairs`` (batch, KV head) pairs on ``n_sm`` SMs: about ``WAVES``
    CTAs per SM over the span a token can attend to (the cache, or the
    window), each split at most ``max_block`` positions unless that would
    take more than ``MAX_SPLITS`` splits, and enough splits for every ``t``
    (:func:`split_ranges`)."""
    span = s if window is None else min(s, window)
    want = max(1, -(-WAVES * n_sm // pairs))  # splits per pair
    def up(x: int) -> int:
        return -(-x // SPLIT_ALIGN) * SPLIT_ALIGN

    block = max(min(max_block, up(-(-span // want))), up(-(-s // MAX_SPLITS)))
    n = -(-s // block)
    if window is not None:
        n = min(n, -(-(window - 1) // block) + 1)
    return block, n


def split_ranges(t: int, window: int | None, block_s: int, n_splits: int) -> list[tuple[int, int]]:
    """The ``[start, end)`` positions each split of a launch takes at ``t``
    (the kernel's arithmetic; empty ranges do no work)."""
    lo, hi = allowed_range(t, window)
    blk0 = lo // block_s
    return [(max((blk0 + i) * block_s, lo), min((blk0 + i + 1) * block_s, hi + 1))
            for i in range(n_splits)]


def _g_slots(g: int) -> int:
    """The G the kernel instantiation for ``g`` holds registers for."""
    return next(n for n in (1, 2, 4, MAX_G) if g <= n)


def smem_bytes(g: int, hd: int, dtype, n_splits: int) -> int:
    """Shared memory of a CTA: the warps' cp.async rings (K and V rows), or,
    after them and in the same bytes, the warps' states for the CTA's merge,
    or the last CTA's weights of the splits."""
    row = hd * (4 if dtype == torch.float32 else 2)
    ring = WARPS * STAGES * ROWS * 2 * row
    merge = 4 * (2 * WARPS * _g_slots(g) + WARPS * g * hd)
    weights = 4 * (n_splits * g + g)
    return max(ring, merge, weights)


def check_geometry(dtype, h: int, kv: int, hd: int, block_s: int) -> None:
    """Raise ValueError for sizes the CUDA kernel does not take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash decode kernel: dtype {dtype} (float32 or bfloat16 expected)")
    if h % kv or h // kv > MAX_G:
        raise ValueError(f"flash decode kernel: {h} heads over {kv} KV heads; at most "
                         f"{MAX_G} query heads per KV head")
    vec = 16 // (4 if dtype == torch.float32 else 2)
    if hd % vec or hd > MAX_HD:
        raise ValueError(f"flash decode kernel: head_dim {hd} must be a multiple of {vec} "
                         f"up to {MAX_HD}")
    if block_s < SPLIT_ALIGN or block_s % SPLIT_ALIGN:
        raise ValueError(f"flash decode kernel: block_s {block_s} must be a positive multiple "
                         f"of {SPLIT_ALIGN}")


# the C entry point's parameters, in order: p a pointer, i an int, f a float
LAUNCH_ARGS = "p" * 12 + "i" * 12 + "ff" + "ii" + "p"
_launch = _build.Entry("flash_decode", LAUNCH_ARGS)


def _error_word(dev: torch.device) -> torch.Tensor:
    if dev not in _ERRORS:
        _ERRORS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _ERRORS[dev]


def take_error(dev) -> int:
    """The device error word (1 after a call whose device ``t`` lay outside
    its cache; that call's outputs are NaN), cleared. Syncs."""
    dev = canonical_device(dev)
    if dev not in _ERRORS:
        return 0
    word = int(_ERRORS[dev].item())
    _ERRORS[dev].zero_()
    return word


def _positions_view(name: str, x: torch.Tensor) -> int:
    """The batch stride, in positions, of a cache ``[B, S, KV, hd]`` whose
    rows are contiguous ``[S, KV, hd]`` blocks (a whole cache, or a view of
    a slice of its positions); raises for any other layout."""
    b, s, kv, hd = x.shape
    if x.stride(3) != 1 or x.stride(2) != hd or x.stride(1) != kv * hd:
        raise ValueError(f"flash decode kernel: {name} must hold each position's [KV, hd] "
                         f"rows contiguously, got strides {x.stride()}")
    if b > 1 and (x.stride(0) % (kv * hd) or x.stride(0) < s * kv * hd):
        raise ValueError(f"flash decode kernel: {name}'s batch stride {x.stride(0)} is not a "
                         f"whole number of positions past its {s}")
    return x.stride(0) // (kv * hd) if b > 1 else s


def flash_decode_cuda(q, k_cache, v_cache, t, *, window: int | None, cap: float | None,
                      block_s: int, pos0: int = 0, cache_len: int | None = None,
                      include_t: bool = True, lse: bool = False):
    """Launch the CUDA kernel on CUDA tensors of one dtype (checked by the
    caller): ``q`` contiguous, the caches contiguous or views of a slice of
    positions of one cache (the same strides); ``t`` is a 0-d int32 tensor
    on the same card. No host sync. The partials and the (b, kv) counters
    that find each pair's merging CTA are allocated for this call on its
    stream (inside a CUDA graph capture, from the graph's pool), so calls on
    two streams or in two graphs never share them. Returns the output, or
    ``(o float32, lse float32)`` with ``lse``. Raises on any build or launch
    error, and on sizes the kernel cannot take."""
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    check_geometry(q.dtype, h, kv, hd, block_s)
    if not q.is_contiguous():
        raise ValueError("flash decode kernel: q must be contiguous")
    stride_b = _positions_view("k_cache", k_cache)
    if v_cache.stride() != k_cache.stride():
        raise ValueError("flash decode kernel: k_cache and v_cache must share their strides")
    _build.check_aligned("flash decode kernel", q=q, k_cache=k_cache, v_cache=v_cache)
    if t.dtype != torch.int32 or t.numel() != 1 or t.device != q.device:
        raise ValueError(f"flash decode kernel: t must be one int32 on {q.device}")
    total = pos0 + s if cache_len is None else cache_len
    if pos0 < 0 or pos0 + s > total:
        raise ValueError(f"flash decode kernel: a slice of {s} from {pos0} outside a cache of "
                         f"{total}")
    dev = q.device
    block, n_splits = split_plan(s, window, b * kv, _build.sm_count(dev), block_s)
    part_m = torch.empty((b * kv, n_splits, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * kv, n_splits, g, hd), dtype=torch.float32, device=dev)
    counters = torch.zeros(b * kv, dtype=torch.int32, device=dev)
    if lse:
        out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
        row_lse = torch.empty((b, h), dtype=torch.float32, device=dev)
        o_ptr, o32_ptr, lse_ptr = None, out.data_ptr(), row_lse.data_ptr()
    else:
        out = torch.empty_like(q)
        o_ptr, o32_ptr, lse_ptr = out.data_ptr(), None, None
    _launch(
        dev, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), t.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), counters.data_ptr(),
        _error_word(dev).data_ptr(), o_ptr, o32_ptr, lse_ptr, b, s, stride_b, pos0,
        int(not include_t), total, kv, g, hd, 0 if window is None else int(window), block,
        n_splits, hd ** -0.5, 0.0 if cap is None else float(cap), int(q.dtype == torch.bfloat16),
        smem_bytes(g, hd, q.dtype, n_splits),
    )
    return (out, row_lse) if lse else out
