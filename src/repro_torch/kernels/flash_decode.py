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
"""

from __future__ import annotations

import ctypes

import torch

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
_SMS: dict[torch.device, int] = {}


def allowed_range(t: int, window: int | None) -> tuple[int, int]:
    """``[lo, t]``: the positions a token at ``t`` attends to."""
    lo = max(0, t - window + 1) if window is not None else 0
    return lo, t


def flash_decode_ref(q, k_cache, v_cache, t: int, *, window: int | None = None,
                     cap: float | None = None) -> torch.Tensor:
    """Plain PyTorch one-token attention over the cache, positions <= t."""
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    lo, hi = allowed_range(int(t), window)
    kc = k_cache[:, lo : hi + 1].float()
    vc = v_cache[:, lo : hi + 1].float()
    sc = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(b, kv, g, hd), kc) * hd ** -0.5
    if cap is not None:
        sc = cap * torch.tanh(sc / cap)
    p = torch.softmax(sc, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bkgs,bskd->bkgd", p, vc)
    return o.reshape(b, h, hd).to(q.dtype)


def cost(q, k_cache, v_cache, t: int | None, *, window: int | None = None) -> dict:
    """The least work of one call (PERF.md's Bound column): the query read
    and the output written once, K and V of the attended positions read
    once; ``4 hd`` operations a (query head, position) pair. ``t`` on the
    device cannot be read without a sync (and not at all on ``meta``): then
    the call is counted at the cache's last position, ``t = S - 1``."""
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    lo, hi = allowed_range(k_cache.shape[1] - 1 if t is None else int(t), window)
    n_pos = hi - lo + 1
    cls = "bf16" if q.dtype == torch.bfloat16 else "f32"
    return {"flops": {cls: 4 * b * h * hd * n_pos},
            "bytes": q.element_size() * (2 * q.numel() + 2 * b * n_pos * kv * hd)}


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
    lo, _ = allowed_range(t, window)
    blk0 = lo // block_s
    return [(max((blk0 + i) * block_s, lo), min((blk0 + i + 1) * block_s, t + 1))
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_launch.argtypes = [p] * 10 + [i] * 8 + [f, f, i, i, p]
        lib.flash_decode_launch.restype = i
        lib.flash_decode_error_string.argtypes = [i]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def _error_word(dev: torch.device) -> torch.Tensor:
    if dev not in _ERRORS:
        _ERRORS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _ERRORS[dev]


def _card(dev) -> torch.device:
    """``dev`` with its index (``cuda`` is the current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def take_error(dev) -> int:
    """The device error word (1 after a call whose device ``t`` lay outside
    its cache; that call's outputs are NaN), cleared. Syncs."""
    dev = _card(dev)
    if dev not in _ERRORS:
        return 0
    word = int(_ERRORS[dev].item())
    _ERRORS[dev].zero_()
    return word


def sm_count(dev) -> int:
    """The card's SM count (cached)."""
    dev = _card(dev)
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def flash_decode_cuda(q, k_cache, v_cache, t, *, window: int | None, cap: float | None,
                      block_s: int) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors of one dtype
    (checked by the caller); ``t`` is a 0-d int32 tensor on the same card.
    No host sync. The partials and the (b, kv) counters that find each
    pair's merging CTA are allocated for this call on its stream (inside a
    CUDA graph capture, from the graph's pool), so calls on two streams or
    in two graphs never share them. Raises on any build or launch error, and
    on sizes the kernel cannot take."""
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    check_geometry(q.dtype, h, kv, hd, block_s)
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash decode kernel: {name} must start 16-byte aligned")
    if t.dtype != torch.int32 or t.numel() != 1 or t.device != q.device:
        raise ValueError(f"flash decode kernel: t must be one int32 on {q.device}")
    dev = q.device
    block, n_splits = split_plan(s, window, b * kv, sm_count(dev), block_s)
    part_m = torch.empty((b * kv, n_splits, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * kv, n_splits, g, hd), dtype=torch.float32, device=dev)
    counters = torch.zeros(b * kv, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = lib.flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), t.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), counters.data_ptr(),
        _error_word(dev).data_ptr(), out.data_ptr(), b, s, kv, g, hd,
        0 if window is None else int(window), block, n_splits, hd ** -0.5,
        0.0 if cap is None else float(cap), int(q.dtype == torch.bfloat16),
        smem_bytes(g, hd, q.dtype, n_splits), stream,
    )
    if rc != 0:
        msg = lib.flash_decode_error_string(rc).decode()
        raise RuntimeError(f"flash_decode launch failed: CUDA error {rc} ({msg})")
    return out
