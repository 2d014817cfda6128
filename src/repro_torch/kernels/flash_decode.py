"""Split-KV single-token decode attention, as the Pallas kernel
`repro.kernels.flash_decode` computes it.

One new token per sequence, ``q [B,H,hd]``, attends over a cache
``[B,S,KV,hd]`` at positions ``<= t`` (and ``t - pos < window``), with an
optional soft cap; query head ``h = kv * G + g`` reads KV head ``kv``.

* :func:`flash_decode_ref`, plain PyTorch: float32 scores over the allowed
  positions, one softmax, probabilities rounded to the cache's dtype before
  the P.V product, accumulated in float32.
* :func:`flash_decode_cuda`, the hand-written CUDA kernel
  (``csrc/flash_decode.cu``): CTAs over (position block, KV head, batch),
  each emitting ``(m, l, acc)``, then an LSE-merge kernel.

``t`` is a host integer (a tensor is read once with ``int``). The cache
length ``S`` need not be a multiple of ``block_s``: positions past ``t``
are never read.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -1e30
MAX_G = 8  # query heads per KV head the kernel holds
MAX_HD = 256
THREADS = 256
SMEM_LIMIT = 232_448


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


def smem_bytes(g: int, hd: int, block_s: int) -> int:
    """Shared memory of the partial kernel: the G queries, G x block_s
    scores and one G x hd sum per warp, all float32."""
    return 4 * (g * hd + g * block_s + (THREADS // 32) * g * hd)


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
    if smem_bytes(h // kv, hd, block_s) > SMEM_LIMIT:
        raise ValueError(f"flash decode kernel: block_s {block_s} does not fit shared memory")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_launch.argtypes = [p] * 7 + [i] * 10 + [f, f, i, i, p]
        lib.flash_decode_launch.restype = i
        lib.flash_decode_error_string.argtypes = [i]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def flash_decode_cuda(q, k_cache, v_cache, t: int, *, window: int | None,
                      cap: float | None, block_s: int) -> torch.Tensor:
    """Launch the CUDA kernels on contiguous CUDA tensors of one dtype
    (checked by the caller). Raises on any build or launch error, and on
    sizes the kernel cannot take."""
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    check_geometry(q.dtype, h, kv, hd, block_s)
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash decode kernel: {name} must start 16-byte aligned")
    lo, hi = allowed_range(t, window)
    split0 = lo // block_s
    n_splits = hi // block_s - split0 + 1
    dev = q.device
    part_m = torch.empty((b, kv, n_splits, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kv, n_splits, g, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = lib.flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, s, kv, g, hd, t, lo,
        block_s, split0, n_splits, hd ** -0.5, 0.0 if cap is None else float(cap),
        int(q.dtype == torch.bfloat16), smem_bytes(g, hd, block_s), stream,
    )
    if rc != 0:
        msg = lib.flash_decode_error_string(rc).decode()
        raise RuntimeError(f"flash_decode launch failed: CUDA error {rc} ({msg})")
    return out
