"""Blockwise (flash) attention: causal + sliding window + gemma2 soft cap +
native GQA, as the Pallas kernel `repro.kernels.flash_attn` computes it.

Two versions of one function, ``q [B,S,H,hd]``, ``k``/``v [B,S,KV,hd]`` ->
``[B,S,H,hd]`` in ``q``'s dtype, where query head ``h`` reads KV head
``h // (H / KV)``:

* :func:`flash_attention_ref`, plain PyTorch: full rows of float32 scores
  (taken ``ROW_CHUNK`` query rows at a time, so memory stays bounded; every
  row's softmax covers all its keys, so the chunk changes nothing), masked
  with ``NEG`` (never ``-inf``), probabilities rounded to ``v``'s dtype
  before the P.V product as the kernel does, accumulated in float32.
* :func:`flash_attention_cuda`, the hand-written CUDA kernel
  (``csrc/flash_attn.cu``): one CTA per (b, h, q block) looping over the KV
  blocks with the online-softmax state in registers; bfloat16 on the tensor
  cores (``mma.sync``), float32 on the CUDA cores.

`repro_torch.kernels.ops.flash_attention` picks one by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -1e30
ROW_CHUNK = 512  # query rows per step of the plain version
# head dims the bfloat16 kernel is built for (csrc/flash_attn.cu's switch)
BF16_HEAD_DIMS = (32, 64, 80, 128, 256)
SUB_KEYS = 64  # keys per compute sub-tile of the bfloat16 kernel
F32_MAX_HD = 256
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100


def _allowed(pos_q, pos_k, causal: bool, window: int | None):
    ok = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool, device=pos_q.device)
    if causal:
        ok &= pos_k[None, :] <= pos_q[:, None]
    if window is not None:
        ok &= pos_q[:, None] - pos_k[None, :] < window
    return ok


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                        cap: float | None = None) -> torch.Tensor:
    """Plain PyTorch attention with GQA / window / soft cap (the kernel's
    arithmetic, one full softmax per row)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    kf = k.float()
    vf = v.float()
    pos_k = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for a in range(0, s, ROW_CHUNK):
        qc = q[:, a : a + ROW_CHUNK].float().reshape(b, -1, kv, g, hd)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qc, kf) * scale
        if cap is not None:
            sc = cap * torch.tanh(sc / cap)
        ok = _allowed(torch.arange(a, a + qc.shape[1], device=q.device), pos_k, causal, window)
        sc = torch.where(ok, sc, torch.full((), NEG, device=q.device))
        p = torch.softmax(sc, dim=-1).to(v.dtype).float()
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
        out[:, a : a + ROW_CHUNK] = o.reshape(b, -1, h, hd).to(q.dtype)
    return out


def smem_bytes(block_q: int, block_k: int, hd: int) -> int:
    """Shared memory of the bfloat16 kernel: Q, K and V tiles, each row
    padded by 8 elements (the float32 kernel stages one row per warp)."""
    return (block_q + 2 * block_k) * (hd + 8) * 2


def check_geometry(dtype, s: int, hd: int, block_q: int, block_k: int) -> None:
    """Raise ValueError for sizes the CUDA kernel does not take."""
    if dtype == torch.bfloat16:
        if hd not in BF16_HEAD_DIMS:
            raise ValueError(f"the bf16 flash kernel is built for head_dim {BF16_HEAD_DIMS}, "
                             f"got {hd}")
        if block_q % 16 or not 16 <= block_q <= 128:
            raise ValueError(f"flash kernel: block_q {block_q} must be a multiple of 16 "
                             "in 16..128 (one warp per 16 rows)")
        if block_k % SUB_KEYS:
            raise ValueError(f"flash kernel: block_k {block_k} must be a multiple of {SUB_KEYS}")
        need = smem_bytes(block_q, block_k, hd)
        if need > SMEM_LIMIT:
            raise ValueError(
                f"flash kernel: a {block_q}x{block_k} tile at head_dim {hd} needs {need} bytes "
                f"of shared memory, over the {SMEM_LIMIT} a block may use; lower "
                "flash_block_q / flash_block_k")
    elif dtype == torch.float32:
        if hd % 4 or hd > F32_MAX_HD:
            raise ValueError(f"the float32 flash kernel takes head_dim a multiple of 4 up to "
                             f"{F32_MAX_HD}, got {hd}")
    else:
        raise TypeError(f"flash kernel: dtype {dtype} (float32 or bfloat16 expected)")
    if s % block_q or s % block_k:
        raise ValueError(f"sequence {s} not divisible by block_q {block_q} / block_k {block_k}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attn_launch.argtypes = [p] * 4 + [i] * 5 + [f, f] + [i] * 5 + [p]
        lib.flash_attn_launch.restype = i
        lib.flash_attn_error_string.argtypes = [i]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool, window: int | None, cap: float | None,
                         block_q: int, block_k: int) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors of one dtype
    (checked by the caller). Raises on any build or launch error, and on
    sizes the kernel cannot take."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    check_geometry(q.dtype, s, hd, block_q, block_k)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must start 16-byte aligned")
    out = torch.empty_like(q)
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    rc = lib.flash_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kv, hd,
        hd ** -0.5, 0.0 if cap is None else float(cap), int(causal),
        0 if window is None else int(window), block_q, block_k,
        int(q.dtype == torch.bfloat16), stream,
    )
    if rc != 0:
        msg = lib.flash_attn_error_string(rc).decode()
        raise RuntimeError(f"flash_attn launch failed: CUDA error {rc} ({msg})")
    return out
