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
* :func:`flash_attention_cuda`, the hand-written CUDA kernels
  (``csrc/flash_attn.cu``), a CTA per query block looping over the KV
  blocks with the online-softmax state in registers. Three routes, chosen
  by dtype and head_dim alone (:func:`route`): bfloat16 at head_dim 64, 128
  and 256 on TMA and ``wgmma`` (a producer warp and two consumer
  warpgroups, tile fixed at 128 query rows x :func:`wgmma_block_k` keys);
  bfloat16 at head_dim 32 and 80 on ``mma.sync`` (tile ``block_q`` x
  ``block_k``); float32 on the CUDA cores.

`repro_torch.kernels.ops.flash_attention` picks one by the tensors' device.

:func:`flash_attention_bwd` is the gradient of that function, in torch ops on
either device: the reference trains through ``chunked_attention``, which XLA
differentiates, and no Pallas kernel computes a gradient, so neither does a
kernel here. It recomputes one query block's scores at a time over the
keys that block can see (the causal and window band), so no ``[B,H,S,S]``
tensor is ever alive, and accumulates ``dk``/``dv`` over the blocks.
`ops.flash_attention_train` is the autograd function that joins the kernel's
forward to it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG = -1e30
ROW_CHUNK = 512  # query rows per step of the plain version
# head dims each bfloat16 route is built for (csrc/flash_attn.cu's switch)
WGMMA_HEAD_DIMS = (64, 128, 256)
MMA_HEAD_DIMS = (32, 80)
BF16_HEAD_DIMS = tuple(sorted(WGMMA_HEAD_DIMS + MMA_HEAD_DIMS))
SUB_KEYS = 64  # keys per compute sub-tile of the mma.sync route
F32_MAX_HD = 256
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100
WGMMA_BLOCK_Q = 128  # query rows per CTA of the wgmma route (two warpgroups of 64)
WGMMA_STAGES = 2  # depth of its K/V ring


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


def _mm_f32(a, b) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result: bfloat16 operands on the
    card's tensor cores (float32 accumulation; so on ``meta``, where an op
    counter reckons the card's work), float32 operands as they are, and on
    the CPU in float32 (bfloat16 products are exact there)."""
    if (a.is_cuda or a.is_meta) and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def flash_attention_bwd(q, k, v, do, *, causal: bool = True, window: int | None = None,
                        cap: float | None = None, block: int = 512):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_ref`'s function
    at ``q [B,S,H,hd]``, ``k``/``v [B,S,KV,hd]`` for the output cotangent
    ``do [B,S,H,hd]``, each in its input's dtype.

    ``block`` query rows at a time: their float32 scores over the band of
    keys they can see (causal: up to the block's last row; window: from
    its first row's earliest key) are recomputed, soft-capped and masked as
    in the forward, then the softmax's backward. The products take the
    inputs' dtype as operands and accumulate in float32 (bfloat16 on the
    tensor cores, the reference's operand dtype); probabilities and score
    gradients are rounded to that dtype before their products, as the
    forward rounds the probabilities before P.V. GQA: the ``H / KV`` query
    heads of a KV head are one batch of rows against it, so its ``dk``/
    ``dv`` sum over the group inside the products.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    dt = q.dtype
    scale = hd ** -0.5
    # [B*KV, g, S, hd] views of the query side, [B*KV, S, hd] of the key side
    qg = q.reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4).reshape(b * kv, g, s, hd)
    dog = do.reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4).reshape(b * kv, g, s, hd)
    kt = k.permute(0, 2, 1, 3).reshape(b * kv, s, hd)
    vt = v.permute(0, 2, 1, 3).reshape(b * kv, s, hd)
    dq = torch.empty_like(q)
    dk = torch.zeros((b * kv, s, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    neg = torch.full((), NEG, device=q.device)
    for a in range(0, s, block):
        e = min(a + block, s)
        lo = 0 if window is None else max(0, a + 1 - window)
        hi = e if causal else s
        rows = g * (e - a)
        qb = qg[:, :, a:e].reshape(b * kv, rows, hd)
        dob = dog[:, :, a:e].reshape(b * kv, rows, hd)
        kb, vb = kt[:, lo:hi], vt[:, lo:hi]
        sc = _mm_f32(qb, kb.transpose(1, 2)).mul_(scale)  # [B*KV, g*bq, n]
        t = None
        if cap is not None:
            t = torch.tanh(sc / cap)
            sc = t * cap
        ok = _allowed(torch.arange(a, e, device=q.device), torch.arange(lo, hi, device=q.device),
                      causal, window)
        sc = torch.where(ok, sc.view(b * kv, g, e - a, hi - lo), neg).view(b * kv, rows, -1)
        p = torch.softmax(sc, dim=-1)
        del sc
        dv[:, lo:hi] += _mm_f32(p.to(dt).transpose(1, 2), dob)
        ds = _mm_f32(dob, vb.transpose(1, 2))  # dP, float32
        ds.sub_((p * ds).sum(-1, keepdim=True)).mul_(p)
        del p
        if t is not None:
            ds.mul_(1.0 - t * t)
            del t
        ds = ds.mul_(scale).to(dt)
        dq[:, a:e] = _mm_f32(ds, kb).view(b, kv, g, e - a, hd).permute(0, 3, 1, 2, 4).reshape(
            b, e - a, h, hd).to(dt)
        dk[:, lo:hi] += _mm_f32(ds.transpose(1, 2), qb)
    back = lambda x: x.view(b, kv, s, hd).permute(0, 2, 1, 3).to(dt).contiguous()
    return dq, back(dk), back(dv)


def window_pairs(s: int, window: int | None, causal: bool = True) -> int:
    """(query, key) pairs a layer of ``s`` positions scores: ``j <= i``
    (causal) and ``i - j < window``."""
    if causal:
        if window is None or window >= s:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if window is None or window >= s:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


def cost(q, k, v, *, causal: bool = True, window: int | None = None) -> dict:
    """The least work of one forward call (PERF.md's Bound column): Q, K, V
    read and the output written once; ``4 hd`` operations a scored (query
    head, key) pair, products in the inputs' dtype (bfloat16 on the tensor
    cores, float32 on the CUDA cores)."""
    b, s, h, hd = q.shape
    flops = 4 * b * h * hd * window_pairs(s, window, causal)
    cls = "bf16" if q.dtype == torch.bfloat16 else "f32"
    return {"flops": {cls: flops},
            "bytes": q.element_size() * (2 * q.numel() + k.numel() + v.numel())}


def route(dtype, hd: int) -> str:
    """The kernel a call takes, by dtype and head_dim alone: ``"wgmma"``,
    ``"mma"`` or ``"f32"``. Raises for a bfloat16 head_dim no route is
    built for."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash kernel: dtype {dtype} (float32 or bfloat16 expected)")
    if hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    if hd in MMA_HEAD_DIMS:
        return "mma"
    raise ValueError(f"the bf16 flash kernels are built for head_dim {BF16_HEAD_DIMS}, got {hd}")


def wgmma_block_k(hd: int) -> int:
    """Keys per K/V tile of the wgmma route (`WgLayout<HD>::BK`)."""
    return 64 if hd == 256 else 128


def wgmma_smem_bytes(hd: int) -> int:
    """Shared memory of the wgmma route (`WgLayout<HD>::kBytes`): Q for
    128 rows, two stages of K and V tiles, 9 mbarriers, and 1024 bytes to
    align the tiles to the 128-byte swizzle's 1024-byte atoms."""
    bk = wgmma_block_k(hd)
    return WGMMA_BLOCK_Q * hd * 2 + 2 * WGMMA_STAGES * bk * hd * 2 + (1 + 4 * WGMMA_STAGES) * 8 \
        + 1024


def smem_bytes(block_q: int, block_k: int, hd: int) -> int:
    """Shared memory of the mma.sync route: Q, K and V tiles, each row
    padded by 8 elements (the float32 kernel stages one row per warp)."""
    return (block_q + 2 * block_k) * (hd + 8) * 2


def check_geometry(dtype, s: int, hd: int, block_q: int, block_k: int) -> None:
    """Raise ValueError for sizes the CUDA kernels do not take. The wgmma
    route's tile is its own (any ``s``: rows and keys past the end are
    masked); ``block_q`` / ``block_k`` shape only the mma.sync and float32
    routes, and every route needs them to divide ``s``, as the reference."""
    kind = route(dtype, hd)
    if kind == "mma":
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
    elif hd % 4 or hd > F32_MAX_HD:
        raise ValueError(f"the float32 flash kernel takes head_dim a multiple of 4 up to "
                         f"{F32_MAX_HD}, got {hd}")
    if s % block_q or s % block_k:
        raise ValueError(f"sequence {s} not divisible by block_q {block_q} / block_k {block_k}")


# the C entry point's parameters, in order: p a pointer, i an int, f a float
LAUNCH_ARGS = "p" * 4 + "i" * 5 + "ff" + "i" * 5 + "p"
_launch = _build.Entry("flash_attn", LAUNCH_ARGS)


def flash_attention_cuda(q, k, v, *, causal: bool, window: int | None, cap: float | None,
                         block_q: int, block_k: int) -> torch.Tensor:
    """Launch the CUDA kernel of :func:`route` on contiguous CUDA tensors of
    one dtype (checked by the caller). Raises on any build, tensor-map or
    launch error, and on sizes the kernel cannot take."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    check_geometry(q.dtype, s, hd, block_q, block_k)
    _build.check_aligned("flash kernel", q=q, k=k, v=v)
    out = torch.empty_like(q)
    _launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kv, hd,
        hd ** -0.5, 0.0 if cap is None else float(cap), int(causal),
        0 if window is None else int(window), block_q, block_k,
        int(q.dtype == torch.bfloat16),
    )
    return out
