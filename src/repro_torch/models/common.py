"""Shared model pieces: RMSNorm, RoPE, soft cap, activations, init (the
port's copy of `repro.models.common`; ``init_dense`` draws from a
``torch.Generator`` instead of a JAX key)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, *, one_plus: bool = False, eps: float = 1e-6):
    """RMSNorm in float32, back in ``x``'s dtype; gemma's ``(1 + w)`` scale
    with ``one_plus``."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if one_plus else w.float()
    return (x * scale).to(dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., D] @ w [D, N]`` with a float32 result: bfloat16 products
    are exact in float32, so both paths accumulate the same products in
    float32 (the reference's ``preferred_element_type=f32``)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype == torch.bfloat16:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embedding. positions [...] -> [..., hd/2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    freq = 1.0 / (theta ** (exponent / head_dim))
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., seq, heads, hd]; cos/sin [..., seq, hd/2] (broadcast over
    heads). Split halves, math in float32, back in ``x``'s dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    """``"gelu"`` is the tanh approximation, as ``jax.nn.gelu``'s default."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def init_dense(generator: torch.Generator, shape, dtype, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Normal weights with std ``scale`` (default ``fan_in ** -0.5``), drawn
    in float32 on ``device`` from ``generator`` (on the same device)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)
