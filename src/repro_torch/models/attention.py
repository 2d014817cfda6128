"""Attention as plain tensor functions: the chunked (flash-style) prefill
attention, the full-cache decode attention and the split-cache partials
with their log-sum-exp merge (the port's copy of `repro.models.attention`).

The model's own attention runs through the kernels
(`repro_torch.kernels.ops.flash_attention` in prefill,
`ops.flash_decode` in decode); these are their references at the model's
level and the pieces of the sequence-sharded decode.
``decode_attend_seqsharded`` (a ``shard_map`` over a mesh in the reference)
waits for the multi-shard slice, ROADMAP queue 1 item 3
(`transformer.make_serve_step` refuses a cache sharded over its
sequence); :func:`lse_merge` takes the shards' partials as a list instead
of mesh axes.

``window_active`` is a Python bool here (the layers are a Python loop), or
``None`` for "the window applies".
"""

from __future__ import annotations

import torch

from repro_torch.models.common import softcap

NEG = -1e30


def _mask_ok(pos_q, pos_k, *, causal: bool, window: int | None, window_active):
    """Bool mask [len(pos_q), len(pos_k)] from global positions; the window
    constraint is OR-ed away when ``window_active`` is false."""
    ok = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool, device=pos_q.device)
    if causal:
        ok &= pos_k[None, :] <= pos_q[:, None]
    if window is not None:
        in_window = pos_q[:, None] - pos_k[None, :] < window
        if window_active is None:
            ok &= in_window
        else:
            ok &= in_window | ~torch.as_tensor(window_active, device=pos_q.device)
    return ok


def chunked_attention(q, k, v, *, q_block: int, causal: bool = True,
                      window: int | None = None, window_active=None,
                      cap: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Skv,H,hd] (GQA pre-expanded by the caller):
    one query block at a time, float32 scores, full-row softmax,
    probabilities in ``v``'s dtype."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if sq % q_block:
        raise ValueError(f"query length {sq} not divisible by q_block {q_block}")
    scale = hd ** -0.5
    pos_k = torch.arange(skv, device=q.device)
    outs = []
    for a in range(0, sq, q_block):
        pos_q = q_offset + a + torch.arange(q_block, device=q.device)
        s = torch.einsum("bqhd,bshd->bhqs", q[:, a : a + q_block].float(), k.float())
        s = softcap(s * scale, cap)
        ok = _mask_ok(pos_q, pos_k, causal=causal, window=window, window_active=window_active)
        s = torch.where(ok[None, None], s, torch.full((), NEG, device=q.device))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype).float(), v.float()).to(v.dtype))
    return torch.cat(outs, dim=1)


def attend_cache(q, k_cache, v_cache, t, *, window: int | None = None, window_active=None,
                 cap: float | None = None, pos_k=None) -> torch.Tensor:
    """Full-cache decode attention: q [B,H,hd] over [B,S,KV,hd] at
    positions <= t."""
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    if pos_k is None:
        pos_k = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(b, kv, g, hd), k_cache.float())
    s = softcap(s * hd ** -0.5, cap)
    ok = pos_k <= t
    if window is not None:
        in_w = t - pos_k < window
        ok &= in_w if window_active is None else (in_w | ~torch.as_tensor(window_active))
    s = torch.where(ok[None, None, None, :], s, torch.full((), NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return o.to(v_cache.dtype).reshape(b, h, hd)


def _partial_attend(q, k_loc, v_loc, pos_loc, t, *, window, window_active, cap,
                    pos_limit=None):
    """One shard's partial softmax summary ``(m, l, o~)``, float32.

    ``pos_limit`` (inclusive) defaults to ``t``; the window is always
    relative to the query position ``t``.
    """
    b, h, hd = q.shape
    kv = k_loc.shape[2]
    g = h // kv
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(b, kv, g, hd), k_loc.float())
    s = softcap(s * hd ** -0.5, cap)
    ok = pos_loc <= (t if pos_limit is None else pos_limit)
    if window is not None:
        in_w = t - pos_loc < window
        ok &= in_w if window_active is None else (in_w | ~torch.as_tensor(window_active))
    s = torch.where(ok[None, None, None, :], s, torch.full((), NEG, device=q.device))
    m = torch.amax(s, dim=-1)  # [b,kv,g]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_loc.dtype).float(), v_loc.float())
    return m, l, o


def lse_merge(partials) -> torch.Tensor:
    """Merge the shards' ``(m, l, o~)`` partials (a list) -> the normalised
    output: the reduce step of split-KV decode."""
    m_g = torch.stack([m for m, _, _ in partials]).amax(dim=0)
    l_g = sum(l * torch.exp(m - m_g) for m, l, _ in partials)
    o_g = sum(o * torch.exp(m - m_g)[..., None] for m, _, o in partials)
    return o_g / torch.clamp(l_g[..., None], min=1e-30)
