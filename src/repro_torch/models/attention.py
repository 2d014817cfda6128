"""Attention as plain tensor functions: the chunked (flash-style) prefill
attention, the full-cache decode attention and the split-cache partials
with their log-sum-exp merge (the port's copy of `repro.models.attention`).

The model's own attention runs through the kernels
(`repro_torch.kernels.ops.flash_attention` in prefill,
`ops.flash_decode` in decode); these are their references at the model's
level and the pieces of the sequence-sharded decode.
:func:`decode_attend_seqsharded` (a ``shard_map`` over a mesh in the
reference) runs each shard's partial through the decode kernel over its
slice of the cache, one shard after another on its mesh device, and
merges them by log-sum-exp with the port's collectives
(`distributed.sharding.pmax_parts` / ``psum_parts``);
:func:`lse_merge` takes the shards' partials as a list instead of mesh
axes.

``window_active`` is a Python bool here (the layers are a Python loop), or
``None`` for "the window applies".
"""

from __future__ import annotations

import torch

import math

from repro_torch.distributed.sharding import Mesh, device_runs, pmax_parts, psum_parts
from repro_torch.kernels import ops
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


def lse_combine(m, l, o):
    """The shards' partials stacked on one device, ``m``/``l`` ``[n, ...]``
    and ``o~`` ``[n, ..., hd]`` -> the merged ``(m_g, l_g, o_g)``,
    unnormalised: the pmax of ``m``, then ``l`` and ``o~`` rescaled to it
    and psum-ed (the reference's ``lse_merge`` before its division), each
    an all-reduce among the ``n`` shards (`sharding.pmax_parts` /
    ``psum_parts``)."""
    n = m.shape[0]
    m_g = pmax_parts([m.amax(dim=0)], group=n)
    corr = torch.exp(m - m_g)
    l_g = psum_parts([(l * corr).sum(dim=0)], group=n)
    o_g = psum_parts([(o * corr[..., None]).sum(dim=0)], group=n)
    return m_g, l_g, o_g


def lse_merge(partials) -> torch.Tensor:
    """Merge the shards' ``(m, l, o~)`` partials (a list) -> the normalised
    output: the reduce step of split-KV decode."""
    dev = partials[0][0].device
    _, l_g, o_g = lse_combine(*(torch.stack([p[i].to(dev) for p in partials])
                                for i in range(3)))
    return o_g / torch.clamp(l_g[..., None], min=1e-30)


def kernel_partial(o, lse):
    """Decode kernel outputs ``(o, lse)`` (`ops.flash_decode(..., lse=True)`,
    any leading dims) as an ``(m, l, o~)`` partial: ``m = lse``, ``l = 1``,
    ``o~ = o``; a shard with no allowed position (``lse = -inf``) gives
    ``m = NEG``, ``l = 0``, ``o~ = 0``, which any merge weighs at 0 (and an
    all-empty merge leaves ``l_g = 0``, as the reference's masked partials
    do once folded)."""
    empty = torch.isneginf(lse)
    return torch.where(empty, torch.full_like(lse, NEG), lse), (~empty).to(lse.dtype), o


def decode_attend_seqsharded(mesh: Mesh, *, seq_axes: tuple[str, ...], batch_axes=None,
                             window: int | None = None, cap: float | None = None):
    """The reference's decode attention over a sequence-sharded cache:
    ``fn(q [B,H,hd], kn [B,KV,hd], vn [B,KV,hd], k_cache [B,S,KV,hd],
    v_cache, t, window_active) -> [B,H,hd]`` float32.

    The sequence is cut into ``prod(seq_axes)`` shards, the flat shard
    index row-major over ``seq_axes`` (the reference's ``idx = idx *
    axis_size(a) + axis_index(a)``); the batch into the shards of
    ``batch_axes`` (an axis name, a tuple of them, or None). Each shard
    runs `ops.flash_decode` on its slice of the cache — a view, moved to
    the shard's device only where that is another; batch shards that share
    a device take one launch over their rows (`sharding.device_runs`) — at
    positions ``<= t - 1``: the cache is read-only here, and the new
    token's ``(kn, vn)`` is folded in after the cross-shard merge
    (:func:`lse_combine`, on the first shard's device), as the reference's
    ``local`` does. ``t`` is a host int or a one-element tensor, which the
    kernel reads on the card. ``window_active`` is a Python bool.
    """
    seq_axes = tuple(seq_axes)
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    batch_axes = tuple(batch_axes or ())
    n_seq = math.prod(mesh.shape[a] for a in seq_axes)
    n_b = math.prod(mesh.shape[a] for a in batch_axes)

    def device(bi: int, si: int) -> torch.device:
        coords = dict.fromkeys(mesh.axis_names, 0)
        for axes, i in ((seq_axes, si), (batch_axes, bi)):
            for a in reversed(axes):
                i, coords[a] = divmod(i, mesh.shape[a])
        return mesh.devices[tuple(coords[a] for a in mesh.axis_names)]

    def attend(q, kn, vn, k_cache, v_cache, t, window_active: bool):
        b, h, hd = q.shape
        s, kv = k_cache.shape[1], kn.shape[1]
        g = h // kv
        if s % n_seq or b % n_b:
            raise ValueError(f"a cache [B {b}, S {s}] does not split over {n_b} batch and "
                             f"{n_seq} sequence shards")
        s_loc, b_loc = s // n_seq, b // n_b
        w = window if window_active else None
        home = q.device
        outs, lses = [], []
        for si in range(n_seq):
            kc, vc = k_cache.narrow(1, si * s_loc, s_loc), v_cache.narrow(1, si * s_loc, s_loc)
            parts = []
            for dev, b0, b1 in device_runs([device(bi, si) for bi in range(n_b)]):
                rows = slice(b0 * b_loc, b1 * b_loc)
                o, lse = ops.flash_decode(
                    q[rows].to(dev), kc[rows].to(dev), vc[rows].to(dev),
                    t.to(dev) if isinstance(t, torch.Tensor) else t, window=w, cap=cap,
                    pos0=si * s_loc, cache_len=s, include_t=False, lse=True)
                parts.append((o.to(home), lse.to(home)))
            outs.append(parts[0][0] if len(parts) == 1 else torch.cat([o for o, _ in parts]))
            lses.append(parts[0][1] if len(parts) == 1 else torch.cat([x for _, x in parts]))
        m_g, l_g, o_g = lse_combine(*kernel_partial(torch.stack(outs), torch.stack(lses)))
        # the new token's own term (always in its window), folded in last
        s_new = torch.einsum("bkgd,bkd->bkg", q.float().reshape(b, kv, g, hd), kn.float())
        s_new = softcap(s_new * hd ** -0.5, cap).reshape(b, h)
        m_f = torch.maximum(m_g, s_new)
        w_c, w_n = torch.exp(m_g - m_f), torch.exp(s_new - m_f)
        v_new = vn.float()[:, :, None].expand(b, kv, g, hd).reshape(b, h, hd)
        num = o_g * w_c[..., None] + v_new * w_n[..., None]
        return num / torch.clamp((l_g * w_c + w_n)[..., None], min=1e-30)

    return attend
