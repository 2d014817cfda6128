"""The k-bounded bitonic merge of two (score, id) lists, as tensor code.

`repro.kernels.score_topk` holds the dense score+top-k Pallas kernel and
the merge network its fold (and the lexical kernel's) is built from. This
slice ports the merge network (`bitonic_merge_desc`, `_pad_desc`), which
`topk.merge_lex` and the plain lexical scan use; the dense kernel's
counterpart waits for the dense slice.
"""

from __future__ import annotations

import torch


def bitonic_merge_desc(
    a_s: torch.Tensor, a_i: torch.Tensor, b_s: torch.Tensor, b_i: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two ``[..., m]`` (score, id) lists sorted by (score desc, id
    asc); keep the top m under that same lexicographic order.

    ``a ++ reverse(b)`` is bitonic, so one bitonic merge network —
    ``log2(2m)`` compare-exchange stages — yields the 2m values sorted; the
    first m are the merged top-m. ``m`` must be a power of two (pad with
    ``-inf``/``-1`` first). Ties break toward the smaller id.
    """
    m = a_s.shape[-1]
    if m & (m - 1):
        raise ValueError(f"bitonic merge needs power-of-two width, got {m}")
    lead = a_s.shape[:-1]
    s = torch.cat([a_s, b_s.flip(-1)], dim=-1)
    i = torch.cat([a_i, b_i.flip(-1)], dim=-1)
    length = 2 * m
    stride = m
    while stride >= 1:
        sr = s.reshape(*lead, length // (2 * stride), 2, stride)
        ir = i.reshape(*lead, length // (2 * stride), 2, stride)
        lo_s, hi_s = sr[..., 0, :], sr[..., 1, :]
        lo_i, hi_i = ir[..., 0, :], ir[..., 1, :]
        # descending by score, ascending by id on ties: max to lower position
        keep = (lo_s > hi_s) | ((lo_s == hi_s) & (lo_i <= hi_i))
        max_s = torch.where(keep, lo_s, hi_s)
        min_s = torch.where(keep, hi_s, lo_s)
        max_i = torch.where(keep, lo_i, hi_i)
        min_i = torch.where(keep, hi_i, lo_i)
        s = torch.stack([max_s, min_s], dim=-2).reshape(*lead, length)
        i = torch.stack([max_i, min_i], dim=-2).reshape(*lead, length)
        stride //= 2
    return s[..., :m], i[..., :m]


def _pad_desc(s: torch.Tensor, i: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-pad descending-sorted lists with (-inf, -1) sentinels."""
    pad = width - s.shape[-1]
    if pad == 0:
        return s, i
    shape = (*s.shape[:-1], pad)
    return (
        torch.cat([s, s.new_full(shape, float("-inf"))], dim=-1),
        torch.cat([i, i.new_full(shape, -1)], dim=-1),
    )
