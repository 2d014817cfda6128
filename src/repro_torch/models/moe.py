"""Mixture-of-Experts FFN with capacity dispatch over a mesh (the port's copy
of `repro.models.moe`).

Design, as the reference's: activations arrive data-sharded and
tp-replicated, so every model shard sees its whole local token set and
gathers the tokens routed to *its* ``E / tp`` experts directly — dispatch
needs no all-to-all; the only reduction is a sum of partial outputs over
``tp`` (the reference's ``psum``). Routing is softmax, top-k, renormalise;
capacity ``C = round8(tokens_per_shard * k / E * cf)`` gives static
shapes; a token's position within its expert comes from a stable sort
(memory O(T k), never O(T E C)); dispatch is gather-only. Expert weights
too large to shard over ``tp`` alone (``fsdp_experts``) are also cut over
``dp`` on the ``d_ff`` dim: the ``train``/``seq`` modes gather them just in
time, ``replicated`` (decode, tokens on every shard) runs tensor
parallelism over ``d_ff`` on the dp axes instead and sums the partial
down-projections with the tp partials.

The reference runs the layer as a ``shard_map``; torch has none. Here
:func:`make_moe_layer` runs each shard's body on its mesh device
(`repro_torch.distributed.sharding.Mesh`) in shard order and does the
collectives itself: a gather is a concatenation in shard order, a sum adds
the shards' partials left to right in flat mesh order (``*dp_axes`` then
``tp``), on the first shard's device. On a 1x1 mesh every gather and split
is the identity and nothing is copied. The grouped products are
``torch.bmm`` in the activations' dtype (bfloat16 in, float32
accumulation, bfloat16 out), as the reference leaves them to
``jnp.einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import activation_fn, matmul_f32

MODES = ("train", "seq", "replicated")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def capacity_for(tokens_per_shard: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots an expert: ``round8(max(int(T k / E cf), 8))``, as the
    reference computes it from the ``tokens_per_shard`` its caller passes."""
    return _round_up(max(int(tokens_per_shard * top_k / n_experts * capacity_factor), 8), 8)


def router_topk(logits: torch.Tensor, k: int):
    """Softmax -> top-k -> renormalise. logits [T, E] -> (probs [T, E],
    weights [T, k] float32, ids [T, k] int32).

    ``lax.top_k`` puts the lower expert first on a tie; a stable descending
    sort does the same (``torch.topk`` promises no order for ties)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :k], ids[..., :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return probs, w, ids.to(torch.int32)


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (over the local token set)."""
    one_hot = torch.nn.functional.one_hot(ids.long(), n_experts).to(torch.float32)
    f = one_hot.sum(1).mean(0) / ids.shape[-1]
    p = probs.mean(0)
    return n_experts * torch.sum(f * p)


def _positions_in_expert(flat_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each assignment within its expert group: a stable argsort,
    each sorted entry's offset from its group's start (``searchsorted``),
    scattered back through the sort's permutation."""
    order = torch.sort(flat_ids, stable=True).indices
    sorted_ids = flat_ids[order]
    group_start = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank_sorted = torch.arange(flat_ids.shape[0], device=flat_ids.device) - group_start
    pos = torch.empty_like(flat_ids)
    pos[order] = rank_sorted.to(flat_ids.dtype)
    return pos


def _dispatch(x, flat_ids, pos, e0: int, e_loc: int, capacity: int, top_k: int):
    """Gather-only dispatch: x [T, D] -> h [E_loc, C, D], each assignment's
    slot and whether it was kept.

    A kept assignment (an expert of this shard, ``pos < C``) owns slot
    ``(expert - e0) * C + pos``: distinct for distinct assignments, since
    ``pos`` ranks an expert's assignments. Every other assignment goes to
    the dump slot ``E_loc * C``. So the slot -> token scatter writes each
    real slot once, and duplicates only at the dump slot, whose value is
    thrown away: whichever write wins there (CUDA gives no order among
    duplicate indices) the result is the same. An empty slot keeps the
    fill ``T``, the zero row appended to ``x``.
    """
    t, d = x.shape
    local = (flat_ids >= e0) & (flat_ids < e0 + e_loc)
    keep = local & (pos < capacity)
    slot = torch.where(keep, (flat_ids - e0) * capacity + pos,
                       torch.full_like(flat_ids, e_loc * capacity)).long()
    token_of = torch.arange(t, device=x.device).repeat_interleave(top_k)
    src = torch.full((e_loc * capacity + 1,), t, dtype=torch.long, device=x.device)
    src[slot] = token_of
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    h = x_pad.index_select(0, src[:-1]).reshape(e_loc, capacity, d)
    return h, slot, keep


def moe_ffn_local(
    x: torch.Tensor,  # [T_loc, D]: this shard's tokens
    router_w: torch.Tensor,  # [D, E]
    w_gate: torch.Tensor,  # [E_loc, D, F or F_loc]
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # [E_loc, F or F_loc, D]
    *,
    n_experts: int,
    top_k: int,
    capacity: int,
    e0: int = 0,
    activation: str = "silu",
):
    """One shard's MoE body: (partial y [T, D] in ``x``'s dtype, aux loss).

    ``e0`` is the shard's first expert (the reference reads it from
    ``axis_index(tp)``); the sum of partial outputs across shards is the
    caller's (:func:`make_moe_layer`)."""
    t, d = x.shape
    e_loc = w_gate.shape[0]
    act = activation_fn(activation)

    # bf16 inputs, float32 accumulation and result (the reference's
    # preferred_element_type=f32)
    logits = matmul_f32(x, router_w.to(x.dtype))
    probs, weights, ids = router_topk(logits, top_k)
    aux = load_balance_loss(probs, ids, n_experts)

    flat_ids = ids.reshape(-1)
    flat_w = weights.reshape(-1)
    pos = _positions_in_expert(flat_ids)
    h, slot, keep = _dispatch(x, flat_ids, pos, e0, e_loc, capacity, top_k)

    # grouped products in x's dtype
    g = torch.bmm(h, w_gate)
    u = torch.bmm(h, w_up)
    y = torch.bmm((act(g) * u).to(x.dtype), w_down).to(x.dtype)

    # combine: per-k gather and weight, in x's dtype and the reference's order
    y_flat = torch.cat([y.reshape(e_loc * capacity, d), y.new_zeros((1, d))])
    slot_k = slot.reshape(t, top_k)
    w_k = (flat_w * keep).to(y.dtype).reshape(t, top_k)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + y_flat[slot_k[:, j]] * w_k[:, j : j + 1]
    return out, aux


def _gather(parts: list, dim: int) -> torch.Tensor:
    """An all-gather: the shards' parts joined in shard order on the first
    one's device; one part is returned as it is (no copy)."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _sum(parts: list) -> torch.Tensor:
    """A psum: the shards' partials added left to right on the first one's
    device."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def make_moe_layer(
    mesh,
    dp_axes: tuple[str, ...],
    tp_axis: str,
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    tokens_per_shard: int,
    activation: str = "silu",
    fsdp_experts: bool = False,
    mode: str = "train",
):
    """Build the MoE FFN over ``mesh``: ``layer(x [B, S, D], router [D, E],
    gate [E, D, F], up [E, D, F], down [E, F, D]) -> (y [B, S, D], aux)``,
    every argument whole (the port places each shard's part itself).

    Modes, as the reference's:
      * ``seq``        — x sequence-sharded over tp inside each dp shard:
        the shard gathers the sequence, computes, and the tp partials are
        summed and scattered back along the sequence (``psum_scatter``);
      * ``train``      — x dp-sharded (batch), tp-replicated; the output is
        the sum over tp;
      * ``replicated`` — x on every shard; under ``fsdp_experts`` each
        shard holds a ``d_ff`` slice too, and the output is the sum over
        (dp, tp).
    ``aux`` is averaged over dp in ``train``/``seq``. The shards' bodies run
    one after another (the first shard's device holds the result).
    """
    if mode not in MODES:
        raise ValueError(f"unknown MoE mode {mode!r}; one of {MODES}")
    capacity = capacity_for(tokens_per_shard, top_k, n_experts, capacity_factor)
    dp_sizes = [mesh.shape[a] for a in dp_axes]
    n_dp, n_tp = math.prod(dp_sizes), mesh.shape[tp_axis]

    def device(di: int, ti: int) -> torch.device:
        coords = dict.fromkeys(mesh.axis_names, 0)
        for a, n in zip(reversed(dp_axes), reversed(dp_sizes)):
            di, coords[a] = divmod(di, n)
        coords[tp_axis] = ti
        return mesh.devices[tuple(coords[a] for a in mesh.axis_names)]

    def layer(x, router_w, w_gate, w_up, w_down):
        b, s, d = x.shape
        e, _, f = w_gate.shape
        if e % n_tp:
            raise ValueError(f"{e} experts do not split over {n_tp} tp shards")
        if fsdp_experts and f % n_dp:
            raise ValueError(f"d_ff {f} does not split over {n_dp} dp shards")
        if mode != "replicated" and b % n_dp:
            raise ValueError(f"batch {b} does not split over {n_dp} dp shards")
        if mode == "seq" and s % n_tp:
            raise ValueError(f"sequence {s} does not split over {n_tp} tp shards")
        e_loc = e // n_tp
        f_loc = f // n_dp if fsdp_experts else f
        b_loc = b if mode == "replicated" else b // n_dp
        s_loc = s // n_tp if mode == "seq" else s

        def x_local(di, ti):  # the in_spec's block of x
            rows = slice(0, b) if mode == "replicated" else slice(di * b_loc, (di + 1) * b_loc)
            cols = slice(ti * s_loc, (ti + 1) * s_loc) if mode == "seq" else slice(0, s)
            return x[rows, cols].to(device(di, ti))

        def weights(di, ti):  # the in_specs' blocks of the expert weights
            dev, ex = device(di, ti), slice(ti * e_loc, (ti + 1) * e_loc)
            if not fsdp_experts:
                return w_gate[ex].to(dev), w_up[ex].to(dev), w_down[ex].to(dev)
            fs = [slice(dj * f_loc, (dj + 1) * f_loc) for dj in range(n_dp)]
            if mode == "replicated":  # TP over d_ff: this dp shard's slice only
                return (w_gate[ex, :, fs[di]].to(dev), w_up[ex, :, fs[di]].to(dev),
                        w_down[ex, fs[di]].to(dev))
            # ZeRO-3: gather the d_ff-sharded weights just in time
            return (_gather([w_gate[ex, :, sl].to(dev) for sl in fs], 2),
                    _gather([w_up[ex, :, sl].to(dev) for sl in fs], 2),
                    _gather([w_down[ex, sl].to(dev) for sl in fs], 1))

        partial, aux = {}, {}
        for di in range(n_dp):
            for ti in range(n_tp):
                dev = device(di, ti)
                if mode == "seq":  # all-gather the sequence over tp
                    xl = _gather([x_local(di, tj).to(dev) for tj in range(n_tp)], 1)
                else:
                    xl = x_local(di, ti)
                bl, sl, _ = xl.shape
                y, a = moe_ffn_local(
                    xl.reshape(bl * sl, d), router_w.to(xl.device), *weights(di, ti),
                    n_experts=n_experts, top_k=top_k, capacity=capacity, e0=ti * e_loc,
                    activation=activation)
                partial[di, ti], aux[di, ti] = y.reshape(bl, sl, d), a

        if mode == "replicated":
            dps = range(n_dp) if fsdp_experts else range(1)
            y = _sum([partial[di, ti] for di in dps for ti in range(n_tp)])
            return y, aux[0, 0]
        if mode == "train":
            y = _gather([_sum([partial[di, ti] for ti in range(n_tp)]) for di in range(n_dp)], 0)
        else:  # seq: reduce-scatter the tp partials back along the sequence
            blocks = []
            for di in range(n_dp):
                full = _sum([partial[di, ti] for ti in range(n_tp)])
                blocks.append(_gather([full[:, ti * s_loc:(ti + 1) * s_loc]
                                       for ti in range(n_tp)], 1))
            y = _gather(blocks, 0)
        home = partial[0, 0].device
        aux_mean = _sum([aux[di, 0].to(home) for di in range(n_dp)]) / n_dp
        return y, aux_mean

    return layer
