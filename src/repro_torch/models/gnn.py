"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718] (the port's
copy of `repro.models.gnn`).

Message passing is a segment reduce over an edge list
(`repro_torch.models.segment`: edges grouped by destination once per
graph, then ``torch.segment_reduce``, with no atomics, so a card gives the
same bits every run). Multi-aggregator (mean/max/min/std) × degree scalers
(identity/amplification/attenuation).

Edge-sharded distribution is the MIREX dataflow verbatim: each shard owns
an edge slab, computes *partial* segment aggregates for all nodes
(map+combine: sums, counts, maxima are all mergeable monoids), and shards
merge them (reduce). The reference runs the shards under ``shard_map``;
torch has none, so :func:`make_sharded_full_graph` runs each shard's body
on its mesh device in shard order and merges explicitly, as
`repro_torch.models.moe.make_moe_layer` does: a ``psum`` adds the shards'
partials left to right, an ``all_gather`` joins the shards' rows in shard
order, and ``pmax`` is :func:`pmax_diff`.

Three input regimes (one per assigned shape):
  * full-graph: edge list sharded over the whole mesh;
  * sampled minibatch: fixed-fanout computation trees (GraphSAGE-style) from
    ``data/sampler.py``, batch-sharded;
  * batched molecules: the graphs joined into one graph with node offsets.

Two choices of layout keep the largest graph (ogbn-products, 61.9M edges,
one ``[E, 75]`` float32 tensor 18.6 GB) in memory; neither changes the
math row by row:
  * the message's products are taken at node level and gathered along the
    edges, ``(h @ w_src)[src]`` for ``h[src] @ w_src``: ``N`` rows of
    products instead of ``E``;
  * a layer aggregates the destinations in blocks of at most
    ``EDGE_BLOCK`` edges (:meth:`Segments.blocks`). No destination's
    edges are split across blocks, so each destination's reduce is the one
    it would be in a single pass; only a block's messages are alive at a
    time.
Gathers whose gradient is a scatter (``h[src]``, ``h[dst]``, ``mean[dst]``)
go through `segment.gather`, whose backward is a segment sum: the same
bits every run on the CPU and on a card (torch's own gathers are each
nondeterministic on one of the two).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.distributed.sharding import all_gather_parts, psum_parts, replicated_specs
from repro_torch.models import segment as seg_lib
from repro_torch.models.common import init_dense
from repro_torch.models.embedding import jax_index
from repro_torch.models.transformer import ParamSpec
from repro_torch.obs import counting

EPS = 1e-5
# destinations are aggregated in blocks of at most this many edges: a
# block's [EDGE_BLOCK, d] float32 messages take 2.5 GB at d 75, and a block
# holds three such tensors at most (messages, deviations, their squares)
EDGE_BLOCK = 1 << 23


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def n_agg_feats(cfg: GNNConfig) -> int:
    return len(cfg.aggregators) * len(cfg.scalers)


def param_shapes(cfg: GNNConfig, d_feat: int) -> dict:
    d = cfg.d_hidden
    dt = getattr(torch, cfg.dtype)

    def s(*shape):
        return ParamSpec(shape, dt)

    l = cfg.n_layers
    return {
        "w_in": s(d_feat, d),
        "b_in": s(d),
        "layers": {
            "w_src": s(l, d, d),
            "w_dst": s(l, d, d),
            "b_msg": s(l, d),
            "w_upd": s(l, (1 + n_agg_feats(cfg)) * d, d),
            "b_upd": s(l, d),
        },
        "w_out": s(d, cfg.n_classes),
        "b_out": s(cfg.n_classes),
    }


def init_params(cfg: GNNConfig, d_feat: int, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Seeded init, as the reference's: every leaf of two or more dims
    (the stacked layer biases too) normal with std ``shape[0] ** -0.5``,
    the rest 0. Drawn on ``device`` from ``generator`` (which lives there;
    seed 0 when None), leaf by leaf in the reference's tree order."""
    device = torch.device("cpu" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if len(tree.shape) >= 2:
            return init_dense(generator, tree.shape, tree.dtype, device=device)
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)

    return build(param_shapes(cfg, d_feat))


def param_specs(cfg: GNNConfig, rules) -> dict:
    """PNA is tiny (d 75): every parameter replicated, the parallelism is
    over edges (the reference's specs, ``d_feat`` 1 as it builds them)."""
    del rules
    return replicated_specs(param_shapes(cfg, 1))


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params["layers"]``."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# aggregation core (partial → merge), shared by every regime
# ---------------------------------------------------------------------------

def partial_aggregates(m: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                       seg: seg_lib.Segments | None = None) -> dict:
    """Mergeable combiner state from one edge slab: Σm, max, min, count.

    ``seg`` is ``segments(dst, n_nodes)``, built once per graph (built here
    when None). The second moment is *not* accumulated here: variance must
    use the two-pass form Σ(m−μ)² (sqdev below) — E[x²]−E[x]² amplifies
    f32 reduction-order noise through the sqrt at near-zero variance (the
    reference records a 0.16 output drift between fusion schedules)."""
    seg = seg_lib.segments(dst, n_nodes) if seg is None else seg
    ms = seg.take(m)
    return {
        "sum": seg.reduce(ms, "sum"),
        "max": seg.reduce(ms, "max"),
        "min": seg.reduce(ms, "min"),
        "cnt": seg.count(m.dtype),
    }


def sqdev_aggregate(m: torch.Tensor, dst: torch.Tensor, mean: torch.Tensor, n_nodes: int,
                    seg: seg_lib.Segments | None = None) -> torch.Tensor:
    """Second pass: Σ(m − μ_dst)² per destination (stable variance)."""
    seg = seg_lib.segments(dst, n_nodes) if seg is None else seg
    mu = seg_lib.gather(mean, dst.long().clamp(0, mean.shape[0] - 1))
    return seg.sum(torch.square(m - mu))


class _PMax(torch.autograd.Function):
    """The shards' partials -> every shard's copy of their elementwise max.
    The backward is the reference's ``_pmax_bwd`` on each shard: shard
    ``s``'s cotangent ``g_s`` goes to its partial where it attains the max,
    divided by the number of shards that attain it."""

    @staticmethod
    def forward(ctx, *xs):
        dev = xs[0].device
        m = xs[0]
        for x in xs[1:]:
            m = torch.maximum(m, x.to(dev))
        ctx.save_for_backward(m, *xs)
        return tuple(m.to(x.device, copy=True) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        m, *xs = ctx.saved_tensors
        masks = [(x.to(m.device) == m).to(m.dtype) for x in xs]
        cnt = masks[0]
        for mask in masks[1:]:
            cnt = cnt + mask
        cnt = torch.clamp(cnt, min=1.0)
        return tuple(g * (mask / cnt).to(g.device) for g, mask in zip(gs, masks))


def pmax_diff(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Differentiable cross-shard max over the shards' partials ``xs`` (in
    shard order): each shard's copy of the max; grads split equally among
    the shards that attain it (pmax itself has no AD rule). An op counter in
    force sees an all-reduce (and in the backward the count's psum)."""
    out = list(_PMax.apply(*xs))
    if counting.active() is not None and len(xs) > 1:
        counting.collective("all-reduce", counting.tensor_bytes(xs[0]), len(xs))
        if out[0].requires_grad:
            out[0].register_hook(lambda g: counting.collective(
                "all-reduce", counting.tensor_bytes(xs[0]), len(xs)))
    return out


def pmin_diff(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    return [-x for x in pmax_diff([-x for x in xs])]


def merge_aggregates(aggs: list[dict]) -> list[dict]:
    """The shards' combiner states (in shard order) -> each shard's merged
    state: sums and counts added (``psum``), maxima and minima through
    :func:`pmax_diff` / :func:`pmin_diff`."""
    total = {k: psum_parts([a[k] for a in aggs]) for k in ("sum", "cnt")}
    mx = pmax_diff([a["max"] for a in aggs])
    mn = pmin_diff([a["min"] for a in aggs])
    return [{"sum": total["sum"].to(a["sum"].device), "max": x, "min": y,
             "cnt": total["cnt"].to(a["cnt"].device)}
            for a, x, y in zip(aggs, mx, mn)]


def finish_aggregates(agg: dict, cfg: GNNConfig) -> torch.Tensor:
    """Combiner state (+ two-pass sqdev) -> scaled features [N, A*S*d]."""
    cnt = torch.clamp(agg["cnt"], min=1.0)[:, None]
    has = (agg["cnt"] > 0)[:, None]
    mean = agg["sum"] / cnt
    std = torch.sqrt(agg["sqdev"] / cnt + EPS)
    zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
    by_name = {
        "mean": mean,
        "max": torch.where(has, agg["max"], zero),
        "min": torch.where(has, agg["min"], zero),
        "std": std,
    }
    deg = torch.log1p(agg["cnt"])[:, None]
    scaler = {
        "identity": torch.ones_like(deg),
        "amplification": deg / cfg.delta,
        "attenuation": cfg.delta / torch.clamp(deg, min=EPS),
    }
    feats = [by_name[a] * scaler[s] for a in cfg.aggregators for s in cfg.scalers]
    return torch.cat(feats, dim=-1)


def _message(h_src, h_dst, lp):
    return F.relu(h_src @ lp["w_src"] + h_dst @ lp["w_dst"] + lp["b_msg"])


def _src_rows(src: torch.Tensor, n: int):
    """JAX's ``h[src]`` over ``n`` rows: the rows ``jax_index`` reads, and a
    mask of the ids inside ``[-n, n)`` when some are not (None otherwise;
    one host read, none on ``meta``, which keeps the mask). JAX clamps such
    an id in the forward, but the gather's transpose drops it: its edge
    passes no gradient to ``h`` (its message still passes one to
    ``w_src``)."""
    src = src.long()
    ok = (src >= -n) & (src < n)
    if src.is_meta:
        return jax_index(src, n), ok
    return jax_index(src, n), (None if bool(ok.all()) else ok)


def _src_products(h, lp, src_ok):
    """``h @ w_src``, and the same from ``h`` detached when some edges'
    sources lie outside their range (``src_ok``, see :func:`_src_rows`):
    those edges pass no gradient to ``h``."""
    return h @ lp["w_src"], (None if src_ok is None else h.detach() @ lp["w_src"])


def _edge_messages(p_src, p_dst, src_rows, dst_rows, b_msg, src_ok=None, dst_seg=None):
    """``_message`` along edges from node-level products ``p_src = (h @
    w_src, its detached twin)`` (:func:`_src_products`) and ``p_dst = h_dst
    @ w_dst``: ``relu(p_src[src] + p_dst[dst] + b_msg)``, summed in the
    reference's order. ``dst_seg`` groups ``dst_rows`` when the caller has
    it."""
    m = seg_lib.gather(p_src[0], src_rows)
    if src_ok is not None:
        m = torch.where(src_ok[:, None], m, p_src[1][src_rows])
    m += seg_lib.gather(p_dst, dst_rows, dst_seg)
    m += b_msg
    return F.relu_(m)


def _update(h_loc, agg, lp, cfg):
    feats = torch.cat([h_loc, finish_aggregates(agg, cfg)], dim=-1)
    return F.relu(feats @ lp["w_upd"] + lp["b_upd"]) + h_loc  # residual


def _local_layer(h, src_rows, src_ok, seg, row0, lp, cfg):
    """One layer for destination rows ``row0 .. row0 + seg.n`` of ``h``,
    whose in-edges (all of them) ``seg`` groups; ``src_rows`` are the
    edges' source rows of ``h`` (``src_ok`` as :func:`_src_rows` gives
    it). Aggregates block by block."""
    p_src = _src_products(h, lp, src_ok)
    h_own = h[row0:row0 + seg.n]
    p_dst = h_own @ lp["w_dst"]
    outs = []
    for n0, n1, blk in seg.blocks(EDGE_BLOCK):
        dst, by_dst = blk.ids(), blk.grouped()
        ok = None if src_ok is None else blk.take(src_ok)
        m = _edge_messages(p_src, p_dst[n0:n1], blk.take(src_rows), dst, lp["b_msg"], ok,
                           by_dst)
        agg = {"sum": blk.reduce(m, "sum"), "max": blk.reduce(m, "max"),
               "min": blk.reduce(m, "min"), "cnt": blk.count(m.dtype)}
        mean = agg["sum"] / torch.clamp(agg["cnt"], min=1.0)[:, None]
        agg["sqdev"] = blk.reduce(torch.square(m - seg_lib.gather(mean, dst, by_dst)), "sum")
        del m
        outs.append(_update(h_own[n0:n1], agg, lp, cfg))
    return torch.cat(outs) if len(outs) != 1 else outs[0]


def pna_layer_local(h, src, dst, lp, cfg, n_nodes):
    """One PNA layer over a whole edge list; ``h`` [n_nodes, d].

    The reference's ``merge_axes`` (a ``psum`` inside a ``shard_map``) is
    the ``scatter`` mode of :func:`make_sharded_full_graph` here, which
    runs the shards and their merges itself."""
    return _local_layer(h, *_src_rows(src, h.shape[0]), seg_lib.segments(dst, n_nodes), 0, lp,
                        cfg)


# ---------------------------------------------------------------------------
# full-graph forward (optionally edge-sharded over the whole mesh)
# ---------------------------------------------------------------------------

def forward_full_graph(params, x, src, dst, cfg: GNNConfig):
    """x [N, d_feat]; src/dst [E]. Returns logits [N, n_classes]. The edges
    are grouped by destination once, for every layer."""
    n = x.shape[0]
    return _forward_local(params, x, *_src_rows(src, n), seg_lib.segments(dst, n), cfg)


def _forward_local(params, x, src_rows, src_ok, seg, cfg):
    h = F.relu(x @ params["w_in"] + params["b_in"])
    for i in range(cfg.n_layers):
        h = _local_layer(h, src_rows, src_ok, seg, 0, layer_params(params, i), cfg)
    return h @ params["w_out"] + params["b_out"]


def pna_layer_sharded(hs, slabs, segs, lp, cfg, n_nodes):
    """Edge-sharded layer with node-sharded finish (reduce-scatter merge),
    over every shard: ``hs`` each shard's (replicated) ``h``, ``slabs``
    its ``(src, dst)`` edges, ``segs`` their segments over ``n_nodes``.

    Additive combiner states merge onto node shards (the reference's
    ``psum_scatter``: the sum, then each shard's rows); max/min merge with
    the differentiable pmax and are sliced. The concat+update runs on each
    shard's node rows — the full ``[N, (1+A·S)·d]`` feature tensor never
    exists. Returns each shard's copy of the new ``h`` (the all_gather).
    """
    n_shards = len(hs)
    n_loc = n_nodes // n_shards
    ms, aggs = [], []
    for h, (src, dst), seg in zip(hs, slabs, segs):
        lp_h = _on(lp, h.device)
        src_rows, src_ok = _src_rows(src, n_nodes)
        m = _edge_messages(_src_products(h, lp_h, src_ok), h @ lp_h["w_dst"], src_rows,
                           jax_index(dst.long(), n_nodes), lp_h["b_msg"], src_ok)
        ms.append(m)
        aggs.append(partial_aggregates(m, dst, n_nodes, seg))
    merged = merge_aggregates(aggs)
    locs = [{k: v[s * n_loc:(s + 1) * n_loc] for k, v in a.items()}
            for s, a in enumerate(merged)]
    # stable variance: second pass against the merged mean (gathered so every
    # shard can deviate its own edges' messages)
    mean = all_gather_parts([a["sum"] / torch.clamp(a["cnt"], min=1.0)[:, None] for a in locs])
    sqdev = psum_parts([sqdev_aggregate(m, dst, mean.to(m.device), n_nodes, seg)
                   for m, (_, dst), seg in zip(ms, slabs, segs)])
    outs = []
    for s, (h, a) in enumerate(zip(hs, locs)):
        a["sqdev"] = sqdev[s * n_loc:(s + 1) * n_loc].to(h.device)
        outs.append(_update(h[s * n_loc:(s + 1) * n_loc], a, _on(lp, h.device), cfg))
    new = all_gather_parts(outs)
    return [new.to(h.device) for h in hs]


def pna_layer_bucketed(h, src, dst, lp, cfg, n_loc, idx, seg: seg_lib.Segments | None = None):
    """Layer over **dst-bucketed** edges: this shard's slab contains exactly
    the edges whose destination lies in its node range (data/graph_prep.py
    pads buckets to uniform size with ghost edges dst=n_nodes). Aggregates
    are [N_loc, d] from the start — no full-[N] partials, no psum; the only
    communication is the all_gather that re-replicates h for random-access
    edge gathers. 1D graph partitioning. ``seg`` is ``segments(dst - idx *
    n_loc, n_loc)`` (ghosts fall outside and drop)."""
    if seg is None:
        seg = seg_lib.segments(dst.long() - idx * n_loc, n_loc)
    return _local_layer(h, src.long().clamp(0, h.shape[0] - 1), None, seg, idx * n_loc, lp, cfg)


def make_sharded_full_graph(mesh, rules, cfg: GNNConfig, *, mode: str = "bucketed"):
    """Full-graph forward, edges over every mesh axis: ``fn(params, x, src,
    dst) -> logits [N, n_classes]`` on the first shard's device, ``src`` /
    ``dst`` cut into equal contiguous slabs in flat shard order (the
    reference's ``P(axes)``). The axes are ``rules.all_axes`` without
    repeats (a one-axis mesh counts its shards once).

    ``mode="bucketed"`` (default): dst-bucketed edges
    (``graph_prep.bucket_edges``), local aggregation, one all_gather per
    layer. ``mode="scatter"``: arbitrary edge sharding, full-[N] partial
    aggregates merged by a reduce-scatter and pmax. Requires n_nodes
    divisible by the mesh size. Each layer is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
    nothing saveable). Each shard's edges are grouped by destination once a
    call, for every layer."""
    if mode not in ("bucketed", "scatter"):
        raise ValueError(f"unknown mode {mode!r}; expected 'bucketed' or 'scatter'")
    axes = tuple(dict.fromkeys(rules.all_axes))
    n_shards = 1
    for a in axes:
        n_shards *= mesh.shape[a]
    devices = [mesh.shard(s, axes)[0] for s in range(n_shards)]

    def fn(params, x, src, dst):
        n = x.shape[0]
        if n % n_shards or src.shape[0] % n_shards:
            raise ValueError(f"{n} nodes and {src.shape[0]} edges over {n_shards} shards")
        n_loc, e_loc = n // n_shards, src.shape[0] // n_shards
        slabs = [(src[s * e_loc:(s + 1) * e_loc].to(d), dst[s * e_loc:(s + 1) * e_loc].to(d))
                 for s, d in enumerate(devices)]
        names = sorted(params["layers"])
        flat = [params["layers"][k] for k in names]
        h0 = F.relu(x @ params["w_in"] + params["b_in"])
        hs = [h0.to(d) for d in devices]

        if mode == "bucketed":
            segs = [seg_lib.segments(d_.long() - s * n_loc, n_loc)
                    for s, (_, d_) in enumerate(slabs)]

            def one(*args):
                hs, lp = list(args[:n_shards]), dict(zip(names, args[n_shards:]))
                outs = [pna_layer_bucketed(h, s_, d_, _on(lp, h.device), cfg, n_loc, i, seg)
                        for i, (h, (s_, d_), seg) in enumerate(zip(hs, slabs, segs))]
                new = all_gather_parts(outs)
                return tuple(new.to(d) for d in devices)
        else:
            segs = [seg_lib.segments(d_, n) for _, d_ in slabs]

            def one(*args):
                hs, lp = list(args[:n_shards]), dict(zip(names, args[n_shards:]))
                return tuple(pna_layer_sharded(hs, slabs, segs, lp, cfg, n))

        for i in range(cfg.n_layers):
            lp = [p[i] for p in flat]
            hs = list(checkpoint(one, *hs, *lp, use_reentrant=False))
        return hs[0] @ params["w_out"].to(hs[0].device) + params["b_out"].to(hs[0].device)

    return fn


def _on(lp: dict, device) -> dict:
    return {k: v.to(device) for k, v in lp.items()}


# ---------------------------------------------------------------------------
# sampled-minibatch forward (fixed-fanout computation tree)
# ---------------------------------------------------------------------------

def forward_sampled(params, seed_x, hop1_x, hop2_x, cfg: GNNConfig):
    """GraphSAGE-style 2-hop tree: hop2 -> hop1 -> seed.

    seed_x [B, F], hop1_x [B, K1, F], hop2_x [B, K1, K2, F]. PNA aggregation
    over the fixed fanout (degree == fanout, so scalers are constants). The
    std is the population std (``jnp.std``'s ddof 0), taken as ``jnp.std``
    takes it: ``sqrt(mean((m - mean)²))``, ``EPS`` added outside, each mean
    a sum times ``1 / fanout`` as XLA computes it. Its gradient at zero
    variance (a fanout group whose sampled neighbours all repeat) is NaN
    there and here (``torch.std``'s backward would give 0); the rounding of
    the mean is the reference's, so a channel whose mean rounds away from
    its repeated value has a tiny variance and a finite gradient in both.
    """
    _, k1, k2, _ = hop2_x.shape

    def enc(x):
        return F.relu(x @ params["w_in"] + params["b_in"])

    h_seed, h1, h2 = enc(seed_x), enc(hop1_x), enc(hop2_x)

    def tree_layer(h_dst, h_src, lp, fanout):
        # h_dst [..., d]; h_src [..., fanout, d]
        m = _message(h_src, h_dst[..., None, :].expand(h_src.shape), lp)
        inv = 1.0 / fanout  # XLA divides by a constant as a product by its reciprocal
        mean = m.sum(-2) * inv
        std = torch.sqrt(torch.square(m - mean[..., None, :]).sum(-2) * inv) + EPS
        mx = torch.amax(m, -2)
        mn = torch.amin(m, -2)
        by_name = {"mean": mean, "max": mx, "min": mn, "std": std}
        deg = torch.log1p(torch.tensor(float(fanout), dtype=m.dtype, device=m.device))
        scaler = {
            "identity": 1.0,
            "amplification": deg / cfg.delta,
            "attenuation": cfg.delta / deg,
        }
        feats = torch.cat(
            [h_dst] + [by_name[a] * scaler[s] for a in cfg.aggregators for s in cfg.scalers],
            dim=-1,
        )
        return F.relu(feats @ lp["w_upd"] + lp["b_upd"]) + h_dst

    lp0 = layer_params(params, 0)
    lp1 = layer_params(params, min(1, cfg.n_layers - 1))
    h1 = tree_layer(h1, h2, lp0, k2)  # [B, K1, d]
    h_seed = tree_layer(h_seed, h1, lp1, k1)  # [B, d]
    return h_seed @ params["w_out"] + params["b_out"]


# ---------------------------------------------------------------------------
# batched small graphs (molecules)
# ---------------------------------------------------------------------------

def forward_batched_graphs(params, x, src, dst, cfg: GNNConfig):
    """x [B, N, F], src/dst [B, E] -> per-graph logits [B, n_classes].

    The reference vmaps :func:`forward_full_graph` over the graphs; here
    the B graphs are one graph of ``B * N`` nodes (graph ``b``'s ids
    offset by ``b * N``: a source is first clamped into its own graph as
    JAX's indexing does, a destination outside its graph is dropped), then
    each graph's node logits are mean-pooled (readout)."""
    b, n, _ = x.shape
    base = (torch.arange(b, device=x.device) * n)[:, None]
    src_rows, src_ok = _src_rows(src, n)
    dst = dst.long()
    dst_rows = torch.where((dst >= 0) & (dst < n), dst + base, -1)
    logits = _forward_local(params, x.reshape(b * n, -1), (src_rows + base).reshape(-1),
                            None if src_ok is None else src_ok.reshape(-1),
                            seg_lib.segments(dst_rows.reshape(-1), b * n), cfg)
    return logits.reshape(b, n, -1).mean(1)  # mean-pool readout


def xent_loss(logits, labels):
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[..., None]))
