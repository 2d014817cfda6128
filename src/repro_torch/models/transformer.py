"""Decoder-only transformer, dense and MoE: LM serving (prefill, then decode
over a KV cache) and training (the chunked cross-entropy loss) — the
port's copy of `repro.models.transformer`.

One definition serves the LMs of `repro_torch.configs` (``gemma2-2b``,
``gemma2-27b``, ``h2o-danube-1.8b`` and the MoE ``qwen3-moe-30b-a3b`` and
``dbrx-132b``): GQA, RoPE, sliding windows on every layer or on gemma2's
even layers only, attention and final logit soft caps, SwiGLU or GeGLU
FFNs, gemma's ``(1 + w)`` RMSNorm and embedding scale. Parameters keep the
reference's pytree: a dict with ``embed [V,D]``, ``final_norm [D]``,
``unembed [D,V]`` and ``layers``, each leaf stacked ``[L, ...]``; caches are
``{"k", "v"}`` of ``[L,B,S,KV,hd]``.

What differs from the reference, and why:

* the layers are a Python loop over the stacked weights (PyTorch runs
  eagerly; there is no scan to compile), each leaf unbound once a call so
  its gradient is stacked once; the dense layers run on one device
  (sharding constraints are the identity), and the mesh's shards run one
  after another on their devices where the reference runs a ``shard_map``:
  the MoE layer, the loss (each ``dp`` shard's rows against each ``tp``
  shard's block of the unembedding) and the decode attention over a
  sequence-sharded cache; remat follows the config (``remat``,
  ``remat_policy``, ``remat_chunk``) through ``torch.utils.checkpoint``,
  per layer, and per chunk of layers around that when ``remat_chunk > 1``;
* attention runs through the kernels: prefill and training call
  `ops.flash_attention_train` (the flash kernel's forward, with the
  gradient of the reference's ``chunked_attention`` recomputed block by
  block in its backward) with native GQA (no ``repeat``), the window
  passed only on a windowed layer, which is the reference's
  ``in_window | ~window_active``; a decode whose cache lies on one shard
  writes the new token's K/V into the cache first, in place, then calls
  `ops.flash_decode` over the positions ``<= t``; the reference keeps the
  cache read-only in its scan and folds the new token in as a separate
  merge term — the same function up to summation order, without a copy of
  the cache per step; a cache whose sequence spans shards runs the
  reference's order (`attention.decode_attend_seqsharded`: each shard's
  partial over positions ``<= t - 1``, the log-sum-exp merge, the new
  token folded in), then writes slot ``t`` in place after each layer's
  attention;
* gathers whose gradient is a scatter (the embedding, the MoE dispatch and
  combine) are ``F.embedding``, whose backward on the card sorts instead of
  adding atomically: a training step gives the same bits every run;
* ``init_params`` draws from a ``torch.Generator``, so its numbers are not
  the reference's (`repro_torch.convert.params_from_numpy` carries the
  reference's own parameters across for the parity tests).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed.sharding import (
    AxisRules, Mesh, device_runs, pmax_parts, psum_parts,
)
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    activation_fn, apply_rope, init_dense, matmul_f32, rms_norm, rope_angles, softcap,
)
from repro_torch.obs import counting
from repro_torch.tune import config as tune_config

FSDP_EXPERT_BYTES = 2**33  # >8 GiB of expert weights -> ZeRO-3 them over dp
_MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def uses_fsdp_experts(cfg: TransformerConfig) -> bool:
    if not cfg.is_moe:
        return False
    expert_bytes = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff * 2
    return expert_bytes > FSDP_EXPERT_BYTES


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """Everything the forward pass needs besides params and inputs. A dense
    config runs with ``mesh``/``rules``/``moe_layer`` left ``None``."""

    cfg: TransformerConfig
    mesh: Mesh | None = None
    rules: AxisRules | None = None
    moe_layer: Any = None


def make_context(
    cfg: TransformerConfig,
    mesh: Mesh,
    rules: AxisRules,
    *,
    tokens_per_shard: int | None = None,
    moe_mode: str = "train",
) -> ModelContext:
    """The reference's context: a MoE config with ``tokens_per_shard`` gets
    its MoE layer over ``mesh`` (experts over ``rules.tp``, and over
    ``rules.dp`` on ``d_ff`` when `uses_fsdp_experts`), its capacity from
    ``tokens_per_shard``."""
    moe_layer = None
    if cfg.is_moe and tokens_per_shard is not None:
        moe_layer = moe_lib.make_moe_layer(
            mesh,
            rules.dp,
            rules.tp,
            n_experts=cfg.n_experts,
            top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            tokens_per_shard=tokens_per_shard,
            activation=cfg.activation,
            fsdp_experts=uses_fsdp_experts(cfg),
            mode=moe_mode,
        )
    return ModelContext(cfg=cfg, mesh=mesh, rules=rules, moe_layer=moe_layer)


def _context(ctx: ModelContext | TransformerConfig) -> ModelContext:
    """A context from a context, or from a dense config alone."""
    if isinstance(ctx, TransformerConfig):
        ctx = ModelContext(cfg=ctx)
    if ctx.cfg.is_moe and ctx.moe_layer is None:
        raise ValueError(f"{ctx.cfg.name} has MoE layers: build its context with "
                         "make_context(cfg, mesh, rules, tokens_per_shard=...)")
    return ctx


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


def param_shapes(cfg: TransformerConfig) -> dict:
    """Shape/dtype tree of the parameters (`ParamSpec` leaves)."""
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    l, f, v = cfg.n_layers, cfg.d_ff, cfg.vocab
    dt = _dtype(cfg)

    def s(*shape):
        return ParamSpec(shape, dt)

    layers = {
        "attn_norm": s(l, d),
        "wq": s(l, d, h * hd),
        "wk": s(l, d, kv * hd),
        "wv": s(l, d, kv * hd),
        "wo": s(l, h * hd, d),
        "ffn_norm": s(l, d),
    }
    if cfg.is_moe:
        layers.update(
            router=s(l, d, cfg.n_experts),
            w_gate=s(l, cfg.n_experts, d, f),
            w_up=s(l, cfg.n_experts, d, f),
            w_down=s(l, cfg.n_experts, f, d),
        )
    else:
        layers.update(w_gate=s(l, d, f), w_up=s(l, d, f), w_down=s(l, f, d))
    return {"embed": s(v, d), "layers": layers, "final_norm": s(d), "unembed": s(d, v)}


def heads_divisible(cfg: TransformerConfig, tp_size: int) -> bool:
    return cfg.n_heads % tp_size == 0


def param_specs(cfg: TransformerConfig, rules: AxisRules, tp_size: int) -> dict:
    """The reference's sharding specs of `param_shapes`, each a tuple of a
    leaf's physical axis groups (`AxisRules.spec`): attention over ``tp``
    where the heads divide it, the dense FFN Megatron-style, experts over
    ``tp`` (and ``d_ff`` over ``dp`` under `uses_fsdp_experts`), the
    embedding and unembedding over ``tp``."""
    attn_tp = heads_divisible(cfg, tp_size)
    rep = rules.spec
    layers = {
        "attn_norm": rep(None, None),
        "wq": rep(None, None, "tp") if attn_tp else rep(None, None, None),
        "wk": rep(None, None, None),
        "wv": rep(None, None, None),
        "wo": rep(None, "tp", None) if attn_tp else rep(None, None, None),
        "ffn_norm": rep(None, None),
    }
    if cfg.is_moe:
        fsdp = "dp" if uses_fsdp_experts(cfg) else None
        layers.update(
            router=rep(None, None, None),
            w_gate=rep(None, "tp", None, fsdp),
            w_up=rep(None, "tp", None, fsdp),
            w_down=rep(None, "tp", fsdp, None),
        )
    else:
        layers.update(w_gate=rep(None, None, "tp"), w_up=rep(None, None, "tp"),
                      w_down=rep(None, "tp", None))
    return {"embed": rep(None, "tp"), "layers": layers, "final_norm": rep(None),
            "unembed": rep(None, "tp")}


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Seeded parameter init, as the reference's: matrices normal with std
    0.02, norm scales 1 (0 under gemma's ``(1 + w)`` convention). Drawn on
    ``device`` from ``generator`` (which lives there; seed 0 when None).
    The MoE leaves are drawn one layer at a time, so the float32 draw
    never holds a whole stack (qwen3-moe-30b-a3b's ``w_gate`` is 38.7 GB
    in float32)."""
    device = torch.device("cpu" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def leaf(spec: ParamSpec) -> torch.Tensor:
        if len(spec.shape) >= 2:
            return init_dense(generator, spec.shape, spec.dtype, scale=0.02, device=device)
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)

    def stacked(spec: ParamSpec) -> torch.Tensor:
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        for i in range(spec.shape[0]):
            out[i] = leaf(ParamSpec(spec.shape[1:], spec.dtype))
        return out

    shapes = param_shapes(cfg)
    params = {
        "embed": leaf(shapes["embed"]),
        "layers": {name: (stacked if name in _MOE_LEAVES and cfg.is_moe else leaf)(spec)
                   for name, spec in shapes["layers"].items()},
        "final_norm": leaf(shapes["final_norm"]),
        "unembed": leaf(shapes["unembed"]),
    }
    if cfg.rms_one_plus:  # gemma (1+w) convention: init scales at 0
        for name in ("attn_norm", "ffn_norm"):
            params["layers"][name].zero_()
        params["final_norm"].zero_()
    return params


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


def _layer_windows(cfg: TransformerConfig) -> list[bool]:
    """Per layer: does layer i apply the sliding window?"""
    l = cfg.n_layers
    if cfg.local_global_alternating:
        return [i % 2 == 0 for i in range(l)]  # gemma2: even layers local
    return [cfg.sliding_window is not None] * l


def _window(cfg: TransformerConfig) -> int:
    return cfg.sliding_window if cfg.sliding_window is not None else 4096


def _dense_ffn(x, w_gate, w_up, w_down, cfg: TransformerConfig):
    """SwiGLU / GeGLU (tanh-approximate gelu) with intermediates in ``x``'s
    dtype, as the reference."""
    act = activation_fn(cfg.activation)
    g = x @ w_gate
    u = x @ w_up
    return ((act(g) * u).to(x.dtype) @ w_down).to(x.dtype)


def _ffn(y, lp, ctx: ModelContext):
    """The FFN of a layer: the context's MoE layer (partials summed over its
    mesh) or the dense one. y [B,S,D], or [B,D] in decode (one position a
    sequence, as the reference's ``y2[:, None]``)."""
    if not ctx.cfg.is_moe:
        return _dense_ffn(y, lp["w_gate"], lp["w_up"], lp["w_down"], ctx.cfg)
    one = y.dim() == 2
    f, _ = ctx.moe_layer(y[:, None] if one else y, lp["router"], lp["w_gate"], lp["w_up"],
                         lp["w_down"])
    return f[:, 0] if one else f


def _attn_block(x, lp, cfg: TransformerConfig, *, window_active: bool, q_offset: int = 0,
                kv_out: bool = False):
    """Norm -> QKV -> RoPE -> flash attention -> out-proj. x [B,S,D]."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    y = rms_norm(x, lp["attn_norm"], one_plus=cfg.rms_one_plus)
    q = (y @ lp["wq"]).reshape(b, s, h, hd)
    k = (y @ lp["wk"]).reshape(b, s, kv, hd)
    v = (y @ lp["wv"]).reshape(b, s, kv, hd)
    cos, sin = rope_angles(q_offset + torch.arange(s, device=x.device), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    tuning = tune_config.active().config
    o = ops.flash_attention_train(
        q, k, v, causal=True, window=_window(cfg) if window_active else None,
        cap=cfg.attn_softcap, block_q=min(tuning.flash_block_q, s),
        block_k=min(tuning.flash_block_k, s), bwd_block=min(cfg.q_block, s),
    )
    o = (o.reshape(b, s, h * hd) @ lp["wo"]).to(x.dtype)
    if kv_out:
        return o, (k, v)
    return o


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    dt = _dtype(cfg)
    x = F.embedding(tokens, params["embed"]).to(dt)
    if cfg.rms_one_plus:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of products without batch
    dims (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``),
    recompute everything else."""
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.mm.dtype}


def _remat(fn, policy: str):
    """``fn`` recomputed in the backward: nothing saved (``"nothing"``) or
    the products without batch dims saved (``"dots"``)."""
    if policy not in ("nothing", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}; 'nothing' or 'dots'")
    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = lambda: create_selective_checkpoint_contexts(_save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kwargs)


def forward_hidden(params: dict, tokens: torch.Tensor, ctx: ModelContext | TransformerConfig):
    """tokens [B,S] -> (hidden x [B,S,D] after the final norm, MoE aux).

    The residual carry crosses layers in float32, as the reference's
    (each layer computes in the config's dtype); so does the aux loss
    (0.0 for a dense config). Under autograd, ``cfg.remat`` recomputes
    each layer in the backward (``remat_policy``), and ``remat_chunk > 1``
    (when it divides the depth) also each chunk of that many layers, the
    reference's two-level form."""
    ctx = _context(ctx)
    cfg = ctx.cfg
    dt = _dtype(cfg)
    x32 = _embed(params, tokens, cfg).float()
    aux = torch.zeros((), dtype=torch.float32, device=x32.device)
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    windows = _layer_windows(cfg)

    def layer(i, x32, aux):
        lp = {name: w[i] for name, w in layers.items()}
        x = x32.to(dt)
        x = x + _attn_block(x, lp, cfg, window_active=windows[i])
        y = rms_norm(x, lp["ffn_norm"], one_plus=cfg.rms_one_plus)
        if cfg.is_moe:
            f, aux_l = ctx.moe_layer(y, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"])
            aux = aux + aux_l
        else:
            f = _dense_ffn(y, lp["w_gate"], lp["w_up"], lp["w_down"], cfg)
        return (x + f).float(), aux

    run = layer
    if cfg.remat and torch.is_grad_enabled():
        run = _remat(layer, cfg.remat_policy)
        ck = cfg.remat_chunk if cfg.n_layers % max(cfg.remat_chunk, 1) == 0 else 1
        if ck > 1:  # the outer level: a chunk of ck layers, nothing saved
            inner = run

            def chunk(c, x32, aux):
                for i in range(c * ck, (c + 1) * ck):
                    x32, aux = inner(i, x32, aux)
                return x32, aux

            outer = _remat(chunk, "nothing")
            for c in range(cfg.n_layers // ck):
                x32, aux = outer(c, x32, aux)
            run = None
    for i in range(cfg.n_layers if run is not None else 0):
        x32, aux = run(i, x32, aux)
    x = rms_norm(x32.to(dt), params["final_norm"], one_plus=cfg.rms_one_plus)
    return x, aux


def apply_unembed(params: dict, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Float32 logits with the final soft cap."""
    return softcap(matmul_f32(x, params["unembed"]), cfg.final_softcap)


def forward(params: dict, tokens: torch.Tensor, ctx: ModelContext | TransformerConfig):
    """Full logits [B,S,V] (tests and small models only)."""
    ctx = _context(ctx)
    x, aux = forward_hidden(params, tokens, ctx)
    return apply_unembed(params, x, ctx.cfg), aux


def _chunk_xent(x, blocks, labels, cap, v_loc: int, n_tp: int):
    """One sequence chunk's summed cross-entropy over the vocabulary cut
    into ``n_tp`` blocks of ``v_loc``: x [B,ck,D] and labels [B,ck] on the
    first block's device; ``blocks`` ``[(t0, w)]``, one for each run of
    ``tp`` shards on one device (`sharding.device_runs`), ``w`` their
    column blocks side by side from shard ``t0`` on, on that device. Per
    run: float32 logits with the final soft cap and the row max without a
    gradient (the reference's ``stop_gradient``: exact, the log-sum-exp
    does not depend on the shift); then ``pmax`` of the maxima, ``psum`` of
    the exponentials and ``psum`` of the label's logit from the block that
    holds it, each an all-reduce among the ``n_tp`` shards; a label outside
    the vocabulary adds only the log-sum-exp, as the reference's
    ``where(in_range, ...)``. One run (every shard on one device) is the
    one-shard computation."""
    logits, labs = [], []
    for t0, w in blocks:
        lg = softcap(matmul_f32(x.to(w.device), w), cap)
        width = lg.shape[-1]
        lab = labels.to(w.device).long() - t0 * v_loc
        in_range = (lab >= 0) & (lab < width)
        picked = torch.gather(lg, -1, lab.clamp(0, width - 1)[..., None])[..., 0]
        labs.append(torch.where(in_range, picked, 0.0))
        logits.append(lg)
    m_g = pmax_parts([lg.detach().amax(dim=-1) for lg in logits], group=n_tp)
    se = psum_parts([torch.exp(lg - m_g.to(lg.device)[..., None]).sum(dim=-1) for lg in logits],
                    group=n_tp)
    lse = torch.log(se) + m_g
    return torch.sum(lse - psum_parts(labs, group=n_tp))


def make_loss_fn(ctx: ModelContext | TransformerConfig, aux_weight: float = 0.01,
                 chunk: int = 256):
    """The reference's fused, chunked, vocabulary-parallel cross-entropy:
    ``loss_fn(params, batch {"tokens", "labels"}) -> (loss + aux_weight *
    aux, {"loss", "aux"})``, the mean over every token.

    The forward runs on the whole batch; the loss then runs as the
    reference's ``shard_map``: each ``dp`` shard takes its rows, each
    ``tp`` shard the ``unembed`` column block ``[ti V/tp, (ti+1) V/tp)``
    (moved to the shard's device where that is another; the blocks of
    shards on one device run as one product), ``chunk`` positions at a
    time (:func:`_chunk_xent`), and the loss is the ``pmean`` over ``dp``
    of each shard's mean. Under autograd each chunk's logits are
    recomputed in the backward, so no ``[B,S,V]`` float32 tensor lives (the
    reference's checkpointed scan). A context without a mesh is one shard.
    A vocabulary that ``tp`` does not divide, or a batch that ``dp`` does
    not, raises, as the reference's ``shard_map`` would. Under an op
    counter on ``meta`` the ``dp`` shards' bodies (equal shapes) are
    counted once each way and charged to every shard
    (`obs.counting.each_shard`)."""
    ctx = _context(ctx)
    cfg = ctx.cfg
    cap = cfg.final_softcap
    if ctx.mesh is None:
        devs = [[None]]
    else:
        dp_axes, tp = ctx.rules.dp, ctx.rules.tp
        n_dp = math.prod(ctx.mesh.shape[a] for a in dp_axes)
        devs = [[ctx.mesh.shard(di * ctx.mesh.shape[tp] + ti, (*dp_axes, tp))[0]
                 for ti in range(ctx.mesh.shape[tp])] for di in range(n_dp)]
    n_dp, n_tp = len(devs), len(devs[0])
    if cfg.vocab % n_tp:
        raise ValueError(f"vocabulary {cfg.vocab} does not split over {n_tp} tp shards")
    v_loc = cfg.vocab // n_tp

    def xent(x, unembed, labels):
        b, s, _ = x.shape
        ck = min(chunk, s)
        if s % ck:
            raise ValueError(f"sequence {s} not divisible by the loss chunk {ck}")
        if b % n_dp:
            raise ValueError(f"batch {b} does not split over {n_dp} dp shards")
        b_loc = b // n_dp
        one = _chunk_xent
        if torch.is_grad_enabled():
            one = lambda *a: checkpoint(_chunk_xent, *a, use_reentrant=False)  # noqa: E731

        def shard(di, x, unembed, labels):  # one dp shard's mean over its rows
            home = devs[di][0] or x.device
            rows = slice(di * b_loc, (di + 1) * b_loc)
            xr, lr = x[rows].to(home), labels[rows].to(home)
            blocks = [(t0, unembed[:, t0 * v_loc:t1 * v_loc].to(d or x.device))
                      for d, t0, t1 in device_runs(devs[di])]
            total = torch.zeros((), dtype=torch.float32, device=home)
            for a in range(0, s, ck):
                total = total + one(xr[:, a:a + ck], blocks, lr[:, a:a + ck], cap, v_loc, n_tp)
            return total / (b_loc * s)

        means = counting.each_shard(n_dp, shard, meta=x.is_meta, inputs=(x, unembed, labels))
        return psum_parts(means) / n_dp

    def loss_fn(params, batch):
        x, aux = forward_hidden(params, batch["tokens"], ctx)
        loss = xent(x, params["unembed"], batch["labels"])
        return loss + aux_weight * aux.to(loss.device), {"loss": loss, "aux": aux}

    return loss_fn


def decode_layout(rules: AxisRules, batch: int):
    """(seq_axes, batch axes): batch 1 shards the cache's sequence over
    *all* axes, as the reference's ``decode_layout``."""
    if batch == 1:
        return (*rules.dp, rules.tp), None
    return (rules.tp,), rules.dp if len(rules.dp) > 1 else rules.dp[0]


def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": ParamSpec(shp, _dtype(cfg)), "v": ParamSpec(shp, _dtype(cfg))}


def cache_specs(cfg: TransformerConfig, rules: AxisRules, batch: int) -> dict:
    """The cache's sharding specs, the reference's: ``[L, B, S, KV, hd]``
    with the batch over ``dp`` and the sequence over :func:`decode_layout`'s
    axes."""
    del cfg
    seq_axes, batch_spec = decode_layout(rules, batch)
    seq = seq_axes[0] if len(seq_axes) == 1 else seq_axes  # as PartitionSpec writes one axis
    spec = (None, batch_spec, seq, None, None)
    return {"k": spec, "v": spec}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None) -> dict:
    return {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
            for name, spec in cache_shapes(cfg, batch, max_len).items()}


def make_serve_step(ctx: ModelContext | TransformerConfig, *, batch: int):
    """One-token decode over the KV cache.

    ``serve_step(params, cache, tokens [B], t) -> (logits [B,V] float32,
    cache)``; ``t`` is the new token's position: a 0-d integer tensor on the
    cache's device, as the reference's step takes it, or a host int. The
    cache is updated in place and returned.

    The step reads ``t`` on the device throughout: RoPE's angles come from
    it, the cache write takes it as a device index (``index_copy_``) and
    every layer's `ops.flash_decode` kernel reads it on the card, so with a
    CUDA tensor nothing in the step waits for the host. A host int is
    checked here (``0 <= t < S``) and then filled into such a tensor on the
    device; a tensor is not checked on the host (the decode kernel flags a
    position outside the cache, `flash_decode.take_error`). Any other
    tensor (one element, on another device) is read as a host int.

    Where the context's mesh shards the cache's sequence (the reference's
    ``decode_layout``: over every axis at batch 1, over ``tp`` with the
    batch over ``dp`` otherwise) across more than one shard, each layer
    attends as the reference's ``decode_attend_seqsharded``
    (`attention.decode_attend_seqsharded`: each shard's partial through the
    decode kernel over its slice of the one cache, a view, at positions
    ``<= t - 1``, the log-sum-exp merge, then the new token's own term), and
    writes the new token's K/V at slot ``t`` after the layer's attention;
    nothing in it reads ``t`` on the host either.
    """
    ctx = _context(ctx)
    cfg = ctx.cfg
    attend = None
    if ctx.mesh is not None:
        seq_axes, batch_spec = decode_layout(ctx.rules, batch)
        if math.prod(ctx.mesh.shape[a] for a in seq_axes) > 1:
            attend = attention.decode_attend_seqsharded(
                ctx.mesh, seq_axes=seq_axes, batch_axes=batch_spec, window=_window(cfg),
                cap=cfg.attn_softcap)
    windows = _layer_windows(cfg)
    dt = _dtype(cfg)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def serve_step(params, cache, tokens, t):
        b = tokens.shape[0]
        if b != batch:
            raise ValueError(f"serve_step built for batch {batch}, got {b} tokens")
        dev = cache["k"].device
        if isinstance(t, torch.Tensor) and t.device == dev:
            if t.numel() != 1 or t.dtype.is_floating_point or t.dtype == torch.bool:
                raise TypeError(f"t must be one integer, got {t.dtype} {tuple(t.shape)}")
            t_dev = t.reshape(()).to(torch.int32)  # no copy for an int32 t
        else:
            t = int(t)
            if not 0 <= t < cache["k"].shape[2]:
                raise ValueError(f"position t={t} outside a cache of {cache['k'].shape[2]}")
            t_dev = torch.full((), t, dtype=torch.int32, device=dev)
        # a meta tensor has no value: there the kernels take the host int, so
        # that an op counter charges the decode at that position
        t_kern = t if dev.type == "meta" and not isinstance(t, torch.Tensor) else t_dev
        pos = t_dev.view(1)
        x = _embed(params, tokens, cfg)  # [B, D]
        cos, sin = rope_angles(pos, hd, cfg.rope_theta)
        slot = pos.to(torch.int64)  # the cache write's index, on the device
        for i, windowed in enumerate(windows):
            lp = _layer(params, i)
            y = rms_norm(x, lp["attn_norm"], one_plus=cfg.rms_one_plus)
            q = (y @ lp["wq"]).reshape(b, 1, h, hd)
            kn = (y @ lp["wk"]).reshape(b, 1, kv, hd)
            vn = (y @ lp["wv"]).reshape(b, kv, hd)
            q = apply_rope(q, cos, sin)[:, 0]
            kn = apply_rope(kn, cos, sin)[:, 0]
            if attend is None:
                # the new token's K/V go into the cache first, in place: the
                # kernel then reads positions <= t, and no step copies the cache
                _write_slot(cache, i, slot, kn, vn)
                o = ops.flash_decode(q, cache["k"][i], cache["v"][i], t_kern,
                                     window=_window(cfg) if windowed else None,
                                     cap=cfg.attn_softcap).to(dt)
            else:  # the shards read positions < t; slot t is written after
                o = attend(q, kn, vn, cache["k"][i], cache["v"][i], t_kern, windowed).to(dt)
                _write_slot(cache, i, slot, kn, vn)
            x = x + (o.reshape(b, h * hd) @ lp["wo"]).to(dt)
            y2 = rms_norm(x, lp["ffn_norm"], one_plus=cfg.rms_one_plus)
            x = x + _ffn(y2, lp, ctx)
        x = rms_norm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
        return apply_unembed(params, x, cfg), cache

    return serve_step


def _write_slot(cache: dict, i: int, slot: torch.Tensor, kn, vn) -> None:
    """Layer ``i``'s K/V of the new token into the cache at ``slot`` (a
    one-element device index), in place."""
    cache["k"][i].index_copy_(1, slot, kn[:, None].to(cache["k"].dtype))
    cache["v"][i].index_copy_(1, slot, vn[:, None].to(cache["v"].dtype))


def make_prefill_step(ctx: ModelContext | TransformerConfig):
    """Process full prompts: ``prefill(params, tokens [B,S]) -> (logits
    [B,V] float32 at the last position, {"k", "v"} [L,B,S,KV,hd])``. The
    residual stays in the config's dtype, as the reference's prefill."""
    ctx = _context(ctx)
    cfg = ctx.cfg
    windows = _layer_windows(cfg)

    def prefill(params, tokens):
        b, s = tokens.shape
        x = _embed(params, tokens, cfg)
        cache = init_cache(cfg, b, s, device=x.device)
        for i, windowed in enumerate(windows):
            lp = _layer(params, i)
            o, (k, v) = _attn_block(x, lp, cfg, window_active=windowed, kv_out=True)
            cache["k"][i] = k
            cache["v"][i] = v
            x = x + o
            y = rms_norm(x, lp["ffn_norm"], one_plus=cfg.rms_one_plus)
            x = x + _ffn(y, lp, ctx)
        x = rms_norm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
        return apply_unembed(params, x[:, -1], cfg), cache

    return prefill
