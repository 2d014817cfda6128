"""Decoder-only transformer, dense path: LM serving (prefill, then decode
over a KV cache) — the port's copy of `repro.models.transformer`.

One definition serves the dense LMs of `repro_torch.configs`
(``gemma2-2b``, ``gemma2-27b``, ``h2o-danube-1.8b``): GQA, RoPE, sliding
windows on every layer or on gemma2's even layers only, attention and final
logit soft caps, SwiGLU or GeGLU FFNs, gemma's ``(1 + w)`` RMSNorm and
embedding scale. Parameters keep the reference's pytree: a dict with
``embed [V,D]``, ``final_norm [D]``, ``unembed [D,V]`` and ``layers``, each
leaf stacked ``[L, ...]``; caches are ``{"k", "v"}`` of ``[L,B,S,KV,hd]``.

What differs from the reference, and why:

* the layers are a Python loop over the stacked weights (PyTorch runs
  eagerly; there is no scan to compile) and nothing is sharded: the mesh,
  sharding constraints and remat belong to the reference's multi-chip
  training path, so the step builders take the config where the
  reference's take a context holding it with the mesh;
* attention runs through the kernels: prefill calls
  `ops.flash_attention` with native GQA (no ``repeat``), the window passed
  only on a windowed layer, which is the reference's
  ``in_window | ~window_active``; decode writes the new token's K/V into
  the cache first, in place, then calls `ops.flash_decode` over the
  positions ``<= t``; the reference keeps the cache read-only in its scan
  and folds the new token in as a separate merge term — the same function
  up to summation order, without a copy of the cache per step;
* ``init_params`` draws from a ``torch.Generator``, so its numbers are not
  the reference's (`repro_torch.convert.params_from_numpy` carries the
  reference's own parameters across for the parity tests).

MoE (``cfg.is_moe``) waits for the MoE slice and ``make_loss_fn`` for the
training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (
    activation_fn, apply_rope, init_dense, rms_norm, rope_angles, softcap,
)
from repro_torch.tune import config as tune_config

_LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w_gate", "w_up", "w_down")


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE layers wait for the MoE slice of the port")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


def param_shapes(cfg: TransformerConfig) -> dict:
    """Shape/dtype tree of the parameters (`ParamSpec` leaves)."""
    _dense_only(cfg)
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
        "w_gate": s(l, d, f),
        "w_up": s(l, d, f),
        "w_down": s(l, f, d),
    }
    return {"embed": s(v, d), "layers": layers, "final_norm": s(d), "unembed": s(d, v)}


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Seeded parameter init, as the reference's: matrices normal with std
    0.02, norm scales 1 (0 under gemma's ``(1 + w)`` convention). Drawn on
    ``device`` from ``generator`` (which lives there; seed 0 when None)."""
    device = torch.device("cpu" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def leaf(spec: ParamSpec) -> torch.Tensor:
        if len(spec.shape) >= 2:
            return init_dense(generator, spec.shape, spec.dtype, scale=0.02, device=device)
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)

    shapes = param_shapes(cfg)
    params = {
        "embed": leaf(shapes["embed"]),
        "layers": {name: leaf(spec) for name, spec in shapes["layers"].items()},
        "final_norm": leaf(shapes["final_norm"]),
        "unembed": leaf(shapes["unembed"]),
    }
    if cfg.rms_one_plus:  # gemma (1+w) convention: init scales at 0
        for name in ("attn_norm", "ffn_norm"):
            params["layers"][name].zero_()
        params["final_norm"].zero_()
    return params


def _layer(params: dict, i: int) -> dict:
    return {name: params["layers"][name][i] for name in _LAYER_LEAVES}


def _layer_windows(cfg: TransformerConfig) -> list[bool]:
    """Per layer: does layer i apply the sliding window?"""
    l = cfg.n_layers
    if cfg.local_global_alternating:
        return [i % 2 == 0 for i in range(l)]  # gemma2: even layers local
    return [cfg.sliding_window is not None] * l


def _window(cfg: TransformerConfig) -> int:
    return cfg.sliding_window if cfg.sliding_window is not None else 4096


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
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


def _dense_ffn(x, w_gate, w_up, w_down, cfg: TransformerConfig):
    """SwiGLU / GeGLU (tanh-approximate gelu) with intermediates in ``x``'s
    dtype, as the reference."""
    act = activation_fn(cfg.activation)
    g = x @ w_gate
    u = x @ w_up
    return ((act(g) * u).to(x.dtype) @ w_down).to(x.dtype)


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
    o = ops.flash_attention(
        q, k, v, causal=True, window=_window(cfg) if window_active else None,
        cap=cfg.attn_softcap, block_q=min(tuning.flash_block_q, s),
        block_k=min(tuning.flash_block_k, s),
    )
    o = (o.reshape(b, s, h * hd) @ lp["wo"]).to(x.dtype)
    if kv_out:
        return o, (k, v)
    return o


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    dt = _dtype(cfg)
    x = params["embed"][tokens].to(dt)
    if cfg.rms_one_plus:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B,S] -> (hidden x [B,S,D] after the final norm, aux 0.0).

    The residual carry crosses layers in float32, as the reference's
    (each layer computes in the config's dtype)."""
    _dense_only(cfg)
    dt = _dtype(cfg)
    x32 = _embed(params, tokens, cfg).float()
    for i, windowed in enumerate(_layer_windows(cfg)):
        lp = _layer(params, i)
        x = x32.to(dt)
        x = x + _attn_block(x, lp, cfg, window_active=windowed)
        y = rms_norm(x, lp["ffn_norm"], one_plus=cfg.rms_one_plus)
        x = x + _dense_ffn(y, lp["w_gate"], lp["w_up"], lp["w_down"], cfg)
        x32 = x.float()
    x = rms_norm(x32.to(dt), params["final_norm"], one_plus=cfg.rms_one_plus)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_unembed(params: dict, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Float32 logits with the final soft cap."""
    return softcap(_matmul_f32(x, params["unembed"]), cfg.final_softcap)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """Full logits [B,S,V] (tests and small models only)."""
    x, aux = forward_hidden(params, tokens, cfg)
    return apply_unembed(params, x, cfg), aux


def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": ParamSpec(shp, _dtype(cfg)), "v": ParamSpec(shp, _dtype(cfg))}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None) -> dict:
    return {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
            for name, spec in cache_shapes(cfg, batch, max_len).items()}


def make_serve_step(cfg: TransformerConfig, *, batch: int):
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
    """
    _dense_only(cfg)
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
            # the new token's K/V go into the cache first, in place: the
            # kernel then reads positions <= t, and no step copies the cache
            cache["k"][i].index_copy_(1, slot, kn[:, None].to(cache["k"].dtype))
            cache["v"][i].index_copy_(1, slot, vn[:, None].to(cache["v"].dtype))
            o = ops.flash_decode(q, cache["k"][i], cache["v"][i], t_dev,
                                 window=_window(cfg) if windowed else None,
                                 cap=cfg.attn_softcap).to(dt)
            x = x + (o.reshape(b, h * hd) @ lp["wo"]).to(dt)
            y2 = rms_norm(x, lp["ffn_norm"], one_plus=cfg.rms_one_plus)
            x = x + _dense_ffn(y2, lp["w_gate"], lp["w_up"], lp["w_down"], cfg)
        x = rms_norm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
        return apply_unembed(params, x, cfg), cache

    return serve_step


def make_prefill_step(cfg: TransformerConfig):
    """Process full prompts: ``prefill(params, tokens [B,S]) -> (logits
    [B,V] float32 at the last position, {"k", "v"} [L,B,S,KV,hd])``. The
    residual stays in the config's dtype, as the reference's prefill."""
    _dense_only(cfg)
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
            x = x + _dense_ffn(y, lp["w_gate"], lp["w_up"], lp["w_down"], cfg)
        x = rms_norm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
        return apply_unembed(params, x[:, -1], cfg), cache

    return prefill
