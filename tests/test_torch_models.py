"""The port's dense LM against the JAX reference's own functions, on the CPU.

Same numpy inputs through both packages: the shared pieces
(`models.common`), the attention functions (`models.attention`), the
reference's parameters carried across (`convert.params_from_numpy`, bit for
bit), `make_lm_batch` (byte for byte), and the LM serving path itself:
`make_prefill_step` (last-position logits and the KV cache),
`make_serve_step` over several steps (logits and caches), a decode that
starts from a prefilled cache and crosses the sliding window, and
`forward`, for the reduced ``gemma2-2b``, ``gemma2-27b`` and
``h2o-danube-1.8b`` in float32, and the same path for the reduced MoE
``qwen3-moe-30b-a3b`` and ``dbrx-132b`` through contexts on a 1x1 mesh
(`make_context`: prefill with ``tokens_per_shard`` = B*S in ``seq`` mode,
decode with ``tokens_per_shard`` = B, as the reference's smoke tests),
whose routing and capacity drops follow the reference's.

The reference runs under a one-device mesh with ``Auto`` axes entered by
``jax.set_mesh``: its ``make_test_mesh`` builds ``Explicit`` axes, under
which its LM functions fail on this JAX (`ROADMAP.md` queue 3), and nothing
in the reference changes here. The port's attention runs through its
kernels' plain versions (full-row softmax); the reference's prefill runs
``chunked_attention`` and its decode a log-sum-exp merge with the new token
as a separate term. Those compute the same function in another order, so
float32 results agree within ``TOL`` (rtol 1e-4, atol 1e-5; the logits of
these models are O(0.1)), and greedy tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import synthetic as ref_synthetic
from repro.distributed.sharding import rules_for_mesh
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import transformer as ref_tfm
from repro_torch import configs, convert
from repro_torch.data import synthetic
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention, common
from repro_torch.models import transformer as tfm

ARCHS = ("gemma2-2b", "gemma2-27b", "h2o-danube-1.8b")
MOE_ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
TOL = {"rtol": 1e-4, "atol": 1e-5}
EXACT = {"rtol": 1e-6, "atol": 1e-6}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _ref_ctx(cfg, mesh, batch, mode="train"):
    return ref_tfm.make_context(cfg, mesh, rules_for_mesh(mesh), tokens_per_shard=batch,
                                moe_mode=mode)


def _port_ctx(arch, tokens_per_shard, mode="train", shape=(1, 1)):
    mesh = make_test_mesh(*shape, device="cpu")
    return tfm.make_context(configs.reduced_config(arch), mesh, sharding.rules_for_mesh(mesh),
                            tokens_per_shard=tokens_per_shard, moe_mode=mode)


def _params(arch, seed=0):
    cfg = ref_configs.reduced_config(arch)
    ref_params = ref_tfm.init_params(cfg, jax.random.key(seed))
    # the gemma (1+w) norms init at 0; perturb every norm scale so they matter
    rng = np.random.default_rng(seed)
    ref_params["layers"]["attn_norm"] = jnp.asarray(
        rng.normal(0, 0.1, ref_params["layers"]["attn_norm"].shape).astype(np.float32))
    ref_params["final_norm"] = jnp.asarray(
        rng.normal(0, 0.1, ref_params["final_norm"].shape).astype(np.float32))
    port_params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    return cfg, ref_params, port_params


def _close(a, b, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               err_msg=what, **tol)


# ---------------------------------------------------------------------------
# configs, data, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_configs_match_the_reference(arch):
    mine, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert vars(mine) == vars(ref)
    assert (mine.hd, mine.is_moe, mine.param_count(), mine.active_param_count()) == (
        ref.hd, ref.is_moe, ref.param_count(), ref.active_param_count())
    assert vars(configs.reduced_config(arch)) == vars(ref_configs.reduced_config(arch))


def test_later_slices_refuse_their_configs():
    # the GNN config runs now (the GNN slice), the reference's own
    assert vars(configs.get_config("pna")) == vars(ref_configs.get_config("pna"))
    assert vars(configs.reduced_config("pna")) == vars(ref_configs.reduced_config("pna"))
    # the recsys configs run now (the training slice), the reference's own
    for arch in ("sasrec", "fm", "dcn-v2", "mind"):
        assert vars(configs.get_config(arch)) == vars(ref_configs.get_config(arch))
        assert vars(configs.reduced_config(arch)) == vars(ref_configs.reduced_config(arch))
    # the MoE configs run now (the MoE slice), through a context with a MoE
    # layer: a step built from a MoE config alone says how to build one
    moe = configs.reduced_config("qwen3-moe-30b-a3b")
    assert tfm.param_shapes(moe)["layers"]["w_gate"].shape == (2, 4, 64, 128)
    for build in (tfm.make_prefill_step, lambda c: tfm.make_serve_step(c, batch=2)):
        with pytest.raises(ValueError, match="make_context"):
            build(moe)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("nope")


def test_make_lm_batch_is_the_references_bytes():
    for kw in ({"batch": 4, "seq_len": 64, "vocab": 256_000, "seed": 0},
               {"batch": 3, "seq_len": 17, "vocab": 512, "seed": 5, "chunk": 2}):
        mine, ref = synthetic.make_lm_batch(**kw), ref_synthetic.make_lm_batch(**kw)
        assert sorted(mine) == sorted(ref)
        for key in mine:
            assert mine[key].dtype == ref[key].dtype == np.int32
            assert mine[key].tobytes() == ref[key].tobytes()


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_params_from_numpy_carries_the_references_init(arch):
    cfg = ref_configs.reduced_config(arch)
    ref_params = jax.tree.map(np.asarray, ref_tfm.init_params(cfg, jax.random.key(1)))
    mine = convert.params_from_numpy(ref_params)
    shapes = tfm.param_shapes(configs.reduced_config(arch))
    assert sorted(mine) == sorted(shapes) and sorted(mine["layers"]) == sorted(shapes["layers"])
    for name in ("embed", "final_norm", "unembed"):
        assert tuple(mine[name].shape) == shapes[name].shape
        assert mine[name].numpy().tobytes() == ref_params[name].tobytes()
    for name, spec in shapes["layers"].items():
        assert tuple(mine["layers"][name].shape) == spec.shape
        assert mine["layers"][name].numpy().tobytes() == ref_params["layers"][name].tobytes()
    # the port's own init has the reference's layout and conventions
    own = tfm.init_params(configs.reduced_config(arch), torch.Generator().manual_seed(0))
    for name in ("embed", "unembed"):
        assert own[name].shape == mine[name].shape and own[name].dtype == torch.float32
        assert abs(float(own[name].std()) - 0.02) < 2e-3
    # as the reference's rule: every leaf of two or more dims (the stacked
    # [L, D] norm scales too) is drawn, 1-d leaves are ones; gemma's (1+w)
    # norms are zeros
    if cfg.rms_one_plus:
        assert torch.all(own["layers"]["attn_norm"] == 0) and torch.all(own["final_norm"] == 0)
    else:
        assert abs(float(own["layers"]["attn_norm"].std()) - 0.02) < 5e-3
        assert torch.all(own["final_norm"] == 1)
        assert np.array_equal(ref_params["final_norm"], np.ones_like(ref_params["final_norm"]))


def test_bfloat16_params_carry_bit_for_bit():
    import dataclasses

    cfg = dataclasses.replace(ref_configs.reduced_config("gemma2-2b"), dtype="bfloat16")
    ref_params = jax.tree.map(np.asarray, ref_tfm.init_params(cfg, jax.random.key(2)))
    mine = convert.params_from_numpy(ref_params)
    assert mine["embed"].dtype == torch.bfloat16
    assert mine["layers"]["wq"].view(torch.int16).numpy().tobytes() == \
        ref_params["layers"]["wq"].view(np.int16).tobytes()
    cache = {"k": ref_params["layers"]["wk"][None], "v": ref_params["layers"]["wv"][None]}
    back = convert.cache_from_numpy(cache)
    assert back["k"].dtype == torch.bfloat16 and back["k"].shape == cache["k"].shape


# ---------------------------------------------------------------------------
# common and attention
# ---------------------------------------------------------------------------

def test_common_pieces_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    for one_plus in (False, True):
        _close(common.rms_norm(torch.tensor(x), torch.tensor(w), one_plus=one_plus),
               ref_common.rms_norm(jnp.asarray(x), jnp.asarray(w), one_plus=one_plus),
               f"rms_norm one_plus={one_plus}", EXACT)
    for cap in (None, 30.0):
        _close(common.softcap(torch.tensor(x * 40), cap),
               ref_common.softcap(jnp.asarray(x * 40), cap), f"softcap {cap}", EXACT)
    pos = np.array([0, 3, 17, 4095, 8191], np.int32)
    cos, sin = common.rope_angles(torch.tensor(pos), 16, 10_000.0)
    rcos, rsin = ref_common.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    _close(cos, rcos, "rope cos", {"rtol": 1e-5, "atol": 2e-5})
    _close(sin, rsin, "rope sin", {"rtol": 1e-5, "atol": 2e-5})
    _close(common.apply_rope(torch.tensor(x), cos, sin),
           ref_common.apply_rope(jnp.asarray(x), rcos, rsin), "apply_rope",
           {"rtol": 1e-5, "atol": 2e-5})
    for name in ("silu", "gelu", "relu"):
        _close(common.activation_fn(name)(torch.tensor(x)),
               ref_common.activation_fn(name)(jnp.asarray(x)), name, EXACT)


@pytest.mark.parametrize("causal,window,active", [(True, None, None), (True, 8, None),
                                                  (True, 8, True), (True, 8, False),
                                                  (False, 5, None)])
def test_attention_functions_match_the_reference(causal, window, active):
    rng = np.random.default_rng(1)
    b, s, h, kv, hd = 2, 32, 4, 2, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    pos_q, pos_k = np.arange(4, 12), np.arange(s)
    ref_active = None if active is None else jnp.asarray(active)
    mask = attention._mask_ok(torch.tensor(pos_q), torch.tensor(pos_k), causal=causal,
                              window=window, window_active=active)
    want = ref_attention._mask_ok(jnp.asarray(pos_q), jnp.asarray(pos_k), causal=causal,
                                  window=window, window_active=ref_active)
    assert np.array_equal(mask.numpy(), np.asarray(want))
    got = attention.chunked_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      q_block=8, causal=causal, window=window,
                                      window_active=active, cap=30.0)
    want = ref_attention.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           q_block=8, causal=causal, window=window,
                                           window_active=ref_active, cap=30.0)
    _close(got, want, "chunked_attention", EXACT)

    # decode: the full-cache attention, the shards' partials and their merge
    qd = rng.standard_normal((b, h, hd)).astype(np.float32)
    kc = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    t = 20
    full = attention.attend_cache(torch.tensor(qd), torch.tensor(kc), torch.tensor(vc), t,
                                  window=window, window_active=active, cap=50.0)
    want = ref_attention.attend_cache(jnp.asarray(qd), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray(t), window=window,
                                      window_active=ref_active, cap=50.0)
    _close(full, want, "attend_cache", EXACT)
    partials = []
    for a in range(0, s, 8):
        pos = np.arange(a, a + 8)
        mine = attention._partial_attend(
            torch.tensor(qd), torch.tensor(kc[:, a : a + 8]), torch.tensor(vc[:, a : a + 8]),
            torch.tensor(pos), t, window=window, window_active=active, cap=50.0)
        ref = ref_attention._partial_attend(
            jnp.asarray(qd), jnp.asarray(kc[:, a : a + 8]), jnp.asarray(vc[:, a : a + 8]),
            jnp.asarray(pos), jnp.asarray(t), window=window, window_active=ref_active,
            cap=50.0)
        for got_x, want_x, what in zip(mine, ref, "mlo"):
            _close(got_x, want_x, f"_partial_attend {what} at {a}", EXACT)
        partials.append(mine)
    merged = attention.lse_merge(partials)
    _close(merged.reshape(b, h, hd), full, "lse_merge of the partials", EXACT)


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_the_reference(arch, mesh):
    """Prefill 16 tokens, copy the cache into 32 slots, then decode 10
    greedy steps (t = 16..25): past the window of 8 on every windowed
    layer."""
    cfg, ref_params, port_params = _params(arch)
    batch, prompt, slots = 2, 16, 32
    tokens = synthetic.make_lm_batch(batch=batch, seq_len=prompt, vocab=cfg.vocab)["tokens"]
    cfg_port = configs.reduced_config(arch)
    logits, cache = tfm.make_prefill_step(cfg_port)(port_params, torch.tensor(tokens))
    with jax.set_mesh(mesh):
        rctx = _ref_ctx(cfg, mesh, batch)
        rlogits, rcache = ref_tfm.make_prefill_step(rctx)(ref_params, jnp.asarray(tokens))
        _close(logits, rlogits, f"{arch} prefill logits")
        for name in ("k", "v"):
            assert tuple(cache[name].shape) == rcache[name].shape
            _close(cache[name], rcache[name], f"{arch} prefill cache {name}")
        full = tfm.init_cache(cfg_port, batch, slots)
        rfull = ref_tfm.init_cache(cfg, batch, slots)
        for name in ("k", "v"):
            full[name][:, :, :prompt] = cache[name]
            rfull[name] = rfull[name].at[:, :, :prompt].set(rcache[name])
        step = tfm.make_serve_step(cfg_port, batch=batch)
        rstep = jax.jit(ref_tfm.make_serve_step(rctx, batch=batch))
        tok = torch.argmax(logits, dim=-1)
        rtok = jnp.argmax(rlogits, -1).astype(jnp.int32)
        for t in range(prompt, prompt + 10):
            assert np.array_equal(tok.numpy(), np.asarray(rtok)), f"{arch} tokens at t={t}"
            logits, full = step(port_params, full, tok, t)
            rlogits, rfull = rstep(ref_params, rfull, rtok, jnp.asarray(t, jnp.int32))
            _close(logits, rlogits, f"{arch} decode logits at t={t}")
            tok = torch.argmax(logits, dim=-1)
            rtok = jnp.argmax(rlogits, -1).astype(jnp.int32)
        for name in ("k", "v"):
            _close(full[name], rfull[name], f"{arch} decoded cache {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_an_empty_cache_matches_the_reference(arch, mesh):
    """The reference CLI's decode: from t = 0, every step's argmax fed back,
    through 12 steps (past the window of 8)."""
    cfg, ref_params, port_params = _params(arch, seed=3)
    batch, slots = 4, 20
    cfg_port = configs.reduced_config(arch)
    step = tfm.make_serve_step(cfg_port, batch=batch)
    cache = tfm.init_cache(cfg_port, batch, slots)
    tok = torch.ones((batch,), dtype=torch.int64)
    with jax.set_mesh(mesh):
        rstep = jax.jit(ref_tfm.make_serve_step(_ref_ctx(cfg, mesh, batch), batch=batch))
        rcache = ref_tfm.init_cache(cfg, batch, slots)
        rtok = jnp.ones((batch,), jnp.int32)
        for t in range(12):
            logits, cache = step(port_params, cache, tok, t)
            rlogits, rcache = rstep(ref_params, rcache, rtok, jnp.asarray(t, jnp.int32))
            _close(logits, rlogits, f"{arch} logits at t={t}")
            tok = torch.argmax(logits, dim=-1)
            rtok = jnp.argmax(rlogits, -1).astype(jnp.int32)
            assert np.array_equal(tok.numpy(), np.asarray(rtok)), f"{arch} tokens at t={t}"
    for name in ("k", "v"):
        _close(cache[name], rcache[name], f"{arch} cache {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch, mesh):
    cfg, ref_params, port_params = _params(arch, seed=4)
    tokens = synthetic.make_lm_batch(batch=2, seq_len=32, vocab=cfg.vocab, seed=4)["tokens"]
    logits, aux = tfm.forward(port_params, torch.tensor(tokens), configs.reduced_config(arch))
    with jax.set_mesh(mesh):
        rlogits, raux = ref_tfm.forward(ref_params, jnp.asarray(tokens),
                                        _ref_ctx(cfg, mesh, 2))
    assert logits.shape == rlogits.shape and logits.dtype == torch.float32
    _close(logits, rlogits, f"{arch} forward logits")
    assert float(aux) == float(raux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_takes_t_as_a_tensor(arch):
    """``t`` as a 0-d int32 tensor on the cache's device (advanced in place,
    as the decode CLI does) gives the host-int step's logits and cache bit
    for bit, through 12 steps past the window of 8."""
    cfg = configs.reduced_config(arch)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(5))
    step = tfm.make_serve_step(cfg, batch=2)
    caches = [tfm.init_cache(cfg, 2, 16), tfm.init_cache(cfg, 2, 16)]
    toks = [torch.ones(2, dtype=torch.int64)] * 2
    t_dev = torch.zeros((), dtype=torch.int32)
    for t in range(12):
        want, caches[0] = step(params, caches[0], toks[0], t)
        got, caches[1] = step(params, caches[1], toks[1], t_dev)
        t_dev += 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"{arch} t={t}"
        toks = [torch.argmax(want, dim=-1), torch.argmax(got, dim=-1)]
    for name in ("k", "v"):
        assert torch.equal(caches[0][name], caches[1][name])
    with pytest.raises(TypeError, match="one integer"):
        step(params, caches[1], toks[1], torch.tensor(3.0))


def test_serve_step_refuses_what_it_cannot_take():
    cfg = configs.reduced_config("gemma2-2b")
    params = tfm.init_params(cfg)
    step = tfm.make_serve_step(cfg, batch=2)
    cache = tfm.init_cache(cfg, 2, 8)
    with pytest.raises(ValueError, match="outside a cache"):
        step(params, cache, torch.ones(2, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="batch 2"):
        step(params, cache, torch.ones(3, dtype=torch.int64), 0)
    assert tfm._layer_windows(cfg) == [True, False]
    assert tfm._layer_windows(configs.reduced_config("h2o-danube-1.8b")) == [True, True]
    assert tfm._window(cfg) == 8


# ---------------------------------------------------------------------------
# MoE serving through contexts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_then_decode_match_the_reference(arch, mesh):
    """The reduced MoE configs: prefill 16 tokens (capacity from B*S, seq
    mode), copy the cache into 32 slots, decode 10 greedy steps (capacity
    from B), then the full forward with its aux loss."""
    cfg, ref_params, port_params = _params(arch, seed=6)
    batch, prompt, slots = 2, 16, 32
    tokens = synthetic.make_lm_batch(batch=batch, seq_len=prompt, vocab=cfg.vocab, seed=6)["tokens"]
    cfg_port = configs.reduced_config(arch)
    pctx = _port_ctx(arch, batch * prompt, "seq")
    logits, cache = tfm.make_prefill_step(pctx)(port_params, torch.tensor(tokens))
    with jax.set_mesh(mesh):
        rctx_p = _ref_ctx(cfg, mesh, batch * prompt, "seq")
        rctx = _ref_ctx(cfg, mesh, batch)
        rlogits, rcache = ref_tfm.make_prefill_step(rctx_p)(ref_params, jnp.asarray(tokens))
        _close(logits, rlogits, f"{arch} prefill logits")
        for name in ("k", "v"):
            _close(cache[name], rcache[name], f"{arch} prefill cache {name}")
        full = tfm.init_cache(cfg_port, batch, slots)
        rfull = ref_tfm.init_cache(cfg, batch, slots)
        for name in ("k", "v"):
            full[name][:, :, :prompt] = cache[name]
            rfull[name] = rfull[name].at[:, :, :prompt].set(rcache[name])
        step = tfm.make_serve_step(_port_ctx(arch, batch), batch=batch)
        rstep = jax.jit(ref_tfm.make_serve_step(rctx, batch=batch))
        tok = torch.argmax(logits, dim=-1)
        rtok = jnp.argmax(rlogits, -1).astype(jnp.int32)
        for t in range(prompt, prompt + 10):
            assert np.array_equal(tok.numpy(), np.asarray(rtok)), f"{arch} tokens at t={t}"
            logits, full = step(port_params, full, tok, t)
            rlogits, rfull = rstep(ref_params, rfull, rtok, jnp.asarray(t, jnp.int32))
            _close(logits, rlogits, f"{arch} decode logits at t={t}")
            tok = torch.argmax(logits, dim=-1)
            rtok = jnp.argmax(rlogits, -1).astype(jnp.int32)
        for name in ("k", "v"):
            _close(full[name], rfull[name], f"{arch} decoded cache {name}")
        flogits, aux = tfm.forward(port_params, torch.tensor(tokens), pctx)
        rflogits, raux = ref_tfm.forward(ref_params, jnp.asarray(tokens), rctx_p)
    _close(flogits, rflogits, f"{arch} forward logits")
    _close(aux, raux, f"{arch} aux loss")
    assert float(aux) > 0


def test_moe_contexts_and_the_sequence_sharded_cache():
    cfg = configs.reduced_config("qwen3-moe-30b-a3b")
    full = configs.get_config("qwen3-moe-30b-a3b")
    # both MoE configs hold more than 2^33 B of expert weights: ZeRO-3 them
    assert tfm.uses_fsdp_experts(full) and tfm.uses_fsdp_experts(configs.get_config("dbrx-132b"))
    assert not tfm.uses_fsdp_experts(cfg) and not tfm.uses_fsdp_experts(
        configs.get_config("gemma2-2b"))
    assert tfm.uses_fsdp_experts(full) == ref_tfm.uses_fsdp_experts(
        ref_configs.get_config("qwen3-moe-30b-a3b"))
    assert round(full.param_count() * 2 / 1e9, 1) == 60.2
    # a MoE config without tokens_per_shard gets no layer, as the reference's
    mesh = make_test_mesh(1, 1, device="cpu")
    rules = sharding.rules_for_mesh(mesh)
    assert tfm.make_context(cfg, mesh, rules).moe_layer is None
    assert tfm.make_context(configs.reduced_config("gemma2-2b"), mesh, rules,
                            tokens_per_shard=4).moe_layer is None
    # a cache whose sequence spans shards (over tp at batch 2, over every
    # axis at batch 1) decodes as the 1x1 context's step does
    params = tfm.init_params(cfg, torch.Generator().manual_seed(7))
    for shape, batch in (((1, 2), 2), ((2, 1), 1)):
        mode = "train" if batch > 1 else "replicated"
        sharded = tfm.make_serve_step(_port_ctx("qwen3-moe-30b-a3b", batch, mode, shape),
                                      batch=batch)
        one = tfm.make_serve_step(_port_ctx("qwen3-moe-30b-a3b", batch, mode), batch=batch)
        g = torch.Generator().manual_seed(8)
        cache = {n: torch.randn((cfg.n_layers, batch, 16, cfg.n_kv_heads, cfg.hd), generator=g)
                 for n in ("k", "v")}
        other = {n: x.clone() for n, x in cache.items()}
        tok = torch.arange(batch)
        for t in (0, 7, 8, 15):
            want, cache = one(params, cache, tok, t)
            got, other = sharded(params, other, tok, t)
            _close(got, want, f"{shape} sequence-sharded decode at t={t}")
    # the MoE layer over a 2-way tp mesh serves the 1x1 layer's prefill
    tokens = torch.tensor(synthetic.make_lm_batch(batch=2, seq_len=16, vocab=cfg.vocab,
                                                  seed=7)["tokens"])
    want, _ = tfm.make_prefill_step(_port_ctx("qwen3-moe-30b-a3b", 32, "seq"))(params, tokens)
    got, _ = tfm.make_prefill_step(_port_ctx("qwen3-moe-30b-a3b", 32, "seq", (1, 2)))(
        params, tokens)
    _close(got, want, "prefill logits over a 2-way tp mesh")
