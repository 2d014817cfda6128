"""The port's multi-shard parts against the JAX reference's on four faked
host devices, on the CPU: the vocabulary- and data-parallel loss and every
gradient leaf, decode over a sequence-sharded KV cache, the decode kernel's
mergeable partial, and what the op counter charges for them.

The reference runs in a process of its own (`_torch_multishard_ref.py`,
``--xla_force_host_platform_device_count=4``), on ``(2, 2)``, ``(4, 1)`` and
``(1, 4)`` meshes with ``Auto`` axes entered by ``jax.set_mesh``; the port
runs on CPU meshes of the same shapes (`launch.mesh.make_test_mesh(...,
device="cpu")`, every shard on the one CPU, each shard's part in turn).
Both start from the reference's parameters. The reduced configs run in
float32: the loss and each gradient leaf agree within ``REL`` = 1e-5 of
the leaf's largest magnitude, and decode logits within ``TOL`` (rtol 1e-4,
atol 1e-5), the limits of `test_torch_train.py` and
`test_torch_models.py`; greedy tokens are equal.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multishard_ref as R
from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro_torch import configs, convert
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_decode, ops
from repro_torch.launch import opcount
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.obs import counting

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
TOL = {"rtol": 1e-4, "atol": 1e-5}


def start_reference(what: str, out) -> subprocess.Popen:
    """Start the reference's ``what`` run (`_torch_multishard_ref.py`)
    writing ``out``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_multishard_ref.py"), what,
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def reference_results(proc: subprocess.Popen, out) -> dict:
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The loss and decode runs of the reference, started together."""
    root = tmp_path_factory.mktemp("reference")
    procs = {what: start_reference(what, root / f"{what}.npz") for what in ("loss", "decode")}
    return {what: reference_results(proc, root / f"{what}.npz") for what, proc in procs.items()}


def params_of(ref: dict, arch: str) -> dict:
    """The parameters the reference's ``arch`` cases started from."""
    tree: dict = {}
    prefix = f"params/{arch}/"
    for key, x in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = x
    return convert.params_from_numpy(tree)


def assert_rel(name, got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{name}: {err} relative to {scale} (> {rel})"


def port_ctx(arch, shape, tokens_per_shard, mode="train"):
    mesh = make_test_mesh(*shape, device="cpu")
    return tfm.make_context(configs.reduced_config(arch), mesh, sharding.rules_for_mesh(mesh),
                            tokens_per_shard=tokens_per_shard, moe_mode=mode)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# the loss: each dp shard's rows, each tp shard's block of the vocabulary
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_ref(references):
    return references["loss"]


@pytest.mark.parametrize("shape", R.MESHES, ids=R.mesh_key)
@pytest.mark.parametrize("arch,mode", R.LOSS_CASES, ids=lambda x: x)
def test_the_sharded_loss_and_every_gradient_leaf_match_the_reference(loss_ref, arch, mode,
                                                                        shape):
    from repro_torch.data import synthetic

    cfg = configs.reduced_config(arch)
    ctx = port_ctx(arch, shape, R.LOSS_B * R.LOSS_S, mode)
    batch = synthetic.make_lm_batch(batch=R.LOSS_B, seq_len=R.LOSS_S, vocab=cfg.vocab, seed=3)
    (loss, metrics), grads = train_cli.value_and_grad(
        tfm.make_loss_fn(ctx, chunk=R.LOSS_CHUNK), params_of(loss_ref, arch),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    key = f"{arch}/{mode}/{R.mesh_key(shape)}"
    want = float(loss_ref[f"loss/{key}"])
    assert abs(float(metrics["loss"]) - want) <= REL * abs(want), (float(metrics["loss"]), want)
    aux = float(loss_ref[f"aux/{key}"])
    assert abs(float(metrics["aux"]) - aux) <= REL * max(abs(aux), 1.0)
    for name, g in leaves(grads):
        assert g.abs().max() > 0, f"{key}{name}: no gradient"
        assert_rel(f"{key}{name}", g.numpy(), loss_ref[f"grad/{key}{name}"])


def test_a_vocabulary_that_tp_does_not_divide_raises():
    import dataclasses

    mesh = make_test_mesh(1, 3, device="cpu")
    cfg = dataclasses.replace(configs.reduced_config("gemma2-2b"), vocab=512)
    ctx = tfm.make_context(cfg, mesh, sharding.rules_for_mesh(mesh))
    with pytest.raises(ValueError, match="vocabulary 512 does not split over 3 tp shards"):
        tfm.make_loss_fn(ctx)


# ---------------------------------------------------------------------------
# decode over a sequence-sharded cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_ref(references):
    return references["decode"]


@pytest.mark.parametrize("shape", R.MESHES, ids=R.mesh_key)
@pytest.mark.parametrize("batch", (1, 4))
@pytest.mark.parametrize("arch", R.DECODE_ARCHS)
def test_decode_over_a_sequence_sharded_cache_matches_the_reference(decode_ref, arch, batch,
                                                                   shape):
    """Steps at t = 0 (no cached position), inside a shard, on shard
    boundaries, with the window across two shards and at the last slot,
    each fed the reference's previous greedy token: logits within TOL,
    greedy tokens equal, and the cache the reference's after the last
    step."""
    cfg = configs.reduced_config(arch)
    ctx = port_ctx(arch, shape, batch, "train" if batch > 1 else "replicated")
    seq_axes, _ = tfm.decode_layout(ctx.rules, batch)
    sharded = np.prod([ctx.mesh.shape[a] for a in seq_axes]) > 1
    assert sharded == (batch == 1 or shape[1] > 1)
    step = tfm.make_serve_step(ctx, batch=batch)
    params = params_of(decode_ref, arch)
    cache = {k: torch.as_tensor(v) for k, v in R.decode_cache(cfg, batch).items()}
    key = f"{arch}/{batch}/{R.mesh_key(shape)}"
    for i, t in enumerate(R.DECODE_TS):
        fed = torch.as_tensor(decode_ref[f"fed/{key}/{i}"])
        logits, cache = step(params, cache, fed, torch.tensor(t, dtype=torch.int32))
        want = decode_ref[f"logits/{key}/{i}"]
        np.testing.assert_allclose(logits.numpy(), want, err_msg=f"{key} t={t}", **TOL)
        assert np.array_equal(logits.argmax(-1).numpy(), want.argmax(-1)), f"{key} t={t}"
    np.testing.assert_allclose(cache["k"].numpy(), decode_ref[f"cache/{key}"], **TOL)


def test_a_sharded_step_is_the_one_shard_step():
    """In the port itself: a (1, 4) mesh's step (the sequence over 4 shards)
    against the one-shard step from the same cache, at every t."""
    cfg = configs.reduced_config("gemma2-2b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(5))
    one = tfm.make_serve_step(cfg, batch=2)
    four = tfm.make_serve_step(port_ctx("gemma2-2b", (1, 4), 2), batch=2)
    g = torch.Generator().manual_seed(6)
    cache = {n: torch.randn((cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.hd), generator=g)
             for n in ("k", "v")}
    other = {n: x.clone() for n, x in cache.items()}
    tok = torch.tensor([3, 7])
    for t in range(16):
        want, cache = one(params, cache, tok, t)
        got, other = four(params, other, tok, t)
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=f"t={t}", **TOL)
        tok = want.argmax(-1)
    for n in ("k", "v"):
        np.testing.assert_allclose(other[n].numpy(), cache[n].numpy(), **TOL)
    with pytest.raises(ValueError, match="does not split"):
        four(params, {n: x[:, :, :15] for n, x in cache.items()}, tok, 3)


# ---------------------------------------------------------------------------
# the decode kernel's mergeable partial (its plain version)
# ---------------------------------------------------------------------------

PARTIAL_CASES = [  # (S, shards, t, window, cap)
    (32, 4, 13, None, None), (32, 4, 13, 8, 50.0), (32, 4, 0, None, None),
    (32, 4, 8, None, 30.0), (32, 2, 31, 5, None), (48, 3, 47, 20, 50.0)]


@pytest.mark.parametrize("case", PARTIAL_CASES, ids=str)
def test_the_partial_is_the_references_partial_attend(case):
    s, n, t, window, cap = case
    rng = np.random.default_rng(s + t)
    b, kv, g, hd = 2, 2, 2, 16
    q = rng.normal(size=(b, kv * g, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kv, hd)).astype(np.float32) for _ in range(2))
    s_loc = s // n
    parts = []
    for i in range(n):
        cols = slice(i * s_loc, (i + 1) * s_loc)
        o, lse = flash_decode.flash_decode_ref(
            torch.tensor(q), torch.tensor(k)[:, cols], torch.tensor(v)[:, cols], t,
            window=window, cap=cap, pos0=i * s_loc, include_t=False, lse=True)
        m, l, o_t = (np.asarray(x) for x in ref_attention._partial_attend(
            jnp.asarray(q), jnp.asarray(k[:, cols]), jnp.asarray(v[:, cols]),
            jnp.arange(i * s_loc, (i + 1) * s_loc), t, window=window, window_active=None,
            cap=cap, pos_limit=t - 1))
        m, l, o_t = m.reshape(b, -1), l.reshape(b, -1), o_t.reshape(b, -1, hd)
        lo, hi = flash_decode.allowed_range(t, window, pos0=i * s_loc, s=s_loc,
                                            include_t=False)
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        if hi < lo:  # no allowed position: o = 0, lse = -inf
            assert torch.equal(o, torch.zeros_like(o)) and torch.isneginf(lse).all()
        else:
            np.testing.assert_allclose(o.numpy(), o_t / l[..., None], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(lse.numpy(), m + np.log(l), rtol=1e-5, atol=1e-6)
        parts.append(attention.kernel_partial(o, lse))
    # the shards' merge is the whole cache's partial
    if t > 0:
        whole, whole_lse = flash_decode.flash_decode_ref(
            torch.tensor(q), torch.tensor(k), torch.tensor(v), t, window=window, cap=cap,
            include_t=False, lse=True)
        m_g, l_g, o_g = attention.lse_combine(*(torch.stack(x) for x in zip(*parts)))
        np.testing.assert_allclose((o_g / l_g[..., None]).numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose((m_g + torch.log(l_g)).numpy(), whole_lse.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_the_partial_keeps_the_whole_call_and_checks_the_whole_cache():
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(1, 4, 16)).astype(np.float32))
    k, v = (torch.tensor(rng.normal(size=(1, 20, 2, 16)).astype(np.float32)) for _ in range(2))
    # the existing call: pos0 0, t included, no lse, q's dtype
    assert torch.equal(ops.flash_decode(q, k, v, 11, window=6),
                       flash_decode.flash_decode_ref(q, k, v, 11, window=6))
    # a slice's call takes t anywhere in the whole cache, nowhere else
    ops.flash_decode(q, k[:, 10:], v[:, 10:], 3, pos0=10, cache_len=40, lse=True)
    with pytest.raises(ValueError, match="outside a cache of 40"):
        ops.flash_decode(q, k[:, 10:], v[:, 10:], 40, pos0=10, cache_len=40, lse=True)
    with pytest.raises(ValueError, match="outside a cache of 15"):
        ops.flash_decode(q, k[:, 10:], v[:, 10:], 3, pos0=10, cache_len=15, lse=True)
    o, lse = ops.flash_decode(q, k[:, 10:], v[:, 10:], 3, pos0=10, cache_len=40, lse=True)
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (1, 4)
    assert torch.isneginf(lse).all() and not o.any()


# ---------------------------------------------------------------------------
# what the op counter charges
# ---------------------------------------------------------------------------

def test_cost_counts_each_shards_own_range():
    q = torch.empty((1, 8, 256), dtype=torch.bfloat16, device="meta")
    cache = torch.empty((1, 1024, 4, 256), dtype=torch.bfloat16, device="meta")
    whole = flash_decode.cost(q, cache, cache, 4095, window=4096, pos0=3072, cache_len=4096)
    assert whole["flops"]["bf16"] == 4 * 8 * 256 * 1024
    # at t = S - 1 (a device t) with a window of 1,025 only the last shard
    # holds positions before t, and the one before it one
    per = [flash_decode.cost(q, cache, cache, None, window=1025, pos0=i * 1024, cache_len=4096,
                             include_t=False, lse=True) for i in range(4)]
    assert [c["flops"]["bf16"] for c in per] == [0, 0, 4 * 8 * 256 * 1, 4 * 8 * 256 * 1023]
    assert per[0]["bytes"] == 8 * 256 * 2 + 4 * (8 * 256 + 8)


def test_the_merges_record_their_all_reduces():
    with opcount.OpCounter(4) as c:
        attention.lse_combine(torch.zeros(4, 2, 4), torch.ones(4, 2, 4), torch.zeros(4, 2, 4, 8))
        sharding.pmax_parts([torch.zeros(3)] * 2)
    res = c.result()
    # pmax of m, psum of l and of o over 4 shards; a pmax over 2
    assert res["collective_counts"]["all-reduce"] * 4 == 3 * 4 + 2
    assert res["collective_bytes"]["all-reduce"] * 4 == (32 + 32 + 256) * 4 + 12 * 2


def _counted_loss(device: str, shape, **changes):
    import dataclasses

    cfg = dataclasses.replace(configs.reduced_config("qwen3-moe-30b-a3b"), **changes)
    mesh = sharding.Mesh(np.full(shape, torch.device(device), dtype=object), ("data", "model"))
    ctx = tfm.make_context(cfg, mesh, sharding.rules_for_mesh(mesh), tokens_per_shard=4 * 32,
                           moe_mode="seq")
    params = train_cli.tree_map(lambda p: p.to(device),
                                tfm.init_params(cfg, torch.Generator().manual_seed(0)))
    batch = {k: torch.zeros((4, 32), dtype=torch.int32, device=device)
             for k in ("tokens", "labels")}
    with opcount.OpCounter(mesh.size) as c:
        train_cli.value_and_grad(tfm.make_loss_fn(ctx, chunk=16), params, batch)
    return c.result()


def _meta_mesh(shape):
    return sharding.Mesh(np.full(shape, torch.device("meta"), dtype=object), ("data", "model"))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=R.mesh_key)
def test_one_shard_counted_for_all_gives_every_shards_count(shape):
    """A loss and its gradient on meta, where `counting.each_shard` counts
    one shard's body (forward, remat's recompute and backward) for all of
    them, against the same on CPU tensors, where every shard runs: the same
    FLOPs, kernel calls and collectives; the bytes lack only the backward's
    sums of the shards' gradients of their common inputs (each shard's
    gradient of x, of the router), under a tenth."""
    cpu, meta = _counted_loss("cpu", shape), _counted_loss("meta", shape)
    assert meta["flops_by_class"] == cpu["flops_by_class"]
    assert meta["kernels"]["flash_attention"] == cpu["kernels"]["flash_attention"]
    assert meta["collective_counts"] == cpu["collective_counts"]
    assert meta["collective_bytes"] == cpu["collective_bytes"]
    assert 0.9 * cpu["bytes_accessed"] <= meta["bytes_accessed"] <= cpu["bytes_accessed"]


def test_a_two_level_remat_is_counted_as_where_every_shard_runs():
    """Checkpointed chunks of checkpointed layers (dbrx-132b's form): the
    outer recompute reruns the shard bodies' forwards, the inner one's is
    the backward's own; the same FLOPs and collectives as every shard's."""
    changes = {"n_layers": 4, "remat_chunk": 2}
    cpu, meta = _counted_loss("cpu", (2, 2), **changes), _counted_loss("meta", (2, 2), **changes)
    assert meta["flops_by_class"] == cpu["flops_by_class"]
    assert meta["collective_counts"] == cpu["collective_counts"]


def test_a_meta_decode_step_charges_each_shard_its_range():
    cfg = configs.reduced_config("gemma2-2b")  # window 8 on the even layer
    mesh = _meta_mesh((1, 4))
    ctx = tfm.make_context(cfg, mesh, sharding.rules_for_mesh(mesh))
    step = tfm.make_serve_step(ctx, batch=2)
    params = {"embed": torch.empty((cfg.vocab, cfg.d_model), device="meta"),
              "final_norm": torch.empty((cfg.d_model,), device="meta"),
              "unembed": torch.empty((cfg.d_model, cfg.vocab), device="meta"),
              "layers": {n: torch.empty(s.shape, device="meta")
                         for n, s in tfm.param_shapes(cfg)["layers"].items()}}
    cache = {n: torch.empty((2, 2, 32, cfg.n_kv_heads, cfg.hd), device="meta") for n in "kv"}
    tokens = torch.empty((2,), dtype=torch.int32, device="meta")
    with opcount.OpCounter(4) as c:
        step(params, cache, tokens, torch.empty((), dtype=torch.int32, device="meta"))
    line = c.result()["kernels"]["flash_decode"]
    assert line["calls"] == 2 * 4
    # t = 31: the global layer attends to 31 cached positions, the local one
    # to 7 (24..30), all in the last shard
    assert line["flops"]["f32"] * 4 == 4 * 2 * cfg.n_heads * cfg.hd * (31 + 7)
    assert c.result()["collective_counts"]["all-reduce"] > 0
    assert counting.active() is None
