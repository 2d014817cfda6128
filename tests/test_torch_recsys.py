"""The port's recsys models and embedding lookups against the JAX
reference's own functions, on the CPU, from the same numpy inputs.

Both packages start from the reference's parameters (carried across bit
for bit) and the batch functions' bytes (equal in both). The reduced
configs run in float32: the four training losses, each gradient leaf and
the retrieval vectors agree within ``TOL`` (rtol 1e-5, atol 1e-7: FM's
bias gradient is a mean of O(1) terms that cancels to ~1e-3, and the
pairwise sum-square term subtracts two large sums). Lookups follow JAX's
indexing: a negative id wraps once and an id past either end reads the end
row, which torch would refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import synthetic as ref_synthetic
from repro.models import embedding as ref_embedding
from repro.models import recsys as ref_recsys
from repro_torch import configs, convert
from repro_torch.data import synthetic
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import embedding, recsys
from repro_torch.optim import adamw as adamw_lib

ARCHS = ("fm", "dcn-v2", "mind", "sasrec")
TOL = {"rtol": 1e-5, "atol": 1e-7}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _batch(cfg, seed=1, chunk=2, batch=16):
    if cfg.variant in ("fm", "dcn-v2"):
        kw = dict(batch=batch, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                  vocab_per_field=cfg.vocab_per_field, seed=seed, chunk=chunk)
        return ref_synthetic.make_recsys_batch(**kw), synthetic.make_recsys_batch(**kw)
    kw = dict(batch=batch, seq_len=max(cfg.seq_len, 12), n_items=cfg.n_items, seed=seed,
              chunk=chunk)
    return ref_synthetic.make_item_sequences(**kw), synthetic.make_item_sequences(**kw)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, ref_recsys.init_params(cfg, jax.random.key(seed)))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_functions_give_the_references_bytes(arch):
    cfg = configs.get_config(arch)
    for seed, chunk in ((0, 0), (3, 7)):
        want, got = _batch(cfg, seed, chunk, batch=8)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_training_loss_and_gradients_match_the_reference(mesh, arch):
    cfg = ref_configs.reduced_config(arch)
    ref_b, b = _batch(cfg)
    params = _ref_params(cfg)
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(lambda p, bb: ref_recsys.train_logits(
            p, bb, cfg)))(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, ref_b))
    port_cfg = configs.reduced_config(arch)
    (got, _), got_grads = train_cli.value_and_grad(
        lambda p, bb: (recsys.train_logits(p, bb, port_cfg), {}),
        convert.tree_from_numpy(params), {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(got), float(loss), **TOL)
    want = dict(_leaves(jax.tree.map(np.asarray, grads)))
    for name, g in _leaves(got_grads):
        assert g.abs().max() > 0, f"{arch}{name}: no gradient"
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=f"{arch}{name}", **TOL)


@pytest.mark.parametrize("arch", ("fm", "mind", "sasrec"))
def test_user_query_vector_and_score_blocks(mesh, arch):
    cfg = ref_configs.reduced_config(arch)
    ref_b, b = _batch(cfg, seed=5, batch=4)
    params = _ref_params(cfg, seed=1)
    cand = np.random.default_rng(2).standard_normal((40, cfg.embed_dim)).astype(np.float32)
    with jax.set_mesh(mesh):
        want = np.asarray(ref_recsys.user_query_vector(
            jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, ref_b), cfg))
        score = (ref_recsys.score_block_multi_interest if arch == "mind"
                 else ref_recsys.score_block_dot)
        want_s = np.asarray(score(jnp.asarray(want), jnp.asarray(cand)))
    got = recsys.user_query_vector(convert.tree_from_numpy(params),
                                   {k: torch.as_tensor(v) for k, v in b.items()},
                                   configs.reduced_config(arch))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    port_score = (recsys.score_block_multi_interest if arch == "mind"
                  else recsys.score_block_dot)
    np.testing.assert_allclose(port_score(got, torch.as_tensor(cand)).numpy(), want_s, **TOL)


def test_dcn_retrieval_block(mesh):
    cfg = ref_configs.reduced_config("dcn-v2")
    ref_b, b = _batch(cfg, seed=6, batch=1)
    params = _ref_params(cfg, seed=2)
    cand = np.arange(-3, 70, dtype=np.int32)  # past both ends of the 64-row tables
    with jax.set_mesh(mesh):
        want = np.asarray(ref_recsys.score_block_dcn(
            jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, ref_b),
            jnp.asarray(cand), cfg))
    got = recsys.score_block_dcn(convert.tree_from_numpy(params),
                                 {k: torch.as_tensor(v) for k, v in b.items()},
                                 torch.as_tensor(cand), configs.reduced_config("dcn-v2"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="full-forward"):
        recsys.user_query_vector({}, {}, configs.reduced_config("dcn-v2"))
    specs = recsys.param_specs(configs.reduced_config("dcn-v2"), None)  # replicated
    assert specs["cross_w"] == (None, None, None) and specs["head_b"] == (None,)


def test_lookups_follow_jax_indexing():
    rng = np.random.default_rng(7)
    tables = rng.normal(size=(3, 10, 4)).astype(np.float32)
    ids = np.array([[0, 9, -1], [-10, 10, 23], [-11, -25, 5]], np.int32)
    want = np.asarray(ref_embedding.field_embed(jnp.asarray(tables), jnp.asarray(ids)))
    got = embedding.field_embed(torch.as_tensor(tables), torch.as_tensor(ids))
    assert got.numpy().tobytes() == want.tobytes()
    table = tables[0]
    bags = np.array([[1, -1, 3, 12], [-1, -1, -1, -1], [0, 2, 2, 9]], np.int32)
    w = rng.random(bags.shape).astype(np.float32)
    for mode in ("sum", "mean", "max"):
        for kw in ({}, {"weights": w}):
            want = np.asarray(ref_embedding.embedding_bag(
                jnp.asarray(table), jnp.asarray(bags), mode=mode,
                **{k: jnp.asarray(v) for k, v in kw.items()}))
            got = embedding.embedding_bag(torch.as_tensor(table), torch.as_tensor(bags),
                                          mode=mode, **{k: torch.as_tensor(v)
                                                        for k, v in kw.items()})
            np.testing.assert_allclose(got.numpy(), want, err_msg=f"{mode} {kw}", **TOL)
    values = np.array([3, 1, -2, 9, 12, 4, 4], np.int32)
    segs = np.array([0, 0, 1, 1, 1, 3, 5], np.int32)  # bag 2 empty, 5 out of range
    for mode in ("sum", "mean", "max"):
        want = np.asarray(ref_embedding.embedding_bag_ragged(
            jnp.asarray(table), jnp.asarray(values), jnp.asarray(segs), 4, mode=mode))
        got = embedding.embedding_bag_ragged(torch.as_tensor(table), torch.as_tensor(values),
                                             torch.as_tensor(segs), 4, mode=mode)
        np.testing.assert_allclose(got.numpy(), want, err_msg=mode, **TOL)


def test_sharded_field_embed_on_a_faked_mesh(mesh):
    rng = np.random.default_rng(8)
    tables = rng.normal(size=(3, 16, 4)).astype(np.float32)
    ids = rng.integers(0, 16, size=(8, 3)).astype(np.int32)
    ids[0, 0], ids[1, 2] = 16, -1  # outside the table: every shard gives 0
    with jax.set_mesh(mesh):
        want = np.asarray(ref_embedding.make_sharded_field_embed(mesh, "model", ("data",))(
            jnp.asarray(tables), jnp.asarray(ids)))
    for shape in ((1, 1), (2, 2), (1, 4)):
        fn = embedding.make_sharded_field_embed(make_test_mesh(*shape, device="cpu"), "model",
                                                ("data",))
        got = fn(torch.as_tensor(tables), torch.as_tensor(ids))
        assert got.numpy().tobytes() == want.tobytes(), shape
    assert not want[0, 0].any() and not want[1, 2].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_fifteen_training_steps_follow_the_reference(mesh, arch):
    """The reference's own setting (`tests/test_system.py`: 15 steps of 32 at
    lr 3e-3) from the reference's parameters, through both packages' step
    functions: the loss of every step agrees within 1e-4 relative (the
    reduced configs' gradients agree within TOL, and 15 AdamW steps carry
    those differences). Only dcn-v2's loss falls in the reference's test:
    at this size FM's and MIND's losses do not move in 15 steps in the
    reference either (MIND's in-batch softmax starts at ln 32)."""
    from repro.optim import adamw as ref_adamw

    cfg = ref_configs.reduced_config(arch)
    params = _ref_params(cfg)
    ref_lr = ref_adamw.cosine_schedule(3e-3, warmup=1, total=15)
    loss_fn, _, _ = train_cli.build_recsys(configs.reduced_config(arch), None, None, batch=32,
                                           seed=0)
    step_fn = train_cli.make_train_step(loss_fn, adamw_lib.cosine_schedule(3e-3, warmup=1,
                                                                           total=15))
    rp = jax.tree.map(jnp.asarray, params)
    ro = ref_adamw.adamw_init(rp)
    pp = convert.tree_from_numpy(params)
    po = adamw_lib.adamw_init(pp)
    want, got = [], []
    with jax.set_mesh(mesh):
        step = jax.jit(lambda p, o, bb: (lambda lg: ref_adamw.adamw_update(
            lg[1], o, p, lr=ref_lr) + (lg[0],))(jax.value_and_grad(
                lambda q: ref_recsys.train_logits(q, bb, cfg))(p)))
        for i in range(15):
            ref_b, b = _batch(cfg, seed=0, chunk=i, batch=32)
            rp, ro, _, loss = step(rp, ro, jax.tree.map(jnp.asarray, ref_b))
            want.append(float(loss))
            pp, po, _, metrics = step_fn(pp, po, None, {k: torch.as_tensor(v)
                                                        for k, v in b.items()})
            got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    if arch == "dcn-v2":
        assert got[-1] < got[0], got
