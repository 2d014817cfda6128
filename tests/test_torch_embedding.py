"""Gradients of the port's embedding lookups against ``jax.grad`` of the
reference's, with ids below ``-n`` and at or above ``n``.

JAX clamps such an id in a gather's forward and drops it in the gather's
transpose, so the clamped row gets nothing from it; an id in ``[-n, 0)``
wraps in both. Where the reference clips the ids itself (``embedding_bag``,
the vocab-sharded lookup's local ids), the clipped row does get the
gradient, and the port follows that too. Values and gradients agree within
``TOL`` (float32); the forward values are the reference's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import embedding as ref_embedding
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import embedding, recsys

TOL = {"rtol": 1e-6, "atol": 1e-6}
N_ROWS = 10


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _grads(ref_fn, port_fn, table: np.ndarray, seed: int):
    """(the reference's and the port's value, gradient of sum(value * w)
    with respect to the table), w a seeded cotangent of the value's shape."""
    want_v = np.asarray(ref_fn(jnp.asarray(table)))
    w = np.random.default_rng(seed).normal(size=want_v.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda t: jnp.sum(ref_fn(t) * w))(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    got_v = port_fn(t)
    (got_v * torch.as_tensor(w)).sum().backward()
    return want_v, want_g, got_v.detach().numpy(), t.grad.numpy()


def _check(ref_fn, port_fn, table, seed, what):
    want_v, want_g, got_v, got_g = _grads(ref_fn, port_fn, table, seed)
    np.testing.assert_allclose(got_v, want_v, err_msg=f"{what} value", **TOL)
    np.testing.assert_allclose(got_g, want_g, err_msg=f"{what} gradient", **TOL)
    return want_g


# ids below -n, in [-n, 0), inside, at n and past it
OUTSIDE = np.array([[-11, -10, -1], [0, 9, 10], [23, -25, 4]], np.int32)


def test_field_embed_gradient_drops_ids_outside_the_table():
    tables = np.random.default_rng(1).normal(size=(3, N_ROWS, 4)).astype(np.float32)
    ids = OUTSIDE
    g = _check(lambda t: ref_embedding.field_embed(t, jnp.asarray(ids)),
               lambda t: embedding.field_embed(t, torch.as_tensor(ids)), tables, 2,
               "field_embed")
    # field 0's row 0 is read by id -11 (clamped) and by id 0: only id 0 passes a gradient;
    # field 0's -10 wraps to row 0 as well and passes one
    assert g[0, 0].any()


def test_ragged_bag_gradient_drops_values_outside_the_table():
    table = np.random.default_rng(3).normal(size=(N_ROWS, 4)).astype(np.float32)
    values = np.array([3, -11, -2, 9, 12, 10, 4, 30], np.int32)
    segs = np.array([0, 0, 1, 1, 1, 3, 3, 5], np.int32)  # bag 2 empty, 5 out of range
    for mode in ("sum", "mean", "max"):
        g = _check(
            lambda t: ref_embedding.embedding_bag_ragged(t, jnp.asarray(values), jnp.asarray(segs),
                                                         4, mode=mode),
            lambda t: embedding.embedding_bag_ragged(t, torch.as_tensor(values),
                                                     torch.as_tensor(segs), 4, mode=mode),
            table, 4, f"embedding_bag_ragged {mode}")
        if mode == "sum":  # row 9 is read by 9 (inside) and by 10, 12, 30 (clamped)
            assert g[9].any()


@pytest.mark.parametrize("mode", ("sum", "mean", "max"))
def test_padded_bag_gradient_follows_the_references_clip(mode):
    table = np.random.default_rng(5).normal(size=(N_ROWS, 4)).astype(np.float32)
    bags = np.array([[1, -1, 3, 12], [-11, -1, -1, -1], [0, 2, 10, 9]], np.int32)
    weights = np.random.default_rng(6).random(bags.shape).astype(np.float32)
    everything = np.ones(bags.shape, bool)  # an explicit mask keeps the clipped ids
    for kw in ({}, {"weights": weights}, {"mask": everything}):
        _check(lambda t: ref_embedding.embedding_bag(
                   t, jnp.asarray(bags), mode=mode, **{k: jnp.asarray(v) for k, v in kw.items()}),
               lambda t: embedding.embedding_bag(
                   t, torch.as_tensor(bags), mode=mode,
                   **{k: torch.as_tensor(v) for k, v in kw.items()}),
               table, 7, f"embedding_bag {mode} {sorted(kw)}")


def test_recsys_row_lookup_gradient_drops_ids_outside_the_table():
    table = np.random.default_rng(8).normal(size=(N_ROWS, 4)).astype(np.float32)
    ids = np.array([[-11, -10, -1, 0], [9, 10, 23, 4]], np.int32)
    _check(lambda t: t[jnp.asarray(ids)],
           lambda t: recsys._rows(t, torch.as_tensor(ids)), table, 9, "recsys._rows")


@pytest.mark.parametrize("shape", ((1, 1), (2, 2), (1, 2)))
def test_sharded_field_embed_gradient(mesh, shape):
    tables = np.random.default_rng(10).normal(size=(3, 16, 4)).astype(np.float32)
    ids = np.array([[-17, -16, -1], [0, 15, 16], [40, 3, 8], [7, -2, 15]], np.int32)
    with jax.set_mesh(mesh):
        ref_fn = ref_embedding.make_sharded_field_embed(mesh, "model", ("data",))
        want_v, want_g, got_v, got_g = _grads(
            lambda t: ref_fn(t, jnp.asarray(ids)),
            lambda t: embedding.make_sharded_field_embed(
                make_test_mesh(*shape, device="cpu"), "model", ("data",))(t, torch.as_tensor(ids)),
            tables, 11)
    np.testing.assert_allclose(got_v, want_v, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)


def test_lookups_without_autograd_are_unchanged():
    tables = np.random.default_rng(12).normal(size=(3, N_ROWS, 4)).astype(np.float32)
    t = torch.as_tensor(tables)
    with torch.no_grad():
        a = embedding.field_embed(t.requires_grad_(True), torch.as_tensor(OUTSIDE))
    b = embedding.field_embed(t.detach(), torch.as_tensor(OUTSIDE))
    assert a.numpy().tobytes() == b.numpy().tobytes()
    want = np.asarray(ref_embedding.field_embed(jnp.asarray(tables), jnp.asarray(OUTSIDE)))
    assert b.numpy().tobytes() == want.tobytes()
