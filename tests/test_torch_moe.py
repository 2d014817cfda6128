"""The port's MoE layer against the JAX reference's, on the CPU.

Same seeded numpy inputs, float32, reduced sizes: the router (softmax,
top-k, renormalisation; ties broken toward the lower expert), the
positions within an expert, the gather-only dispatch with its dump slot,
the per-shard body, and `make_moe_layer` in each mode, with and without
``fsdp_experts``, on a 1x1 mesh. The reference's per-shard functions read
``axis_index``, so they run under ``shard_map`` on a one-device mesh with
``Auto`` axes. Integer outputs (expert ids, positions, slots, which
assignments capacity drops) must be equal; float outputs agree within
``TOL`` (rtol 1e-5, atol 1e-6: the same products and sums, in float32,
in another library).

Logical meshes of 2-way ``tp`` and 2x2 with ``fsdp_experts`` (the one CPU
device repeated) are held to the port's own 1x1 result within ``MESH_TOL``
(rtol 1e-5, atol 1e-6): each shard's partial output covers its own experts
(or its ``d_ff`` slice), and the partial sums change the rounding only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

from repro.distributed.sharding import rules_for_mesh as ref_rules_for_mesh
from repro.models import moe as ref_moe
from repro_torch.distributed.sharding import Mesh, rules_for_mesh
from repro_torch.models import moe

TOL = {"rtol": 1e-5, "atol": 1e-6}
MESH_TOL = {"rtol": 1e-5, "atol": 1e-6}
T, D, F, E, K = 64, 16, 24, 8, 2


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _cpu_mesh(shape):
    arr = np.empty(shape, dtype=object)
    arr.fill(torch.device("cpu"))
    return Mesh(arr, ("data", "model"))


def _inputs(seed=0, b=2, scale=0.5):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((b, T // b, D)) * scale).astype(np.float32),
        rng.standard_normal((D, E)).astype(np.float32),
        (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
        (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
        (rng.standard_normal((E, F, D)) * 0.2).astype(np.float32),
    )


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **tol)


def test_router_matches_the_reference_and_breaks_ties_low():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((T, E)).astype(np.float32) * 2
    # ties: whole rows of equal logits and pairs at the k-th place
    logits[:4] = 0.0
    logits[4:12, 3] = logits[4:12, 5] = 4.0
    for k in (1, 2, 3):
        probs, w, ids = moe.router_topk(torch.tensor(logits), k)
        rprobs, rw, rids = ref_moe.router_topk(jnp.asarray(logits), k)
        assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), np.asarray(rids))
        _close(probs, rprobs, "probs")
        _close(w, rw, f"weights k={k}")
        aux = moe.load_balance_loss(probs, ids, E)
        _close(aux, ref_moe.load_balance_loss(rprobs, rids, E), "load balance loss")
    assert ids[0].tolist() == [0, 1, 2]  # equal probabilities: lower experts first
    # the 1e-9 floor of the renormalisation
    _, w, _ = moe.router_topk(torch.full((2, E), -1e4), 2)
    assert torch.isfinite(w).all()


def test_positions_and_dispatch_match_the_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, D)).astype(np.float32)
    flat = rng.integers(0, E, size=T * K).astype(np.int32)
    pos = moe._positions_in_expert(torch.tensor(flat))
    rpos = ref_moe._positions_in_expert(jnp.asarray(flat))
    assert np.array_equal(pos.numpy(), np.asarray(rpos))
    for e0, e_loc, capacity in ((0, E, 8), (0, E, 32), (4, 4, 8), (2, 3, 16)):
        h, slot, keep = moe._dispatch(torch.tensor(x), torch.tensor(flat), pos, e0, e_loc,
                                      capacity, K)
        rh, rslot, rkeep = ref_moe._dispatch(jnp.asarray(x), jnp.asarray(flat), rpos, e0,
                                             e_loc, capacity, K)
        assert np.array_equal(keep.numpy(), np.asarray(rkeep)), (e0, e_loc, capacity)
        assert np.array_equal(slot.numpy(), np.asarray(rslot)), (e0, e_loc, capacity)
        assert h.shape == (e_loc, capacity, D)
        assert h.numpy().tobytes() == np.asarray(rh).tobytes()
    assert not keep.all()  # capacity 16 over 3 experts drops assignments


@pytest.mark.parametrize("capacity", [8, 16, 64])
def test_moe_ffn_local_matches_the_reference(mesh, capacity):
    x, router, gate, up, down = _inputs(3)
    x2 = x.reshape(T, D)
    y, aux = moe.moe_ffn_local(*map(torch.tensor, (x2, router, gate, up, down)),
                               n_experts=E, top_k=K, capacity=capacity)

    def body(*args):
        return ref_moe.moe_ffn_local(*args, n_experts=E, top_k=K, capacity=capacity,
                                     tp_axis="model", out_psum_axes=None)

    ref = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),) * 5, out_specs=(P(), P()),
                            check_rep=False))
    with jax.set_mesh(mesh):
        ry, raux = ref(*map(jnp.asarray, (x2, router, gate, up, down)))
    _close(y, ry, f"y at capacity {capacity}")
    _close(aux, raux, "aux")
    # capacity drops, token by token: a token whose every assignment was
    # dropped has a zero row on both sides
    _, _, ids = moe.router_topk(torch.tensor(x2) @ torch.tensor(router), K)
    pos = moe._positions_in_expert(ids.reshape(-1))
    dropped = (pos >= capacity).reshape(T, K).all(-1).numpy()
    assert np.array_equal(dropped, np.all(np.asarray(ry) == 0, axis=-1))
    assert np.array_equal(dropped, (y == 0).all(-1).numpy())
    if capacity == 8:
        assert dropped.any()


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", ["train", "seq", "replicated"])
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_layer_matches_the_reference_on_one_device(mesh, mode, fsdp, cf):
    args = _inputs(4)
    ref_rules = ref_rules_for_mesh(mesh)
    ref_layer = ref_moe.make_moe_layer(mesh, ref_rules.dp, ref_rules.tp, n_experts=E,
                                       top_k=K, capacity_factor=cf, tokens_per_shard=T,
                                       mode=mode, fsdp_experts=fsdp)
    with jax.set_mesh(mesh):
        ry, raux = ref_layer(*map(jnp.asarray, args))
    one = _cpu_mesh((1, 1))
    rules = rules_for_mesh(one)
    layer = moe.make_moe_layer(one, rules.dp, rules.tp, n_experts=E, top_k=K,
                               capacity_factor=cf, tokens_per_shard=T, mode=mode,
                               fsdp_experts=fsdp)
    y, aux = layer(*map(torch.tensor, args))
    assert y.shape == ry.shape
    _close(y, ry, f"{mode} fsdp={fsdp} cf={cf}")
    _close(aux, raux, "aux")


def test_capacity_follows_tokens_per_shard():
    # the reference's rule: round8(max(int(T k / E cf), 8))
    assert moe.capacity_for(8192, 8, 128, 1.25) == 640
    assert moe.capacity_for(4, 8, 128, 1.25) == 8
    assert moe.capacity_for(512, 8, 128, 1.25) == 40
    assert moe.capacity_for(100, 2, 4, 1.25) == 64
    with pytest.raises(ValueError, match="unknown MoE mode"):
        moe.make_moe_layer(_cpu_mesh((1, 1)), ("data",), "model", n_experts=E, top_k=K,
                           capacity_factor=1.0, tokens_per_shard=T, mode="ring")


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", ["train", "seq", "replicated"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_logical_meshes_match_the_one_device_layer(mode, fsdp, shape):
    """2-way tp (experts split) and 2x2 (experts over tp, batch or d_ff over
    dp): the same output as the 1x1 layer within MESH_TOL; aux is the dp
    shards' mean of their local losses, as in the reference."""
    args = list(map(torch.tensor, _inputs(5, b=4)))
    n_dp = shape[0]
    tokens = T if mode == "replicated" else T // n_dp
    base = moe.make_moe_layer(_cpu_mesh((1, 1)), ("data",), "model", n_experts=E, top_k=K,
                              capacity_factor=4.0, tokens_per_shard=T, mode=mode,
                              fsdp_experts=fsdp)
    split = moe.make_moe_layer(_cpu_mesh(shape), ("data",), "model", n_experts=E, top_k=K,
                               capacity_factor=4.0, tokens_per_shard=tokens, mode=mode,
                               fsdp_experts=fsdp)
    y0, aux0 = base(*args)
    y, aux = split(*args)
    _close(y, y0, f"{mode} fsdp={fsdp} mesh={shape}", MESH_TOL)
    if n_dp == 1 or mode == "replicated":
        _close(aux, aux0, "aux")
    else:
        x = args[0]
        halves = [base(x[i * 2:(i + 1) * 2], *args[1:])[1] for i in range(2)]
        _close(aux, (halves[0] + halves[1]) / 2, "aux: the mean over dp")
    with pytest.raises(ValueError, match="do not split"):
        split(args[0], args[1], *(a[:3] for a in args[2:]))
