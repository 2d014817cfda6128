"""The port's GNN (PNA) against the JAX reference's own functions, on the CPU.

Both packages start from the same seeded numpy inputs and the reference's
parameters (carried across bit for bit). Host stages (``make_graph``,
``bucket_edges``, ``build_csr``, ``sample_batch``) and integer outputs must
be the reference's bytes. Float outputs, losses and every gradient leaf are
compared to the reference's (``jax.grad``'s, NaN where the reference's are
NaN) within ``TOL`` (rtol 1e-5, atol 1e-5), at ``reduced_config("pna")``
and at the full ``pna`` config (4 layers, d 75) on a small graph, in
float64 in both packages (the reference under ``jax.enable_x64``). In
float32 ``TOL`` is out of reach, and so is the reference's own
``REF_TOL`` (rtol 2e-4, atol 2e-5, `tests/test_embedding_gnn.py:87`) for
some elements: the reference's init (std ``shape[0] ** -0.5`` over the
stacked layers) grows the activations ~60x a layer, so one rounding
amplifies through the cancellations. The reference's own jitted and eager
forwards differ by up to 3.2e-5 relative at the reduced config and 2.6e-4
at the full one, and a gradient element near zero moves by up to 7.7e-5.
So float64 checks the math at ``TOL``, and the reduced config's float32
logits and loss are held to ``REF_TOL`` beside it (the training steps run
in float32 too).

The sharded full-graph forward runs on (1,), (4,) and (2, 2) meshes of the
CPU (the device repeated) in both modes. The reference's own sharded
forward needs one device a shard, so it runs in a subprocess that fakes
four host devices (``--xla_force_host_platform_device_count=4``), on
(1, 1), (4, 1) and (2, 2) meshes: the same shards in the same flat order
(a one-axis mesh's rules name its axis twice in the reference). Those
comparisons run in float64 at ``TOL``: in float32 a gradient element near
zero differs by up to 4e-5 (2e-7 of its leaf's largest), over
``REF_TOL``'s atol.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import GNNConfig as RefGNNConfig
from repro.data import graph_prep as ref_graph_prep
from repro.data import sampler as ref_sampler
from repro.data import synthetic as ref_synthetic
from repro.distributed.sharding import rules_for_mesh as ref_rules_for_mesh
from repro.models import gnn as ref_gnn
from repro.optim import adamw as ref_adamw
from repro_torch import configs, convert
from repro_torch.data import graph_prep, sampler, synthetic
from repro_torch.distributed.sharding import Mesh, rules_for_mesh
from repro_torch.launch import train as train_cli
from repro_torch.models import gnn, segment
from repro_torch.optim import adamw as adamw_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"rtol": 1e-5, "atol": 1e-5}
REF_TOL = {"rtol": 2e-4, "atol": 2e-5}
D_FEAT = 9


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _close(got, want, what, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **tol)


def _close_trees(got: dict, want: dict, what: str, tol=TOL):
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (name, a), (_, b) in zip(g, w):
        _close(a, b, f"{what}{name}", tol)


def _ref_params(cfg, d_feat=D_FEAT, seed=0):
    return jax.tree.map(np.asarray, ref_gnn.init_params(cfg, d_feat, jax.random.key(seed)))


def _cfgs():
    return {"reduced": configs.reduced_config("pna"), "full": configs.get_config("pna")}


def _regime(which):
    """The float64 config of a size (see the module docstring)."""
    cfg = configs.reduced_config("pna") if which == "reduced" else configs.get_config("pna")
    return dataclasses.replace(cfg, dtype="float64")


def _graph(n_nodes=48, n_edges=200, seed=3, ties=False):
    """A ``make_graph`` graph; with ``ties``, edges repeated on purpose (equal
    messages, so tied maxima and minima): a pair inside the first quarter
    of the edges and a pair across each quarter's boundary."""
    g = ref_synthetic.make_graph(n_nodes=n_nodes, n_edges=n_edges, d_feat=D_FEAT, seed=seed)
    if ties:
        q = n_edges // 4
        for a in (5, q - 1, 2 * q - 1, 3 * q - 1):  # edge a+1 repeats edge a (dst stays sorted)
            g["src"][a + 1], g["dst"][a + 1] = g["src"][a], g["dst"][a]
    return g


def _ref_grads(loss, params):
    val, grads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, params))
    return float(val), jax.tree.map(np.asarray, grads)


def _port_grads(loss, params):
    (val, _), grads = train_cli.value_and_grad(lambda p, b: (lambda l: (l, {"loss": l}))(
        loss(p)), params, None)
    return float(val), grads


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# host stages: the reference's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"n_nodes": 48, "n_edges": 200, "d_feat": 9, "seed": 3},
    {"n_nodes": 3072, "n_edges": 10_556, "d_feat": 33, "n_classes": 7},
    {"n_nodes": 5000, "n_edges": 70_000, "d_feat": 5, "n_classes": 41, "seed": 11},
    {"n_nodes": 1, "n_edges": 4, "d_feat": 1},
])
def test_make_graph_is_the_references_bytes(kw):
    mine, ref = synthetic.make_graph(**kw), ref_synthetic.make_graph(**kw)
    assert sorted(mine) == sorted(ref) == ["dst", "src", "x", "y"]
    for key in ref:
        assert mine[key].dtype == ref[key].dtype and mine[key].shape == ref[key].shape
        assert mine[key].tobytes() == ref[key].tobytes(), key


@pytest.mark.parametrize("n_shards,bucket", [(1, None), (2, None), (4, 96), (8, None)])
def test_bucket_edges_is_the_references_bytes(n_shards, bucket):
    g = ref_synthetic.make_graph(n_nodes=64, n_edges=300, d_feat=3, seed=4)
    kw = dict(n_nodes=64, n_shards=n_shards, bucket_size=bucket)
    mine = graph_prep.bucket_edges(g["src"], g["dst"], **kw)
    ref = ref_graph_prep.bucket_edges(g["src"], g["dst"], **kw)
    assert mine[2] == ref[2]
    for a, b in zip(mine[:2], ref[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="bucket overflow"):
        graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=64, n_shards=4, bucket_size=8)


def test_csr_and_sampled_batches_are_the_references_bytes():
    g = ref_synthetic.make_graph(n_nodes=200, n_edges=1000, d_feat=7, seed=4)
    g["dst"][:40] = 199  # unsorted, and isolated nodes (self-loops in the sampler)
    mine = sampler.build_csr(g["src"], g["dst"], g["x"], g["y"])
    ref = ref_sampler.build_csr(g["src"], g["dst"], g["x"], g["y"])
    for f in ("indptr", "indices", "feats", "labels"):
        assert getattr(mine, f).tobytes() == getattr(ref, f).tobytes(), f
    assert mine.n_nodes == ref.n_nodes
    for step in (0, 3):
        a = sampler.sample_batch(mine, batch_nodes=16, fanout=(5, 3), seed=1, step=step)
        b = ref_sampler.sample_batch(ref, batch_nodes=16, fanout=(5, 3), seed=1, step=step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (step, k)


def test_configs_and_shapes_equal_the_references():
    for name in ("pna",):
        assert configs.family(name) == "gnn"
        assert vars(configs.get_config(name)) == vars(ref_configs.get_config(name))
        assert vars(configs.reduced_config(name)) == vars(ref_configs.reduced_config(name))
    for arch in ("pna", "gemma2-2b", "fm", "mirex"):
        mine, ref = configs.shapes_for(arch), ref_configs.shapes_for(arch)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert (mine[k].name, mine[k].kind, mine[k].dims) == (
                ref[k].name, ref[k].kind, ref[k].dims)
            assert str(mine[k]) == str(ref[k])


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_params_carry_across_bit_for_bit(which):
    cfg = _cfgs()[which]
    ref_cfg = RefGNNConfig(**vars(cfg))
    shapes, ref_shapes = gnn.param_shapes(cfg, D_FEAT), ref_gnn.param_shapes(ref_cfg, D_FEAT)
    assert [(k, s.shape) for k, s in _leaves(shapes)] == [
        (k, s.shape) for k, s in _leaves(ref_shapes)]
    params = _ref_params(ref_cfg)
    port = convert.tree_from_numpy(params)
    for (k, a), (_, b) in zip(_leaves(port), _leaves(params)):
        assert a.dtype == torch.float32 and a.numpy().tobytes() == b.tobytes(), k
    mine = gnn.init_params(cfg, D_FEAT, torch.Generator().manual_seed(0))
    again = gnn.init_params(cfg, D_FEAT, torch.Generator().manual_seed(0))
    for (k, a), (_, b), (_, s) in zip(_leaves(mine), _leaves(again), _leaves(shapes)):
        assert tuple(a.shape) == s.shape and a.numpy().tobytes() == b.numpy().tobytes(), k
    assert not mine["b_in"].any() and mine["layers"]["b_msg"].any()  # 2-D biases are drawn
    specs = gnn.param_specs(cfg, None)  # replicated (tests/test_torch_lowering.py: the reference's)
    assert specs["layers"]["w_upd"] == (None, None, None) and specs["b_out"] == (None,)


# ---------------------------------------------------------------------------
# the segment reduce
# ---------------------------------------------------------------------------

def _segment_case(seed, sort):
    rng = np.random.default_rng(seed)
    e, n, d = 60, 9, 4
    rows = np.round(rng.standard_normal((e, d)), 0).astype(np.float32)  # many ties
    ids = rng.integers(-2, n + 2, e).astype(np.int32)  # some dropped
    ids[ids == 4] = 5  # segment 4 empty
    if sort:
        ids = np.sort(np.where((ids >= 0) & (ids < n), ids, n + 1))
    cot = rng.standard_normal((n, d)).astype(np.float32)  # cotangents of both signs
    return rows, ids, n, cot


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_reduce_follows_jax_segment_ops(op, sort):
    """Values (empty segments 0 / -inf / +inf, dropped ids) and gradients
    (a tied maximum's gradient split equally, whatever its sign) equal
    ``jax.ops.segment_*``'s."""
    rows, ids, n, cot = _segment_case(7, sort)
    ref_fn = {"sum": jax.ops.segment_sum, "max": jax.ops.segment_max,
              "min": jax.ops.segment_min}[op]
    want = np.asarray(ref_fn(jnp.asarray(rows), jnp.asarray(ids), n))
    ref_grad = np.asarray(jax.grad(lambda r: jnp.sum(jnp.where(
        jnp.isfinite(ref_fn(r, jnp.asarray(ids), n)), ref_fn(r, jnp.asarray(ids), n), 0.0)
        * cot))(jnp.asarray(rows)))
    x = torch.tensor(rows, requires_grad=True)
    seg = segment.segments(torch.as_tensor(ids), n)
    assert (seg.order is None) == sort
    got = seg.reduce(seg.take(x), op)
    # a tie of 0.0 and -0.0 may keep either
    np.testing.assert_array_equal(got.detach().numpy(), want)
    loss = (torch.where(torch.isfinite(got), got, 0.0) * torch.as_tensor(cot)).sum()
    grad, = torch.autograd.grad(loss, x)
    _close(grad, ref_grad, op)
    counts = np.bincount(ids[(ids >= 0) & (ids < n)], minlength=n)
    assert seg.count().numpy().tolist() == counts.astype(np.float32).tolist()
    assert seg.ids().numpy().tolist() == np.repeat(np.arange(n), counts).tolist()


def test_gather_backward_is_a_segment_sum():
    """`segment.gather`: ``table[idx]`` forward; its gradient is ``jax.grad``'s
    of the same gather within TOL, and the same bits twice (and with the
    grouping given by the caller)."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, 4000)
    cot = rng.standard_normal((4000, 6)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(t[jnp.asarray(idx)] * cot))(
        jnp.asarray(table)))
    grads = []
    for seg in (None, segment.segments(_t(idx), 50), None):
        x = torch.tensor(table, requires_grad=True)
        out = segment.gather(x, _t(idx), seg)
        assert torch.equal(out.detach(), x.detach()[_t(idx)])
        grads.append(torch.autograd.grad((out * _t(cot)).sum(), x)[0])
    _close(grads[0], want, "gather grad")
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    with torch.no_grad():
        assert torch.equal(segment.gather(_t(table), _t(idx)), _t(table)[_t(idx)])


def test_segment_blocks_split_no_segment():
    rows, ids, n, _ = _segment_case(3, False)
    seg = segment.segments(torch.as_tensor(ids), n)
    x = torch.as_tensor(rows)
    whole = {op: seg.reduce(seg.take(x), op) for op in ("sum", "max", "min")}
    for max_rows in (1, 5, 17, 1000):
        blocks = seg.blocks(max_rows)
        assert [b[0] for b in blocks] == [0] + [b[1] for b in blocks[:-1]]
        assert blocks[-1][1] == n
        for op in ("sum", "max", "min"):
            parts = torch.cat([b.reduce(b.take(x), op) for _, _, b in blocks])
            assert parts.numpy().tobytes() == whole[op].numpy().tobytes(), (max_rows, op)
        for i0, i1, b in blocks:
            assert b.n_valid <= max_rows or i1 - i0 == 1


# ---------------------------------------------------------------------------
# the forwards and their gradients against jax.grad
# ---------------------------------------------------------------------------

def _compare(which, ref_fn, port_fn, inputs, y):
    """Logits, loss and every gradient leaf of ``ref_fn`` / ``port_fn``
    (``(params, *inputs) -> logits``) from the reference's parameters, in
    float64 within TOL; at the reduced config also the float32 logits and
    loss within REF_TOL. Returns the float64 gradients (port, reference)."""
    def run(cfg, dt):
        ins = [a.astype(dt) if a.dtype.kind == "f" else a for a in inputs]
        params = _ref_params(cfg)
        want = jax.jit(lambda p: ref_fn(p, *map(jnp.asarray, ins), cfg))(
            jax.tree.map(jnp.asarray, params))
        ref_val, ref_g = _ref_grads(lambda p: ref_gnn.xent_loss(
            ref_fn(p, *map(jnp.asarray, ins), cfg), jnp.asarray(y)), params)
        pp = convert.tree_from_numpy(params)
        assert pp["w_in"].dtype == getattr(torch, cfg.dtype)
        val, grads = _port_grads(lambda p: gnn.xent_loss(port_fn(p, *map(_t, ins), cfg),
                                                          _t(y)), pp)
        return port_fn(pp, *map(_t, ins), cfg), np.asarray(want), val, ref_val, grads, ref_g

    cfg = _regime(which)
    with jax.enable_x64(True):
        logits, want, val, ref_val, grads, ref_g = run(cfg, np.float64)
    _close(logits, want, "logits")
    _close(val, ref_val, "loss")
    _close_trees(grads, ref_g, "grad")
    if which == "reduced":
        logits32, want32, val32, ref_val32, _, _ = run(configs.reduced_config("pna"), np.float32)
        _close(logits32, want32, "float32 logits", REF_TOL)
        _close(val32, ref_val32, "float32 loss", REF_TOL)
    return grads, ref_g


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_full_graph_forward_and_gradients(which):
    """With edges repeated on purpose (tied maxima and minima) and a source
    id past the end (read clamped, no gradient, as JAX's gather)."""
    g = _graph(ties=True)
    g["src"][7] = 48 + 3
    _compare(which, ref_gnn.forward_full_graph, gnn.forward_full_graph,
             [g["x"], g["src"], g["dst"]], g["y"] % 16)


def test_layer_local_and_blocked_layer():
    """One layer against the reference's, and the same layer aggregated in
    blocks of a few edges (no destination split) against the one-block
    layer (its update's product then runs on fewer rows a call, so the
    bits may differ: within TOL)."""
    cfg = configs.reduced_config("pna")
    g = _graph(ties=True)
    params = _ref_params(cfg)
    h = np.random.default_rng(2).standard_normal((48, cfg.d_hidden)).astype(np.float32)
    lp = jax.tree.map(lambda p: jnp.asarray(p[1]), params["layers"])
    want = ref_gnn.pna_layer_local(jnp.asarray(h), jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
                                   lp, cfg, 48)
    plp = {k: torch.as_tensor(np.asarray(v)) for k, v in lp.items()}
    got = gnn.pna_layer_local(_t(h), _t(g["src"]), _t(g["dst"]), plp, cfg, 48)
    _close(got, np.asarray(want), "layer", REF_TOL)
    old = gnn.EDGE_BLOCK
    try:
        gnn.EDGE_BLOCK = 7
        blocked = gnn.pna_layer_local(_t(h), _t(g["src"]), _t(g["dst"]), plp, cfg, 48)
    finally:
        gnn.EDGE_BLOCK = old
    assert len(segment.segments(_t(g["dst"]), 48).blocks(7)) > 10
    _close(blocked, got, "blocked layer", TOL)


def test_bucketed_layer_equals_unsharded_forward():
    """1-shard bucketed path == the plain full-graph forward (the
    reference's `tests/test_embedding_gnn.py` check, at its tolerance: the
    ghost edges change nothing), and each bucketed layer == the
    reference's."""
    cfg = configs.reduced_config("pna")
    g = synthetic.make_graph(n_nodes=48, n_edges=200, d_feat=9, seed=3)
    params = _ref_params(cfg)
    pp = convert.tree_from_numpy(params)
    ref = gnn.forward_full_graph(pp, _t(g["x"]), _t(g["src"]), _t(g["dst"]), cfg)
    bs, bd, _ = graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=48, n_shards=1,
                                        bucket_size=256)
    h = torch.relu(_t(g["x"]) @ pp["w_in"] + pp["b_in"])
    rh = jax.nn.relu(jnp.asarray(g["x"]) @ params["w_in"] + params["b_in"])
    for i in range(cfg.n_layers):
        lp = gnn.layer_params(pp, i)
        h = gnn.pna_layer_bucketed(h, _t(bs), _t(bd), lp, cfg, 48, 0)
        rh = ref_gnn.pna_layer_bucketed(rh, jnp.asarray(bs), jnp.asarray(bd), jax.tree.map(
            lambda p, i=i: jnp.asarray(p[i]), params["layers"]), cfg, 48, 0)
        _close(h, np.asarray(rh), f"bucketed layer {i}", REF_TOL)
    out = h @ pp["w_out"] + pp["b_out"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_sampled_forward_and_gradients(which):
    rng = np.random.default_rng(5)
    b, k1, k2 = 6, 4, 3
    inputs = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, D_FEAT), (b, k1, D_FEAT), (b, k1, k2, D_FEAT))]
    _compare(which, ref_gnn.forward_sampled, gnn.forward_sampled, inputs,
             rng.integers(0, 16, b).astype(np.int32))


def test_sampled_std_is_the_population_std_and_nan_where_the_references_is():
    """A fanout group whose sampled neighbours all repeat has zero variance:
    the reference's gradient through ``jnp.std`` is NaN there, and so is
    the port's (``sqrt(var)``; ``torch.std``'s backward would give 0). A
    fanout of 2 makes the variance exactly 0 in every channel on both
    sides (``a + a`` and its half are exact), so the NaN falls on the same
    elements; with 3 the mean's rounding decides channel by channel."""
    rng = np.random.default_rng(6)
    b, k1, k2 = 3, 2, 2
    seed_x = rng.standard_normal((b, D_FEAT)).astype(np.float32)
    hop1 = rng.standard_normal((b, k1, D_FEAT)).astype(np.float32)
    hop2 = rng.standard_normal((b, k1, k2, D_FEAT)).astype(np.float32)
    hop2[0, 1, :] = hop2[0, 1, 0]  # one group's neighbours all the same node
    grads, ref_g = _compare("reduced", ref_gnn.forward_sampled, gnn.forward_sampled,
                            [seed_x, hop1, hop2], np.zeros(b, np.int32))  # float64
    nan_leaves = [k for k, v in _leaves(ref_g) if np.isnan(v).any()]
    assert nan_leaves  # the reference's own NaN, matched leaf by leaf in _compare
    for (k, a), (_, w) in zip(_leaves(grads), _leaves(ref_g)):
        assert np.array_equal(np.isnan(a.numpy()), np.isnan(w)), k
    m = torch.tensor([[1.0, 2.0, 3.0]])
    assert torch.sqrt(m.var(-1, correction=0)).item() == pytest.approx(
        float(jnp.std(jnp.asarray([1.0, 2.0, 3.0]))))


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_batched_graphs_forward_and_gradients(which):
    """Unsorted per-graph edges, some ids outside their graph: sources
    clamp into it (passing no gradient), destinations outside it drop, as
    under the reference's vmap."""
    rng = np.random.default_rng(8)
    b, n, e = 4, 10, 20
    x = rng.standard_normal((b, n, D_FEAT)).astype(np.float32)
    src = rng.integers(0, n, (b, e)).astype(np.int32)
    dst = rng.integers(0, n, (b, e)).astype(np.int32)
    src[0, :3], dst[1, :2], dst[2, 5], src[3, 4] = n + 2, n, -1, -1
    _compare(which, ref_gnn.forward_batched_graphs, gnn.forward_batched_graphs, [x, src, dst],
             rng.integers(0, 16, b).astype(np.int32))


def test_xent_loss():
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((5, 7)) * 30).astype(np.float32)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    want = float(ref_gnn.xent_loss(jnp.asarray(logits), jnp.asarray(labels)))
    _close(gnn.xent_loss(_t(logits), _t(labels)), want, "xent")


# ---------------------------------------------------------------------------
# the sharded full-graph forward
# ---------------------------------------------------------------------------

_SHARDED_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.configs import reduced_config
from repro.distributed.sharding import rules_for_mesh
from repro.models import gnn

inp = dict(np.load(sys.argv[1]))
cfg = reduced_config("pna")
params = {k[2:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("p/")}
params = {"layers": {k[7:]: v for k, v in params.items() if k.startswith("layers/")},
          **{k: v for k, v in params.items() if not k.startswith("layers/")}}
out = {}
for shape in [(1, 1), (4, 1), (2, 2)]:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = rules_for_mesh(mesh)
    tag = "x".join(map(str, shape))
    for mode in ("bucketed", "scatter"):
        fwd = gnn.make_sharded_full_graph(mesh, rules, cfg, mode=mode)
        src = jnp.asarray(inp[f"src_{mode}_{tag}"])
        dst = jnp.asarray(inp[f"dst_{mode}_{tag}"])
        x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
        with jax.set_mesh(mesh):
            out[f"{tag}_{mode}_logits"] = np.asarray(jax.jit(fwd)(params, x, src, dst))
            grads = jax.jit(jax.grad(lambda p: gnn.xent_loss(fwd(p, x, src, dst), y)))(params)
        for k, v in grads["layers"].items():
            out[f"{tag}_{mode}_g/layers/{k}"] = np.asarray(v)
        for k, v in grads.items():
            if k != "layers":
                out[f"{tag}_{mode}_g/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("ok")
"""

MESHES = {"1": ((1,), ("data",)), "4": ((4,), ("data",)), "2x2": ((2, 2), ("data", "model"))}
REF_TAG = {"1": "1x1", "4": "4x1", "2x2": "2x2"}
N_SHARDED = 64


def _slabs(g, mode, n_shards):
    if mode == "bucketed":
        src, dst, _ = ref_graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=N_SHARDED,
                                                  n_shards=n_shards)
        return src, dst
    return g["src"], g["dst"]


@pytest.fixture(scope="module")
def sharded_case(tmp_path_factory):
    """The reference's sharded logits and gradients on faked devices, in
    float64, for a graph with ties inside a shard's slab and across slab
    boundaries."""
    cfg = configs.reduced_config("pna")
    g = _graph(n_nodes=N_SHARDED, n_edges=256, seed=4, ties=True)
    g["y"] = g["y"] % cfg.n_classes
    g["x"] = g["x"].astype(np.float64)
    params = jax.tree.map(lambda a: a.astype(np.float64), _ref_params(cfg, seed=1))
    d = tmp_path_factory.mktemp("gnn_sharded")
    arrays = {f"p{k}": v for k, v in _leaves(params)}
    arrays.update(x=g["x"], y=g["y"])
    for key, (shape, _) in MESHES.items():
        for mode in ("bucketed", "scatter"):
            src, dst = _slabs(g, mode, int(np.prod(shape)))
            arrays[f"src_{mode}_{REF_TAG[key]}"], arrays[f"dst_{mode}_{REF_TAG[key]}"] = src, dst
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _SHARDED_SCRIPT, str(d / "in.npz"),
                           str(d / "out.npz")], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return g, params, dict(np.load(d / "out.npz"))


def _cpu_mesh(shape, names):
    arr = np.empty(shape, dtype=object)
    arr.fill(torch.device("cpu"))
    return Mesh(arr, names)


@pytest.mark.parametrize("mode", ["bucketed", "scatter"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_sharded_full_graph_follows_the_reference(sharded_case, mesh_key, mode):
    """Logits equal the port's own full-graph forward's (float32 and
    float64) and the reference's sharded ones; every gradient leaf equals
    the reference's sharded gradient (float64). The scatter mode's gradient
    is the reference's too where it leaves the full graph's: each shard's
    ``pmax`` cotangent covers its own node rows only (``gnn.py:126-130``),
    so a maximum held by another shard's edges gets none (ROADMAP queue
    3)."""
    g, params, ref = sharded_case
    cfg = configs.reduced_config("pna")
    shape, names = MESHES[mesh_key]
    mesh = _cpu_mesh(shape, names)
    fwd = gnn.make_sharded_full_graph(mesh, rules_for_mesh(mesh), cfg, mode=mode)
    src, dst = _slabs(g, mode, int(np.prod(shape)))
    pp = convert.tree_from_numpy(params)
    args = (_t(g["x"]), _t(src), _t(dst))
    tag = f"{REF_TAG[mesh_key]}_{mode}"
    logits = fwd(pp, *args)
    full = gnn.forward_full_graph(pp, _t(g["x"]), _t(g["src"]), _t(g["dst"]), cfg)
    _close(logits, ref[f"{tag}_logits"], "logits vs the reference's sharded forward")
    _close(logits, full, "logits vs forward_full_graph")
    p32 = convert.tree_from_numpy(jax.tree.map(lambda a: a.astype(np.float32), params))
    x32 = args[0].float()
    _close(fwd(p32, x32, *args[1:]),
           gnn.forward_full_graph(p32, x32, _t(g["src"]), _t(g["dst"]), cfg),
           "float32 logits vs forward_full_graph")
    _, grads = _port_grads(lambda p: gnn.xent_loss(fwd(p, *args), _t(g["y"])), pp)
    want = {}
    for k, v in ref.items():
        if k.startswith(f"{tag}_g/"):
            node, parts = want, k[len(tag) + 3:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    _close_trees(grads, want, f"{tag} grad")


def test_sharded_scatter_gradient_leaves_the_full_graphs_on_four_shards(sharded_case):
    """The reference's fault, followed: on one shard both modes give the
    full graph's gradient; on four shards the scatter mode's differs."""
    g, params, ref = sharded_case
    cfg = configs.reduced_config("pna")
    pp = convert.tree_from_numpy(params)
    _, full = _port_grads(lambda p: gnn.xent_loss(gnn.forward_full_graph(
        p, _t(g["x"]), _t(g["src"]), _t(g["dst"]), cfg), _t(g["y"])), pp)
    w_full = full["layers"]["w_src"].numpy()
    _close(ref["1x1_scatter_g/layers/w_src"], w_full, "1 shard")
    _close(ref["4x1_bucketed_g/layers/w_src"], w_full, "bucketed")
    rel = (np.abs(ref["4x1_scatter_g/layers/w_src"] - w_full).max() / np.abs(w_full).max())
    assert rel > 1e-3


def test_cross_shard_ties_split_among_shards_then_edges():
    """Hand-worked, on two shards of one row each: node 0's maximum 3 is
    held by two edges of shard 0 and one of shard 1, node 1's maximum 1 by
    one edge of shard 0 and two of shard 1. A shard's cotangent covers its
    own row (the reference's ``_pmax_bwd`` on each shard): shard 0's
    gradient 1 at node 0 is halved between the two tied shards, and its
    half splits over its two edges (a quarter each); shard 1's half is
    shard 1's cotangent there, 0. Node 1 alike, from shard 1's side. The
    full graph would give node 0's three edges a third each."""
    m0 = torch.tensor([[3.0], [3.0], [1.0]], requires_grad=True)  # shard 0: dst 0, 0, 1
    m1 = torch.tensor([[3.0], [1.0], [1.0]], requires_grad=True)  # shard 1: dst 0, 1, 1
    dst0, dst1 = torch.tensor([0, 0, 1]), torch.tensor([0, 1, 1])
    aggs = [gnn.partial_aggregates(m, d, 2) for m, d in ((m0, dst0), (m1, dst1))]
    merged = gnn.merge_aggregates(aggs)
    assert merged[0]["max"].tolist() == merged[1]["max"].tolist() == [[3.0], [1.0]]
    assert merged[0]["cnt"].tolist() == [3.0, 3.0]
    (merged[0]["max"][0].sum() + merged[1]["max"][1].sum()).backward()
    assert m0.grad.ravel().tolist() == [0.25, 0.25, 0.0]
    assert m1.grad.ravel().tolist() == [0.0, 0.25, 0.25]
    assert [x.ravel().tolist() for x in gnn.pmin_diff([torch.tensor([1.0, 2.0]),
                                                       torch.tensor([1.0, 0.0])])] == [
        [1.0, 0.0], [1.0, 0.0]]
    # the reference's own pmax backward on the same partials (a vmapped axis
    # stands in for the shards), against the port's
    x = np.array([[3.0, 1.0], [3.0, 1.0]], np.float32)
    g = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    want = jax.vmap(lambda xi, gi: ref_gnn._pmax_bwd("s", (xi, jax.lax.pmax(xi, "s")), gi)[0],
                    axis_name="s")(jnp.asarray(x), jnp.asarray(g))
    xs = [torch.tensor(row, requires_grad=True) for row in x]
    torch.autograd.backward(gnn.pmax_diff(xs), [torch.tensor(row) for row in g])
    assert [xi.grad.tolist() for xi in xs] == np.asarray(want).tolist() == [[0.5, 0.0],
                                                                            [0.0, 0.5]]


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def _train_batches(kind, cfg, n_shards=1):
    rng = np.random.default_rng(12)
    if kind == "full_graph":
        g = synthetic.make_graph(n_nodes=64, n_edges=256, d_feat=D_FEAT, seed=7)
        src, dst, _ = graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=64,
                                              n_shards=n_shards)
        return {"x": g["x"], "src": src, "dst": dst, "labels": g["y"] % cfg.n_classes}
    if kind == "minibatch":
        g = synthetic.make_graph(n_nodes=200, n_edges=1000, d_feat=D_FEAT, seed=8)
        csr = sampler.build_csr(g["src"], g["dst"], g["x"], g["y"] % cfg.n_classes)
        return sampler.sample_batch(csr, batch_nodes=8, fanout=(4, 3), seed=0, step=0)
    return {"x": rng.standard_normal((4, 10, D_FEAT)).astype(np.float32),
            "src": rng.integers(0, 10, (4, 20)).astype(np.int32),
            "dst": rng.integers(0, 10, (4, 20)).astype(np.int32),
            "labels": rng.integers(0, cfg.n_classes, 4).astype(np.int32)}


@pytest.mark.parametrize("kind", ["full_graph", "minibatch", "batched_graphs"])
def test_training_steps_follow_the_reference(kind):
    """Three AdamW steps at the cells' schedule (cosine 3e-4, warm-up 100)
    through `launch.train.make_train_step` over `build_gnn`'s loss, against
    the reference's loss + `adamw_update` (its cells' full-graph loss runs
    `make_sharded_full_graph` on a (1, 1) mesh): every step's loss and the
    parameters after the steps within REF_TOL (float32, reduced config); a
    second run gives the same bytes."""
    cfg = configs.reduced_config("pna")
    batch = _train_batches(kind, cfg)
    params = _ref_params(cfg, seed=2)
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    if kind == "full_graph":
        fwd = ref_gnn.make_sharded_full_graph(ref_mesh, ref_rules_for_mesh(ref_mesh), cfg)

        def ref_logits(p, b):
            return fwd(p, b["x"], b["src"], b["dst"])
    elif kind == "minibatch":
        def ref_logits(p, b):
            return ref_gnn.forward_sampled(p, b["seed_x"], b["hop1_x"], b["hop2_x"], cfg)
    else:
        def ref_logits(p, b):
            return ref_gnn.forward_batched_graphs(p, b["x"], b["src"], b["dst"], cfg)
    ref_lr = ref_adamw.cosine_schedule(3e-4, warmup=100, total=10_000)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rp = jax.tree.map(jnp.asarray, params)
    ro = ref_adamw.adamw_init(rp)
    want = []
    with jax.set_mesh(ref_mesh):
        step_ref = jax.jit(lambda p, o: (lambda lg: ref_adamw.adamw_update(
            lg[1], o, p, lr=ref_lr) + (lg[0],))(jax.value_and_grad(
                lambda q: ref_gnn.xent_loss(ref_logits(q, rb), rb["labels"]))(p)))
        for _ in range(3):
            rp, ro, _, loss = step_ref(rp, ro)
            want.append(float(loss))
    mesh = _cpu_mesh((1, 1), ("data", "model"))
    loss_fn = train_cli.build_gnn(cfg, kind, mesh, rules_for_mesh(mesh))
    step = train_cli.make_train_step(loss_fn, train_cli.GNN_LR)
    runs = []
    for _ in range(2):
        pp = convert.tree_from_numpy(params)
        po = adamw_lib.adamw_init(pp)
        got = []
        for _ in range(3):
            pp, po, _, metrics = step(pp, po, None, {k: _t(v) for k, v in batch.items()})
            got.append(float(metrics["loss"]))
        runs.append((got, pp))
    np.testing.assert_allclose(runs[0][0], want, rtol=REF_TOL["rtol"], atol=0)
    _close_trees(runs[0][1], jax.tree.map(np.asarray, rp), "params after 3 steps", REF_TOL)
    for (k, a), (_, b) in zip(_leaves(runs[0][1]), _leaves(runs[1][1])):
        assert a.detach().numpy().tobytes() == b.detach().numpy().tobytes(), k
    with pytest.raises(ValueError, match="shape kind"):
        train_cli.build_gnn(cfg, "nope")
