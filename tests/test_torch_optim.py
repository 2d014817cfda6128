"""The port's optimizer and gradient compression against the JAX
reference's own functions, on the CPU, from the same numpy inputs.

AdamW: one step of float32 and bfloat16 parameters, and a 5-step run under
`cosine_schedule`; parameters, both moments and the norm agree within
``TOL`` (rtol 1e-6, atol 1e-6 on values of O(1): ``b1 ** step`` and the
schedule's ``cos`` are float32 on both sides, and the global norm's sum and
the sign compressor's mean |g| may round in another order), bfloat16 parameters within one bfloat16 ulp. The schedule itself
agrees within 1e-9 absolute.

Compression: the reference's compressors run inside ``shard_map`` over its
``data`` axis, on one device here and on four faked host devices in a
subprocess (``--xla_force_host_platform_device_count=4``, as
``tests/test_torch_mesh.py`` runs its merges); the port takes the shards'
trees as a list. Residuals and reduced gradients agree within ``TOL``; the
top-k's kept coordinates are held to the reference's ranking of |g + r| by
the near-tie rule (``tests/_torch_parity.py``): ``lax.top_k`` and the
port's stable sort may order a near-tie at the cut differently.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from _torch_parity import assert_rankings_close
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch import convert
from repro_torch.optim import adamw, compress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"rtol": 1e-6, "atol": 1e-6}


def _tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(11,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(3, 2, 4)) * scale).astype(np.float32)}}


def _np_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _np_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def _close(got, want, **tol):
    for (name, g), (_, w) in zip(_np_leaves(jax.tree.map(np.asarray, got)
                                            if not isinstance(got, dict) else
                                            _to_np(got)), _np_leaves(want)):
        np.testing.assert_allclose(g.astype(np.float64), np.asarray(w, np.float64),
                                   err_msg=name, **(tol or TOL))


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_adamw_step_is_the_references(dtype):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, scale=3.0)
    rp = jax.tree.map(lambda x: jnp.asarray(x, dtype), params)
    rg = jax.tree.map(lambda x: jnp.asarray(x, dtype), grads)
    want_p, want_o, want_n = ref_adamw.adamw_update(rg, ref_adamw.adamw_init(rp), rp, lr=3e-3)
    pp = convert.params_from_numpy(jax.tree.map(np.asarray, rp))
    pg = convert.params_from_numpy(jax.tree.map(np.asarray, rg))
    got_p, got_o, got_n = adamw.adamw_update(pg, adamw.adamw_init(pp), pp, lr=3e-3)
    assert got_p is pp  # updated in place
    np.testing.assert_allclose(float(got_n), float(want_n), **TOL)
    assert int(got_o.step) == int(want_o.step) == 1 and got_o.step.dtype == torch.int32
    tol = TOL if dtype == "float32" else {"rtol": 2 ** -7, "atol": 0}
    _close(got_p, jax.tree.map(lambda x: np.asarray(x, np.float32), want_p), **tol)
    _close(got_o.m, want_o.m)
    _close(got_o.v, want_o.v)


def test_five_steps_under_the_cosine_schedule():
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng)
    ref_lr, lr = ref_adamw.cosine_schedule(1e-2, 2, 5), adamw.cosine_schedule(1e-2, 2, 5)
    for step in range(8):
        np.testing.assert_allclose(float(lr(torch.tensor(step, dtype=torch.int32))),
                                   float(ref_lr(jnp.int32(step))), rtol=0, atol=1e-9)
    rp, ro = jax.tree.map(jnp.asarray, params), None
    ro = ref_adamw.adamw_init(rp)
    pp = convert.params_from_numpy(params)
    po = adamw.adamw_init(pp)
    for i in range(5):
        g = jax.tree.map(lambda x: x * (i + 1) * 0.5, grads)
        rp, ro, rn = ref_adamw.adamw_update(jax.tree.map(jnp.asarray, g), ro, rp, lr=ref_lr)
        pp, po, pn = adamw.adamw_update(convert.params_from_numpy(g), po, pp, lr=lr)
        np.testing.assert_allclose(float(pn), float(rn), **TOL)
    assert int(po.step) == 5
    _close(pp, rp)
    _close(po.m, ro.m)
    _close(po.v, ro.v)
    carried = convert.adamw_from_numpy(jax.tree.map(np.asarray, ro))
    assert int(carried.step) == 5 and carried.step.dtype == torch.int32
    _close(carried.m, ro.m, rtol=0, atol=0)


def test_clipping_and_the_state_helpers():
    rng = np.random.default_rng(2)
    grads = _tree(rng, scale=5.0)
    want, want_n = ref_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    got, got_n = adamw.clip_by_global_norm(convert.params_from_numpy(grads), 1.0)
    np.testing.assert_allclose(float(got_n), float(want_n), **TOL)
    _close(got, want)
    shapes = adamw.adamw_state_shapes(convert.params_from_numpy(grads), torch.bfloat16)
    assert shapes.m["b"]["d"].shape == (3, 2, 4) and shapes.v["a"].dtype == torch.bfloat16
    assert shapes.step.dtype == torch.int32
    from repro_torch.distributed.sharding import RULES_SINGLE_POD
    specs = adamw.opt_state_specs({"a": (None, None)}, {"a": shapes.m["a"]}, RULES_SINGLE_POD,
                                  7)  # ZeRO-1: the first dim dividing dp goes over it
    assert specs.step == () and specs.m == {"a": (None, "data")} == specs.v


def _kept(sparse, acc, k):
    """The port's kept coordinates as a ranking by |acc| (desc, index asc)."""
    idx = np.flatnonzero(sparse.reshape(-1))
    mag = np.abs(acc.reshape(-1))[idx]
    order = np.lexsort((idx, -mag))
    return mag[order][:k], idx[order][:k]


def _reference_ranking(acc, depth):
    mag = np.abs(acc.reshape(-1))
    order = np.lexsort((np.arange(mag.size), -mag))[:depth]
    return mag[order], order


def _ref_allreduce(kind, grads, residual, n_shards):
    """The reference's compressor under shard_map over ``data``: grads and
    residual stacked [n_shards, ...], one block a shard."""
    mesh = jax.make_mesh((n_shards,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    fn = {"topk": lambda g, r: ref_compress.topk_allreduce(
        g, ref_compress.ErrorFeedbackState(r), ("data",), frac=0.2),
        "sign": lambda g, r: ref_compress.sign_allreduce(
            g, ref_compress.ErrorFeedbackState(r), ("data",))}[kind]

    def body(g, r):
        out, ef = fn(jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], r))
        return jax.tree.map(lambda x: x[None], out), jax.tree.map(lambda x: x[None],
                                                                  ef.residual)

    spec = jax.tree.map(lambda _: P("data"), grads)
    f = shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                  check_rep=False)
    out, res = f(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, residual))
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("kind", ["topk", "sign"])
def test_compressors_on_one_shard(kind):
    rng = np.random.default_rng(3)
    grads, residual = _tree(rng), _tree(rng, scale=0.1)
    want, want_r = _ref_allreduce(kind, jax.tree.map(lambda x: x[None], grads),
                                  jax.tree.map(lambda x: x[None], residual), 1)
    fn = {"topk": lambda g, e: compress.topk_allreduce(g, e, ("data",), frac=0.2),
          "sign": lambda g, e: compress.sign_allreduce(g, e, ("data",))}[kind]
    ef = compress.ErrorFeedbackState(convert.params_from_numpy(residual))
    got, got_ef = fn(convert.params_from_numpy(grads), ef)
    assert isinstance(got_ef, compress.ErrorFeedbackState)
    for (name, g), (_, w), (_, r), (_, gr), (_, a), (_, b) in zip(
            _np_leaves(_to_np(got)), _np_leaves(want), _np_leaves(want_r),
            _np_leaves(_to_np(got_ef.residual)), _np_leaves(grads), _np_leaves(residual)):
        if kind == "topk":
            acc = a + b
            k = max(1, int(acc.size * 0.2))
            got_s, got_i = _kept(g, acc, k)
            want_s, want_i = _reference_ranking(acc, k + 8)
            assert_rankings_close(got_s, got_i, want_s, want_i, what=name)
        np.testing.assert_allclose(g, w[0], err_msg=name, **TOL)
        np.testing.assert_allclose(gr, r[0], err_msg=name, **TOL)


def test_topk_keeps_the_lower_index_on_a_tie():
    g = torch.tensor([1.0, -3.0, 3.0, 2.0, -3.0, 0.5])
    ef = compress.ErrorFeedbackState(torch.zeros(6))
    out, res = compress.topk_allreduce(g, ef, "data", frac=0.5)
    assert out.tolist() == [0.0, -3.0, 3.0, 0.0, -3.0, 0.0]
    out, _ = compress.topk_allreduce(g, ef, "data", frac=1 / 3)
    assert out.tolist() == [0.0, -3.0, 3.0, 0.0, 0.0, 0.0]  # the third 3 is cut


_FOUR_SHARDS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[3])
import numpy as np
import jax
import test_torch_optim as t

inp = dict(np.load(sys.argv[1]))
grads = {"a": inp["a"], "b": {"c": inp["c"], "d": inp["d"]}}
resid = {"a": inp["ra"], "b": {"c": inp["rc"], "d": inp["rd"]}}
out = {}
for kind in ("topk", "sign"):
    g, r = t._ref_allreduce(kind, grads, resid, 4)
    for name, x in t._np_leaves(g):
        out[kind + name.replace("/", "_")] = x
    for name, x in t._np_leaves(r):
        out[kind + "_res" + name.replace("/", "_")] = x
np.savez(sys.argv[2], **out)
print("ok")
"""


def test_compressors_on_a_faked_four_shard_mesh(tmp_path):
    rng = np.random.default_rng(4)
    shards = [(_tree(rng), _tree(rng, scale=0.1)) for _ in range(4)]
    stack = lambda i, key: np.stack([dict(_np_leaves(s[i]))[key] for s in shards])  # noqa: E731
    np.savez(tmp_path / "in.npz", **{n: stack(0, k) for n, k in
                                     (("a", "/a"), ("c", "/b/c"), ("d", "/b/d"))},
             **{"r" + n: stack(1, k) for n, k in (("a", "/a"), ("c", "/b/c"), ("d", "/b/d"))})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _FOUR_SHARDS, str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz"), os.path.join(ROOT, "tests")],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))
    for kind in ("topk", "sign"):
        fn = {"topk": lambda g, e: compress.topk_allreduce(g, e, ("data",), frac=0.2),
              "sign": lambda g, e: compress.sign_allreduce(g, e, ("data",))}[kind]
        got, efs = fn([convert.params_from_numpy(g) for g, _ in shards],
                      [compress.ErrorFeedbackState(convert.params_from_numpy(r))
                       for _, r in shards])
        assert len(got) == len(efs) == 4
        for s in range(4):
            for name, x in _np_leaves(_to_np(got[s])):
                np.testing.assert_allclose(x, want[kind + name.replace("/", "_")][s],
                                           err_msg=f"{kind} shard {s} {name}", **TOL)
            for name, x in _np_leaves(_to_np(efs[s].residual)):
                np.testing.assert_allclose(x, want[kind + "_res" + name.replace("/", "_")][s],
                                           err_msg=f"{kind} residual {s} {name}", **TOL)
        # every shard holds the same mean
        for s in range(1, 4):
            assert all(np.array_equal(a, b) for (_, a), (_, b) in
                       zip(_np_leaves(_to_np(got[0])), _np_leaves(_to_np(got[s]))))
    carried = convert.ef_from_numpy(ref_compress.ef_init({"a": jnp.zeros((2, 3))}))
    assert carried.residual["a"].dtype == torch.float32
