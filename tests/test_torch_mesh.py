"""The port's mesh pieces against the JAX reference, on the CPU.

The sharding vocabulary (`distributed.sharding`, `launch.mesh`,
`cluster.plan_for_mesh`), the cross-shard merges (`core.topk.merge_across*`,
`core.pipeline.merge_across`), the sharded statistics job, `search_mesh`,
`scan_shards` and the deprecated `search_sharded`.

The reference's merges run inside ``shard_map``; on a (2, 2) mesh they run in
a subprocess that fakes four host devices
(``--xla_force_host_platform_device_count=4``), as
``tests/test_serve_policy.py`` runs its sharded session, and return each
shard's state. The port's CPU meshes repeat the one CPU device. Tied scores
are everywhere in the inputs: the merges' tie-breaks are held to the
reference bit for bit. `search_mesh` must give the one-shard scan's bytes
at every mesh shape; against the reference's `search_mesh` (a 1x1 mesh, host
fold) scores agree within 1e-5 and ids except at a near-tie of the k-th
place (`_torch_parity`).
"""

import json
import os
import subprocess
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro import cluster as ref_cluster
from repro.cluster import plan as ref_plan
from repro.core import anchors as ref_anchors
from repro.distributed import sharding as ref_sharding
from repro_torch import cluster
from repro_torch.core import anchors, pipeline, scan, topk
from repro_torch.core.scoring import get_scorer
from repro_torch.data import synthetic
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import mesh as launch_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, CHUNK, VOCAB, N_DOCS = 16, 64, 512, 1024


def _cpu_mesh(shape, names) -> Mesh:
    arr = np.empty(shape, dtype=object)
    arr.fill(torch.device("cpu"))
    return Mesh(arr, names)


# ---------------------------------------------------------------------------
# the sharding vocabulary
# ---------------------------------------------------------------------------

MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")), ((4,), ("data",)),
          ((2, 2), ("x", "y")), ((2, 3, 2), ("a", "b", "c"))]


@pytest.mark.parametrize("shape,names", MESHES)
def test_rules_and_plans_match_the_reference(shape, names):
    mine = _cpu_mesh(shape, names)
    # the reference reads only a mesh's axis names and sizes
    ref = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    rules, ref_rules = sharding.rules_for_mesh(mine), ref_sharding.rules_for_mesh(ref)
    assert (rules.dp, rules.tp) == (ref_rules.dp, ref_rules.tp)
    assert rules.all_axes == ref_rules.all_axes and rules.scan_axes == ref_rules.scan_axes
    for name in ("dp", "tp", "scan", None):
        assert sharding.logical_to_spec(rules, name) == ref_sharding.logical_to_spec(
            ref_rules, name)
    assert rules.spec("dp", None, "tp") == tuple(ref_rules.spec("dp", None, "tp"))
    assert cluster.mesh_scan_axes(mine) == ref_plan.mesh_scan_axes(ref)
    n = 1
    for s in shape:
        n *= s
    n_docs = n * CHUNK * 2
    for axes in (None, names[:1]):
        got = cluster.plan_for_mesh(mine, n_docs, chunk_size=CHUNK, axis_names=axes)
        want = ref_plan.plan_for_mesh(ref, n_docs, chunk_size=CHUNK, axis_names=axes)
        assert got.describe() == want.describe()
    with pytest.raises(ValueError, match="not divisible|not a multiple"):
        cluster.plan_for_mesh(mine, n * CHUNK * 2 + 1, chunk_size=CHUNK)
    x = torch.ones(3)
    assert sharding.constrain(x, mine, rules, "dp") is x


def test_named_rules_and_the_mesh_helpers():
    assert sharding.RULES_SINGLE_POD == sharding.AxisRules(dp=("data",), tp="model")
    assert sharding.RULES_MULTI_POD == sharding.AxisRules(dp=("pod", "data"), tp="model")
    for a, b in ((sharding.RULES_SINGLE_POD, ref_sharding.RULES_SINGLE_POD),
                 (sharding.RULES_MULTI_POD, ref_sharding.RULES_MULTI_POD)):
        assert (a.dp, a.tp, a.scan_axes) == (b.dp, b.tp, b.scan_axes)
    # a single-axis mesh maps dp and tp to one axis: scan_axes counts it once
    one = sharding.rules_for_mesh(_cpu_mesh((4,), ("data",)))
    assert one.all_axes == ("data", "data") and one.scan_axes == ("data",)
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert [mesh.shard(i)[1] for i in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [mesh.shard(i, ("model", "data"))[1] for i in range(4)] == [
        (0, 0), (1, 0), (0, 1), (1, 1)]
    assert mesh.shard(1, ("data",)) == (torch.device("cpu"), (1, 0))
    with pytest.raises(IndexError):
        mesh.shard(4)
    with pytest.raises(ValueError, match="repeated"):
        Mesh(["cpu", "cpu"], ("a", "a"))
    with pytest.raises(ValueError, match="2-d device array"):
        Mesh([["cpu"]], ("a",))
    test = launch_mesh.make_test_mesh(2, 2, device="cpu")
    assert test.axis_names == ("data", "model") and test.shape == {"data": 2, "model": 2}
    assert {str(d) for d in test.devices.flat} == {"cpu"}
    prod = launch_mesh.make_production_mesh(devices=["cpu"] * 256)
    assert prod.shape == {"data": 16, "model": 16}
    multi = launch_mesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 600)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    with pytest.raises(ValueError, match="needs 256 devices, 4 given"):
        launch_mesh.make_production_mesh(devices=["cpu"] * 4)
    assert launch_mesh.visible_devices("cpu") == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# the cross-shard merges against the reference on a faked 4-device mesh
# ---------------------------------------------------------------------------

_MERGE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.core import anchors, pipeline, topk

inp = np.load(sys.argv[1])
scores, ids = inp["scores"], inp["ids"]  # [4, n_q, k], shards row-major over (data, model)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Explicit,) * 2)
ALL = ("data", "model")
cases = {
    "lex_all": lambda s: topk.merge_across_lex(s, ALL),
    "lex_model": lambda s: topk.merge_across_lex(s, "model"),
    "staged_all": lambda s: topk.merge_across(s, ALL),
    "staged_data": lambda s: topk.merge_across(s, "data"),
    "tree_all": lambda s: topk.merge_across(s, ALL, method="tree"),
    "tree_model": lambda s: topk.merge_across_tree(s, "model"),
    "fold_all": lambda s: pipeline.merge_across(s, ALL, topk.merge),
}
out = {}
for name, fn in cases.items():
    def body(sc, ix, fn=fn):
        st = fn(topk.TopKState(sc[0], ix[0]))
        return st.scores[None], st.ids[None]
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(ALL), P(ALL)),
                          out_specs=(P(ALL), P(ALL)), check_rep=False))
    s, i = f(jnp.asarray(scores), jnp.asarray(ids))
    out[name + "_scores"], out[name + "_ids"] = np.asarray(s), np.asarray(i)
toks, lens = inp["tokens"], inp["lengths"]
stats_fn = jax.jit(shard_map(
    lambda t, l: tuple(anchors.collection_stats(t, l, int(inp["vocab"]), chunk_size=64,
                                                axis_name=ALL)),
    mesh=mesh, in_specs=(P(ALL), P(ALL)), out_specs=P(), check_rep=False))
for name, x in zip(("cf", "df", "total_terms", "n_docs", "avg_doc_len"),
                   stats_fn(jnp.asarray(toks), jnp.asarray(lens))):
    out["stats_" + name] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("ok")
"""


def _tied_states(seed=0, n_q=6, k=8):
    """Four shards' (score desc, id asc) lists: scores from a few values, so
    ties fall within and across shards, and empty (-inf, -1) tails."""
    rng = np.random.default_rng(seed)
    scores = np.full((4, n_q, k), -np.inf, np.float32)
    ids = np.full((4, n_q, k), -1, np.int32)
    for s in range(4):
        for q in range(n_q):
            n = int(rng.integers(k // 2, k + 1))
            sc = rng.choice(np.array([0.0, 0.5, 1.0, 1.5, 2.0], np.float32), size=n)
            ix = rng.choice(np.arange(s * 100, s * 100 + 60), size=n, replace=False)
            order = np.lexsort((ix, -sc))
            scores[s, q, :n], ids[s, q, :n] = sc[order], ix[order]
    return scores, ids


@pytest.fixture(scope="module")
def reference_merges(tmp_path_factory):
    d = tmp_path_factory.mktemp("merges")
    scores, ids = _tied_states()
    corpus = synthetic.make_corpus(n_docs=N_DOCS, vocab=VOCAB, max_len=24, seed=3)
    np.savez(d / "in.npz", scores=scores, ids=ids, tokens=corpus.tokens,
             lengths=corpus.lengths, vocab=VOCAB)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _MERGE_SCRIPT, str(d / "in.npz"),
                           str(d / "out.npz")], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz")), (scores, ids), corpus


def _port_states(scores, ids):
    states = [topk.TopKState(torch.tensor(scores[s]), torch.tensor(ids[s])) for s in range(4)]
    return topk.state_array(states, (2, 2))


@pytest.mark.parametrize("case", ["lex_all", "lex_model", "staged_all", "staged_data",
                                  "tree_all", "tree_model", "fold_all"])
def test_cross_shard_merges_are_the_references_bits(reference_merges, case):
    want, (scores, ids), _ = reference_merges
    states, axes = _port_states(scores, ids), ("data", "model")
    got = {
        "lex_all": lambda: topk.merge_across_lex(states, axes, axes=axes),
        "lex_model": lambda: topk.merge_across_lex(states, "model", axes=axes),
        "staged_all": lambda: topk.merge_across(states, axes, axes=axes),
        "staged_data": lambda: topk.merge_across(states, "data", axes=axes),
        "tree_all": lambda: topk.merge_across(states, axes, axes=axes, method="tree"),
        "tree_model": lambda: topk.merge_across_tree(states, "model", axes=axes),
        "fold_all": lambda: pipeline.merge_across(states, axes, topk.merge, axes=axes),
    }[case]()
    assert got.shape == (2, 2)
    for s, idx in enumerate(np.ndindex(2, 2)):  # each shard's state, in mesh order
        assert got[idx].scores.numpy().tobytes() == want[case + "_scores"][s].tobytes(), (
            case, idx)
        assert got[idx].ids.numpy().tobytes() == want[case + "_ids"][s].tobytes(), (case, idx)
    if case == "lex_all":  # the lexicographic reduce is the host loop's reduce_lex
        flat = topk.reduce_lex([states[i] for i in np.ndindex(2, 2)])
        assert torch.equal(got[0, 0].ids, flat.ids)


def test_merges_refuse_what_they_cannot_take():
    scores, ids = _tied_states()
    states = topk.state_array(
        [topk.TopKState(torch.tensor(scores[s]), torch.tensor(ids[s])) for s in range(3)])
    with pytest.raises(ValueError, match="power-of-two"):
        topk.merge_across_tree(states, "x", axes=("x",))
    with pytest.raises(ValueError, match="not one of"):
        topk.merge_across_lex(states, "y", axes=("x",))
    with pytest.raises(ValueError, match="unknown merge method"):
        topk.merge_across(states, "x", axes=("x",), method="ring")
    with pytest.raises(ValueError, match="not one of"):
        pipeline.merge_across(states, "y", axes=("x",))


def test_sharded_statistics_are_the_references_exactly(reference_merges):
    want, _, corpus = reference_merges
    toks, lens = torch.tensor(corpus.tokens), torch.tensor(corpus.lengths)
    mesh = _cpu_mesh((2, 2), ("data", "model"))
    sharded = anchors.collection_stats(toks, lens, VOCAB, chunk_size=64, mesh=mesh)
    whole = anchors.collection_stats(toks, lens, VOCAB, chunk_size=64)
    ref = ref_anchors.collection_stats(jnp.asarray(corpus.tokens), jnp.asarray(corpus.lengths),
                                       VOCAB, chunk_size=64)
    for name in ("cf", "df", "total_terms", "n_docs", "avg_doc_len"):
        got = getattr(sharded, name).numpy()
        assert got.dtype == want["stats_" + name].dtype, name
        assert got.tobytes() == want["stats_" + name].tobytes(), name
        assert got.tobytes() == getattr(whole, name).numpy().tobytes(), name
        assert got.tobytes() == np.asarray(getattr(ref, name)).tobytes(), name
    # one axis of the mesh, and the additive merge's psum alone
    by_data = anchors.collection_stats(toks, lens, VOCAB, chunk_size=64, mesh=mesh,
                                       axis_name="data")
    assert torch.equal(by_data.df, whole.df)
    with pytest.raises(ValueError, match="equal shards"):
        anchors.collection_stats(toks[:960], lens[:960], VOCAB, chunk_size=64,
                                 mesh=_cpu_mesh((7,), ("data",)))


# ---------------------------------------------------------------------------
# search_mesh, scan_shards, search_sharded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collection():
    corpus = synthetic.make_corpus(n_docs=N_DOCS, vocab=VOCAB, max_len=24, seed=1)
    docs = (torch.tensor(corpus.tokens), torch.tensor(corpus.lengths))
    stats = anchors.collection_stats(*docs, VOCAB, chunk_size=CHUNK)
    queries = torch.tensor(synthetic.make_queries(corpus, n_queries=12, seed=2))
    grid = (get_scorer("ql_lm"), get_scorer("bm25"), get_scorer("tfidf"))
    return corpus, docs, stats, queries, grid


MESH_SHAPES = [((1,), ("data",)), ((2,), ("data",)), ((4,), ("data",)),
               ((2, 2), ("data", "model")), ((1, 1), ("data", "model"))]


@pytest.mark.parametrize("shape,names", MESH_SHAPES)
def test_search_mesh_is_the_one_shard_scan_bit_for_bit(collection, shape, names):
    _, docs, stats, queries, grid = collection
    want = scan.search_local_multi(queries, docs, grid, k=K, chunk_size=CHUNK, stats=stats)
    mesh = _cpu_mesh(shape, names)
    fn = cluster.search_mesh(mesh, queries, docs, grid, k=K, chunk_size=CHUNK, stats=stats)
    got = fn(queries, docs, stats)
    assert got.scores.shape == (len(grid), queries.shape[0], K)
    assert got.scores.numpy().tobytes() == want.scores.numpy().tobytes()
    assert got.ids.numpy().tobytes() == want.ids.numpy().tobytes()
    # a dense grid through the same map (the scorer's row map followed)
    vecs = torch.tensor(np.random.default_rng(5).standard_normal((N_DOCS, 16)).astype(np.float32))
    qv = vecs[:4] + 0.25
    dense = (get_scorer("dense_cosine"),)
    want = scan.search_local_multi(qv, vecs, dense, k=K, chunk_size=CHUNK)
    got = cluster.search_mesh(mesh, qv, vecs, dense, k=K, chunk_size=CHUNK)(qv, vecs)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)


def test_search_mesh_on_a_slice_of_the_mesh(collection):
    _, docs, stats, queries, grid = collection
    want = scan.search_local_multi(queries, docs, grid, k=K, chunk_size=CHUNK, stats=stats)
    mesh = _cpu_mesh((2, 2), ("data", "model"))
    fn = cluster.search_mesh(mesh, queries, docs, grid, k=K, chunk_size=CHUNK,
                             axis_names=("model",))
    assert fn.per_shard == N_DOCS // 2 and fn.sizes == (2,)
    got = fn(queries, docs, stats)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    with pytest.raises(ValueError, match="not divisible"):
        cluster.search_mesh(_cpu_mesh((3,), ("data",)), queries, docs, grid, k=K,
                            chunk_size=CHUNK)


def test_search_mesh_against_the_reference(collection):
    corpus, docs, stats, queries, grid = collection
    mesh = _cpu_mesh((4,), ("data",))
    got = cluster.search_mesh(mesh, queries, docs, grid, k=K, chunk_size=CHUNK)(
        queries, docs, stats)
    from repro.core.scoring import get_scorer as ref_get_scorer

    ref_grid = tuple(ref_get_scorer(s.name) for s in grid)
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jdocs = (jnp.asarray(corpus.tokens), jnp.asarray(corpus.lengths))
    jstats = ref_anchors.collection_stats(*jdocs, VOCAB, chunk_size=CHUNK)
    jq = jnp.asarray(queries.numpy())
    with jax.set_mesh(ref_mesh):
        fn = ref_cluster.search_mesh(ref_mesh, jq, jdocs, ref_grid, k=K + 8, chunk_size=CHUNK,
                                     stats=jstats)
        want = fn(jq, jdocs, jstats)
    assert_rankings_close(got.scores.numpy(), got.ids.numpy(), np.asarray(want.scores),
                          np.asarray(want.ids), what="search_mesh vs reference")


def test_scan_shards_places_shards_on_devices(collection):
    _, docs, stats, queries, grid = collection
    want = scan.search_local_multi(queries, docs, grid, k=K, chunk_size=CHUNK, stats=stats)
    plan = cluster.plan_shards(N_DOCS, n_shards=4, chunk_size=CHUNK)
    for devices in (None, ["cpu"], [torch.device("cpu")] * 3):
        got = cluster.scan_shards(plan, queries, docs, grid, k=K, stats=stats, devices=devices)
        assert got.scores.numpy().tobytes() == want.scores.numpy().tobytes()
        assert got.ids.numpy().tobytes() == want.ids.numpy().tobytes()
    mesh_plan = cluster.plan_for_mesh(_cpu_mesh((2, 2), ("data", "model")), N_DOCS,
                                      chunk_size=CHUNK)
    got = cluster.scan_shards(mesh_plan, queries, docs, grid, k=K, stats=stats)
    assert torch.equal(got.ids, want.ids)
    with pytest.raises(ValueError, match="plan covers"):
        cluster.scan_shards(plan, queries, tuple(x[:512] for x in docs), grid, k=K)


def test_search_sharded_warns_and_squeezes(collection):
    _, docs, stats, queries, grid = collection
    mesh = _cpu_mesh((2,), ("data",))
    with pytest.warns(DeprecationWarning, match="search_sharded is deprecated"):
        fn = scan.search_sharded(mesh, ("data",), queries, docs, grid[1], k=K,
                                 chunk_size=CHUNK, stats=stats, tree_merge=True)
    got = fn(queries, docs, stats)
    want = scan.search_local(queries, docs, grid[1], k=K, chunk_size=CHUNK, stats=stats)
    assert got.scores.shape == (queries.shape[0], K)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    # the reference's warning, word for word
    from repro.core import scan as ref_scan
    from repro.core.scoring import get_scorer as ref_get_scorer

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref_scan.search_sharded(jax.make_mesh((1,), ("data",)), ("data",), None,
                                (jnp.zeros((64, 4), jnp.int32), jnp.zeros(64, jnp.int32)),
                                ref_get_scorer("bm25"), k=K, chunk_size=CHUNK)
        scan.search_sharded(mesh, ("data",), queries, docs, grid[1], k=K, chunk_size=CHUNK)
    texts = [str(w.message) for w in caught if w.category is DeprecationWarning]
    assert len(texts) == 2 and texts[0] == texts[1]


def test_mesh_entry_points_refuse_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_mesh.make_test_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_mesh.visible_devices()
    assert json.dumps(str(launch_mesh.make_test_mesh(device="cpu")))
