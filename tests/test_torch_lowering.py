"""The port's lowering tools against the reference's: the cells' registry
and stand-ins (`configs.all_cells`, ``input_specs``), the sharding specs,
`launch.roofline`'s model FLOPs and collective times, and
`launch.opcount`'s counts against `repro.launch.hloparse` on reduced cells
lowered by XLA on one CPU device.

Tolerances: registry, shapes, dtypes, specs and model FLOPs are equal; a
collective's time differs from the reference's only by the link rate (the
reference's one 50 GB/s link against NVLink's 450 GB/s within 8 cards, the
same 50 GB/s beyond); the counted product FLOPs of a reduced cell agree
with the HLO parse's within 1e-3 relative (measured: dcn-v2's differ by
2,048 of 5.9e7, the GNN's are equal).
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sharding
from repro.launch import cells as ref_cells
from repro.launch import hloparse
from repro.launch import roofline as ref_roofline
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tfm
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.launch import cells, dryrun, opcount, roofline
from repro_torch.launch import train as train_lib
from repro_torch.models import gnn, recsys, segment
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

CELLS = ref_configs.all_cells(include_mirex=True)
ARCHS = ref_configs.ARCH_IDS
RULES = {"single_pod": (ref_sharding.RULES_SINGLE_POD, sharding.RULES_SINGLE_POD),
         "multi_pod": (ref_sharding.RULES_MULTI_POD, sharding.RULES_MULTI_POD)}
FLOP_RTOL = 1e-3


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _specs(tree):
    """The reference's PartitionSpec tree as the port writes it (tuples)."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # AdamWState
        return type(tree)(*(_specs(t) for t in tree))
    return tuple(tree)


def test_all_cells_equal_the_references():
    assert configs.all_cells() == ref_configs.all_cells()
    assert configs.all_cells(include_mirex=True) == CELLS
    assert len(configs.all_cells()) == 40 and len(CELLS) == 43


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_references(arch, shape):
    want = ref_configs.input_specs(arch, shape)
    got = configs.input_specs(arch, shape)
    assert sorted(got) == sorted(want)
    for k, sds in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == sds.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == jnp.dtype(sds.dtype).name, k


def _opt_specs_pair(arch, rules_name):
    ref_rules, rules = RULES[rules_name]
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    fam = configs.family(arch)
    dp = 32 if rules_name == "multi_pod" else 16
    if fam == "lm":
        want_p = ref_tfm.param_specs(ref_cfg, ref_rules, 16)
        got_p = tfm.param_specs(cfg, rules, 16)
        ref_shapes, shapes = ref_tfm.param_shapes(ref_cfg), tfm.param_shapes(cfg)
    elif fam == "recsys":
        want_p, got_p = ref_recsys.param_specs(ref_cfg, ref_rules), recsys.param_specs(cfg, rules)
        ref_shapes, shapes = ref_recsys.param_shapes(ref_cfg), recsys.param_shapes(cfg)
    elif fam == "gnn":
        want_p, got_p = ref_gnn.param_specs(ref_cfg, ref_rules), gnn.param_specs(cfg, rules)
        ref_shapes, shapes = ref_gnn.param_shapes(ref_cfg, 1), gnn.param_shapes(cfg, 1)
    else:
        return None
    want_o = ref_adamw.opt_state_specs(want_p, ref_shapes, ref_rules, dp)
    got_o = adamw.opt_state_specs(got_p, shapes, rules, dp)
    return (_specs(want_p), got_p), (_specs(want_o), got_o)


@pytest.mark.parametrize("rules_name", sorted(RULES))
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "mirex"])
def test_param_and_opt_state_specs_equal_the_references(arch, rules_name):
    (want_p, got_p), (want_o, got_o) = _opt_specs_pair(arch, rules_name)
    assert got_p == want_p
    assert got_o.step == () == want_o.step
    assert got_o.m == want_o.m and got_o.v == want_o.v


def test_cache_specs_equal_the_references():
    for name, (ref_rules, rules) in RULES.items():
        cfg = configs.get_config("gemma2-2b")
        for batch in (1, 128):
            want = _specs(ref_tfm.cache_specs(ref_configs.get_config("gemma2-2b"), ref_rules,
                                              batch))
            assert tfm.cache_specs(cfg, rules, batch) == want, (name, batch)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_references(arch, shape):
    for n in (1, 256, 512):
        assert roofline.model_flops(arch, shape, n) == ref_roofline.model_flops(arch, shape, n)


@pytest.mark.parametrize("group", (2, 8, 16, 256, 512))
def test_collective_time_is_the_references_at_this_cards_links(group):
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    hlo = {"collective_bytes": {k: 1e8 * (i + 1) for i, k in enumerate(kinds)},
           "collective_group_sizes": dict.fromkeys(kinds, group)}
    want = ref_roofline.collective_time(hlo) * ref_roofline.LINK_BW / roofline.link_bw(group)
    assert math.isclose(roofline.collective_time(hlo), want, rel_tol=1e-12)
    if group > roofline.NVLINK_GROUP:  # one 50 GB/s NIC a card: the reference's own link
        assert roofline.collective_time(hlo) == ref_roofline.collective_time(hlo)
    one = {"collective_bytes": {"all-reduce": 1e9}, "collective_group_sizes": {}}
    want = ref_roofline.collective_time(one) * ref_roofline.LINK_BW / roofline.NVLINK_BW
    assert math.isclose(roofline.collective_time(one), want)


# ---------------------------------------------------------------------------
# the op counter against the reference's HLO parse, on reduced cells
# ---------------------------------------------------------------------------

def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)),
                                              device="meta"), tree)


def _count(step, args, n_devices=1):
    with opcount.OpCounter(n_devices) as c:
        c.track(args)
        step(*args)
    return c.result()


def _hlo_flops(mesh, step, args):
    with jax.set_mesh(mesh):
        txt = jax.jit(step).lower(*args).compile().as_text()
    return hloparse.analyze_hlo(txt)["flops"]


def test_counted_flops_of_a_reduced_recsys_step_match_the_hlo_parse(mesh):
    ref_cfg, cfg = ref_configs.reduced_config("dcn-v2"), configs.reduced_config("dcn-v2")
    b = 64
    batch = {"sparse_ids": jax.ShapeDtypeStruct((b, cfg.n_sparse), jnp.int32),
             "dense": jax.ShapeDtypeStruct((b, cfg.n_dense), jnp.float32),
             "labels": jax.ShapeDtypeStruct((b,), jnp.float32)}

    def ref_loss(p, bb):
        loss = ref_recsys.train_logits(p, bb, ref_cfg)
        return loss, {"loss": loss}

    def loss(p, bb):
        out = recsys.train_logits(p, bb, cfg)
        return out, {"loss": out}

    ref_shapes = ref_recsys.param_shapes(ref_cfg)
    want = _hlo_flops(mesh, ref_cells.make_train_step(ref_loss),
                      (ref_shapes, ref_adamw.adamw_state_shapes(ref_shapes), batch))
    shapes = recsys.param_shapes(cfg)
    got = _count(cells.make_train_step(loss), (cells.abstract(shapes),
                 cells.abstract(adamw.adamw_state_shapes(shapes)), _meta(batch)))
    assert want > 0 and math.isclose(got["flops"], want, rel_tol=FLOP_RTOL), (got["flops"], want)
    assert got["flops_by_class"]["f32"] == got["flops"]


def test_counted_flops_of_a_reduced_gnn_step_match_the_hlo_parse(mesh):
    ref_cfg = dataclasses.replace(ref_configs.reduced_config("pna"), n_classes=5)
    cfg = dataclasses.replace(configs.reduced_config("pna"), n_classes=5)
    b, k1, k2, f = 32, 5, 4, 11
    batch = {"seed_x": jax.ShapeDtypeStruct((b, f), jnp.float32),
             "hop1_x": jax.ShapeDtypeStruct((b, k1, f), jnp.float32),
             "hop2_x": jax.ShapeDtypeStruct((b, k1, k2, f), jnp.float32),
             "labels": jax.ShapeDtypeStruct((b,), jnp.int32)}

    def ref_loss(p, bb):
        loss = ref_gnn.xent_loss(ref_gnn.forward_sampled(
            p, bb["seed_x"], bb["hop1_x"], bb["hop2_x"], ref_cfg), bb["labels"])
        return loss, {"loss": loss}

    ref_shapes = ref_gnn.param_shapes(ref_cfg, f)
    want = _hlo_flops(mesh, ref_cells.make_train_step(ref_loss),
                      (ref_shapes, ref_adamw.adamw_state_shapes(ref_shapes), batch))
    shapes = gnn.param_shapes(cfg, f)
    got = _count(cells.make_train_step(train_lib.build_gnn(cfg, "minibatch")),
                 (cells.abstract(shapes), cells.abstract(adamw.adamw_state_shapes(shapes)),
                  _meta(batch)))
    assert want > 0 and math.isclose(got["flops"], want, rel_tol=FLOP_RTOL), (got["flops"], want)


def _real(tree):
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(_real(t) for t in tree))
    if isinstance(tree, dict):
        return {k: _real(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype)


@pytest.mark.parametrize("arch", ("gemma2-2b", "dcn-v2"))
def test_a_reduced_cells_meta_count_is_its_count_on_cpu_tensors(arch):
    cfg = configs.reduced_config(arch)
    if arch == "gemma2-2b":
        step = cells.make_train_step(tfm.make_loss_fn(cfg, chunk=16))
        shapes = tfm.param_shapes(cfg)
        batch = {"tokens": torch.ones(2, 32, dtype=torch.int32),
                 "labels": torch.ones(2, 32, dtype=torch.int32)}
        params = tfm.init_params(cfg)
    else:
        def loss(p, bb):
            out = recsys.train_logits(p, bb, cfg)
            return out, {"loss": out}

        step = cells.make_train_step(loss)
        shapes = recsys.param_shapes(cfg)
        batch = {"sparse_ids": torch.ones(16, cfg.n_sparse, dtype=torch.int32),
                 "dense": torch.ones(16, cfg.n_dense), "labels": torch.ones(16)}
        params = recsys.init_params(cfg)
    on_meta = _count(step, (cells.abstract(shapes), cells.abstract(
        adamw.adamw_state_shapes(shapes)), {k: v.to("meta") for k, v in batch.items()}))
    on_cpu = _count(step, (params, adamw.adamw_init(params), batch))
    for key in ("flops", "flops_by_class", "bytes_accessed", "peak_bytes", "kernels"):
        assert on_meta[key] == on_cpu[key], key
    assert on_meta["flops"] > 0 and on_meta["peak_bytes"] > 0
    if arch == "gemma2-2b":  # 2 layers, forward and remat's recompute
        assert on_meta["kernels"]["flash_attention"]["calls"] == 4


def _flat_mesh(n):
    arr = np.empty((n,), dtype=object)
    arr.fill(torch.device("meta"))
    return Mesh(arr, ("data",))


def test_gnn_full_graph_per_device_flops_split_over_a_four_shard_mesh():
    """The (4,) mesh's per-device FLOPs are the (1,) mesh's ÷ 4, up to the
    dst-bucketed partition's 1.3× allowance of ogb_products: the excess is
    the source products ``h @ w_src``, which each shard takes over the
    whole replicated ``h`` (node-level products, `models.gnn`)."""
    counts = {}
    for n in (1, 4):
        cell = cells.build_cell("pna", "ogb_products", _flat_mesh(n))
        counts[n] = _count(cell.fn, cell.abstract_inputs, n_devices=n)
    allowance = (configs.shapes_for("pna")["ogb_products"].dims["n_edges_padded"]
                 / configs.shapes_for("pna")["ogb_products"].dims["n_edges"])
    ratio = counts[4]["flops"] / (counts[1]["flops"] / 4)
    assert 1.0 <= ratio <= allowance, ratio
    assert counts[4]["collective_group_sizes"] == {"all-gather": 4, "reduce-scatter": 4}
    assert not counts[1]["collective_bytes"]


# ---------------------------------------------------------------------------
# the kernels and the data-dependent paths on meta
# ---------------------------------------------------------------------------

def test_kernel_wrappers_on_meta_return_shapes_and_charge_their_costs():
    from repro_torch.kernels import flash_attn, flash_decode, lexical_scan, score_topk
    m = "meta"
    bf = torch.bfloat16
    q, k = torch.empty(2, 64, 4, 16, dtype=bf, device=m), torch.empty(2, 64, 2, 16, dtype=bf,
                                                                       device=m)
    qd = torch.empty(2, 4, 16, dtype=bf, device=m)
    t = torch.empty((), dtype=torch.int32, device=m)
    qv, dv = torch.empty(8, 32, device=m), torch.empty(1024, 32, device=m)
    qt = torch.empty(4, 8, dtype=torch.int32, device=m)
    w, ab = torch.empty(2, 4, 8, device=m), torch.empty(2, 2, device=m)
    dt, dl = torch.empty(512, 16, dtype=torch.int32, device=m), torch.empty(512, dtype=torch.int32,
                                                                             device=m)
    before = dict(ops.LAUNCHES)
    with opcount.OpCounter() as c:
        a = ops.flash_attention(q, k, k, window=16, block_q=16, block_k=16)
        d = ops.flash_decode(qd, k, k, t, window=None)
        s, i = ops.score_topk(qv, dv, k=10)
        ls, li = ops.lexical_scan_topk(qt, w, ab, dt, dl, modes=(0, 0), k=7)
    assert ops.LAUNCHES == before
    assert a.shape == q.shape and a.dtype == bf and a.is_meta
    assert d.shape == qd.shape and d.dtype == bf
    assert (s.shape, s.dtype, i.dtype) == ((8, 10), torch.float32, torch.int32)
    assert (ls.shape, ls.dtype, li.dtype) == ((2, 4, 7), torch.float32, torch.int32)
    want = {"flash_attention": flash_attn.cost(q, k, k, window=16),
            "flash_decode": flash_decode.cost(qd, k, k, None),
            "score_topk": score_topk.cost(qv, dv, k=10),
            "lexical_scan_topk": lexical_scan.cost(qt, w, ab, dt, dl, k=7)}
    got = c.result()["kernels"]
    for name, cost in want.items():
        assert got[name]["calls"] == 1
        assert got[name]["bytes"] == cost["bytes"]
        assert {kk: v for kk, v in got[name]["flops"].items() if v} == cost["flops"]
    # the bounds' formulas: the scored pairs of a causal window, the decode at t = S - 1
    assert flash_attn.window_pairs(64, 16) == 16 * 17 // 2 + 48 * 16
    assert want["flash_decode"]["flops"] == {"bf16": 4 * 2 * 4 * 16 * 64}
    assert want["score_topk"]["flops"] == {"tf32": 3 * 2 * 8 * 1024 * 32}


def test_a_meta_decode_step_is_counted_at_a_host_positions_t():
    """On meta a host int ``t`` reaches the decode kernel as it is, so its
    cost is charged at ``t``; a meta tensor ``t`` has no value and is
    charged at ``S - 1``."""
    from repro_torch.kernels import flash_decode
    cfg = dataclasses.replace(configs.get_config("gemma2-2b"), n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
    step = tfm.make_serve_step(cfg, batch=2)
    params = cells.abstract(tfm.param_shapes(cfg))
    cache = cells.abstract(tfm.cache_shapes(cfg, 2, 64))
    tokens = torch.empty(2, dtype=torch.int32, device="meta")
    qd = torch.empty(2, 4, 16, dtype=torch.bfloat16, device="meta")
    kc = torch.empty(2, 64, 2, 16, dtype=torch.bfloat16, device="meta")
    for t, at in ((torch.empty((), dtype=torch.int32, device="meta"), None), (10, 10), (63, 63)):
        with opcount.OpCounter() as c:
            step(params, cache, tokens, t)
        got = c.result()["kernels"]["flash_decode"]
        one = flash_decode.cost(qd, kc, kc, at)
        assert got["calls"] == 2 and got["bytes"] == 2 * one["bytes"]
        assert got["flops"]["bf16"] == 2 * one["flops"]["bf16"]
    assert flash_decode.cost(qd, kc, kc, 10)["bytes"] < flash_decode.cost(qd, kc, kc, None)["bytes"]


def test_the_data_dependent_paths_take_the_general_path_on_meta():
    ids = torch.tensor([3, 0, 2, 2, 7, 1], dtype=torch.int32)  # 7 is dropped
    real, meta = segment.segments(ids, 4), segment.segments(ids.to("meta"), 4)
    assert real.n_valid == 5 and meta.n_valid == 6  # meta counts every row as kept
    assert real.order is not None and meta.order is not None
    blocks = segment.segments(torch.empty(100, dtype=torch.int32, device="meta"), 10).blocks(30)
    assert [(i0, i1, b.n_valid) for i0, i1, b in blocks] == [
        (0, 2, 25), (2, 5, 25), (5, 7, 25), (7, 10, 25)]
    # gnn's source mask: kept on meta, None on real ids that are all in range
    _, ok = gnn._src_rows(torch.zeros(5, dtype=torch.int32, device="meta"), 3)
    assert ok is not None and ok.is_meta
    assert gnn._src_rows(torch.zeros(5, dtype=torch.int32), 3)[1] is None


# ---------------------------------------------------------------------------
# the dry-run and the roofline table
# ---------------------------------------------------------------------------

def test_dryrun_of_the_reduced_configs_on_one_h100_is_ok_for_every_cell(tmp_path, monkeypatch):
    """Every cell at its own shapes with each arch's reduced config (sasrec
    keeps its history length of 50, which the cells' inputs take)."""
    reduced = {a: configs.reduced_config(a) for a in ARCHS}
    reduced["sasrec"] = dataclasses.replace(reduced["sasrec"], seq_len=50)
    monkeypatch.setattr(configs, "get_config", reduced.__getitem__)
    monkeypatch.setattr(cells, "get_config", reduced.__getitem__)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun_torch"))
    assert dryrun.orchestrate("1", force=True, quiet=True) == []
    files = sorted(os.listdir(tmp_path / "dryrun_torch" / "1"))
    assert len(files) == len(CELLS)
    for name in files:
        with open(tmp_path / "dryrun_torch" / "1" / name) as f:
            rec = json.load(f)
        assert rec["ok"] and rec["n_devices"] == 1, name
        assert rec["memory"]["fits_h100"] and rec["hlo"]["bytes_accessed"] > 0, name
    monkeypatch.setattr(roofline, "RESULTS", str(tmp_path))
    rows = roofline.analyze("1")
    assert len(rows) == len(CELLS)
    assert {r["bottleneck"] for r in rows} <= {"compute", "memory", "collective"}
    md = roofline.emit(rows, "1")
    assert md.count("\n| ") == len(CELLS) + 1


def test_cells_a_production_mesh_cannot_build_yet_name_the_multi_shard_slice():
    """The cells that raised on a production mesh before the multi-shard
    parts (LM training: the loss over dp and tp; decode: a sequence-sharded
    cache) build on 16x16 and, at the reduced configs, count: no launch,
    the loss's and the merge's all-reduces among 16 (tp) and 256 (every
    axis at batch 1) shards recorded, and the long cache's decode kernels
    charged only where a shard holds positions."""
    mesh = cells.meta_mesh("16x16")
    for arch, shape in (("gemma2-2b", "train_4k"), ("gemma2-2b", "decode_32k"),
                        ("gemma2-2b", "long_500k")):
        cells.build_cell(arch, shape, mesh)
    reduced = dataclasses.replace(configs.reduced_config("gemma2-2b"), vocab=512)
    before = dict(ops.LAUNCHES)
    for shape, group in (("train_4k", 16), ("long_500k", 256)):
        real = cells.get_config
        cells.get_config = lambda a: reduced if a == "gemma2-2b" else real(a)
        try:
            cell = cells.build_cell("gemma2-2b", shape, mesh)
        finally:
            cells.get_config = real
        with opcount.OpCounter(mesh.size) as c:
            c.track(cell.abstract_inputs)
            cell.fn(*cell.abstract_inputs)
        res = c.result()
        assert res["collective_group_sizes"]["all-reduce"] == group, shape
        if shape == "long_500k":  # 256 shards a layer, the local layer's only in the last
            line = res["kernels"]["flash_decode"]
            assert line["calls"] == 256 * reduced.n_layers
            window = reduced.sliding_window
            positions = (524_288 - 1) + (window - 1)  # global < t, local t - window < p < t
            assert line["flops"]["f32"] * mesh.size == 4 * reduced.n_heads * reduced.hd * positions
    assert ops.LAUNCHES == before
