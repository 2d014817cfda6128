#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MIREX on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, as the check runs it

Phases, each one JSON line; any failure ends the run with a non-zero exit
code (nothing is caught and passed over):

1. ``env``        the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``      nvcc builds every kernel source for sm_90a (one nvcc each,
                  all started together); build time and each kernel's
                  registers / shared memory / spills.
3. ``kernels``    each kernel against its plain PyTorch version on the card,
                  on the same inputs: edge shapes, one full-width segment of
                  the ``mirex`` configuration, three block settings. The
                  lexical scan must agree to the bit; the dense score+top-k
                  within 1e-5 with ids equal except at float near-ties
                  (the CPU tests' rule, ``tests/_torch_parity.py``), and to
                  the bit on integer-valued inputs. Then each kernel's time
                  by CUDA events beside its bound and the plain version's
                  time, and for the dense kernel the time of one PyTorch
                  call that computes the same function (``library_ms``).
4. ``experiment`` the ``bm25-grid`` experiment at the ``mirex`` width
                  (2^23 docs x 128 tokens, vocab 65,536, 64 queries, k 1000,
                  5 models, 32 segments) through `runner.run_experiment` on
                  the card; every segment must launch the scan kernel.
5. ``resume``     the ``smoke`` experiment crashed after its first segment,
                  then resumed: run files byte-identical to an
                  uninterrupted run.
6. ``serve``      retrieval serving through `RetrievalService`: a
                  `DenseSession` over the ``dense_scan`` shape (2^24 docs x
                  256 dims, float32, 16 GiB resident; 4,096 queries, k 1000)
                  and a `LexicalSession` over the ``experiment`` phase's
                  corpus (4 waves of 256 queries); every dispatch must launch
                  its kernel once, sampled answers must match the plain
                  oracles; then a batch-size sweep at 8, 64 and 128.

The last three lines are the card's ``nvidia-smi`` name and power limit, a
JSON line with every kernel's numbers, and ``{"ok": true, "device": ...}``.
Artifacts go under ``build/chip_smoke/``. Without a CUDA device, or without
the rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
PHASES = ("env", "build", "kernels", "experiment", "resume", "serve")

# H100 SXM peaks at 700 W: the HBM3 rate (NVIDIA data sheet) and the INT32
# compare/add rate of the CUDA cores, 64 results per clock per SM for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput) x 132 SMs x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# and the FP32 rate: 128 fused multiply-adds per clock per SM for compute
# capability 9.0 (same table), 2 operations each
FP32_OPS_PER_S = 128 * 2 * 132 * 1.98e9
# the repo's ``dense_scan`` shape (src/repro/configs/shapes.py:89-91) at the
# ``mirex`` config's dense_dim (src/repro/configs/archs/mirex.py)
DENSE_DOCS, DENSE_QUERIES = 1 << 24, 4096
DEEPER = 8  # reference rankings this much deeper show near-ties across the cut


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_env(ctx) -> None:
    import torch

    emit("env", nvidia_smi=ctx["smi"], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())


def phase_build(ctx) -> None:
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    paths = _build.build_all(["lexical_scan", "score_topk"])
    seconds = time.monotonic() - t0
    ptxas = {}
    for name in paths:
        lines = _build.BUILD_LOG[name]["ptxas"].splitlines()
        ptxas[name] = [ln.strip() for ln in lines if "ptxas info" in ln or "spill" in ln]
    emit("build", seconds=seconds, nvcc_flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas,
         nvidia_smi=ctx["smi"])


def _case_inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty, grid, device):
    """Random tokens from a small vocab (ties everywhere), query pads, and
    ``n_empty`` zero-length rows, with the epilogues of ``grid``."""
    import numpy as np
    import torch

    from repro_torch.core import anchors, scoring

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l_d + 1, size=n_d).astype(np.int32)
    lens[rng.choice(n_d, size=n_empty, replace=False)] = 0
    toks = rng.integers(0, vocab, size=(n_d, l_d)).astype(np.int32)
    toks[np.arange(l_d)[None, :] >= lens[:, None]] = scoring.PAD_TOKEN
    q = rng.integers(0, vocab, size=(n_q, l_q)).astype(np.int32)
    q_lens = rng.integers(1, l_q + 1, size=n_q)
    q[np.arange(l_q)[None, :] >= q_lens[:, None]] = scoring.PAD_TOKEN
    d_tokens = torch.as_tensor(toks, device=device)
    d_len = torch.as_tensor(lens, device=device)
    queries = torch.as_tensor(q, device=device)
    stats = anchors.collection_stats(d_tokens, d_len, vocab, chunk_size=n_d)
    modes, weights, ab = scoring.lexical_epilogues(grid, queries, stats)
    return queries, weights, ab, d_tokens, d_len, modes


def _compare(name, kern, plain) -> float:
    """Ids equal and scores equal to the bit; returns the max |diff| (0.0)."""
    import torch

    ks, ki = kern
    ps, pi = plain
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: ids differ from the plain version at {bad}")
    if not torch.equal(ks.view(torch.int32), ps.view(torch.int32)):
        bad = (ks.view(torch.int32) != ps.view(torch.int32)).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: score bits differ from the plain version at {bad}")
    finite = torch.isfinite(ps)
    diff = (ks[finite] - ps[finite]).abs()
    return float(diff.max()) if diff.numel() else 0.0


def _bm25_grid():
    from repro_torch.experiments import grid as exp_grid

    return exp_grid.get_experiment("bm25-grid").scorers()


def phase_kernels(ctx) -> None:
    import torch

    from repro_torch.core import scoring
    from repro_torch.data import synthetic
    from repro_torch.kernels import lexical_scan, ops

    dev = torch.device("cuda")
    mixed = [
        scoring.get_scorer("ql_lm"),
        scoring.make_variant("ql_lm", lam=0.5, length_prior=False),
        scoring.get_scorer("bm25"),
        scoring.make_variant("bm25", k1=0.9, b=0.4),
        scoring.get_scorer("tfidf"),
    ]
    bm25_only = [scoring.get_scorer("bm25")]
    # name, seed, n_d, L_d, n_q, L_q, vocab, zero-length rows, grid, k, block_d, tile_d
    cases = [
        ("edge_mixed", 1, 300, 23, 7, 5, 30, 40, mixed, 37, 100, 16),
        ("k_above_docs", 2, 64, 16, 5, 3, 12, 8, mixed, 100, 64, 16),
        ("k_one", 3, 512, 40, 9, 4, 20, 10, mixed, 1, 128, 32),
        ("all_zero_length", 4, 32, 8, 3, 2, 5, 32, mixed, 10, 32, 16),
        ("bm25_ties", 5, 2048, 12, 16, 4, 6, 100, bm25_only, 50, 512, 16),
        ("pow2_k_small_block", 6, 4096, 64, 12, 8, 200, 64, mixed, 64, 32, 64),
        ("rows_of_200", 7, 1024, 200, 6, 4, 50, 16, mixed, 30, 512, 16),
        ("rows_of_300", 8, 512, 300, 5, 3, 60, 16, mixed, 30, 256, 32),
        # k_pad 4096: three models fill a CTA, so the launch runs in two groups
        ("model_groups", 9, 8192, 24, 4, 4, 40, 64, mixed, 3000, 4096, 16),
    ]
    results = []
    for name, seed, n_d, l_d, n_q, l_q, vocab, n_empty, grid, k, block_d, tile_d in cases:
        q, w, ab, d, dl, modes = _case_inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty, grid, dev)
        plain = lexical_scan.lexical_scan_topk_ref(
            q, w, ab, d, dl, modes=modes, k=k, block_d=block_d, tile_d=tile_d)
        kern = ops.lexical_scan_topk(q, w, ab, d, dl, modes=modes, k=k,
                                     block_d=block_d, tile_d=tile_d)
        torch.cuda.synchronize()
        results.append({"case": name, "max_abs_err": _compare(name, kern, plain)})
    emit("kernels.edge", cases=results, nvidia_smi=ctx["smi"])

    # one full-width segment of the mirex configuration
    n_seg, l_d, vocab, k = 262_144, 128, 65_536, 1000
    corpus = synthetic.make_corpus(n_docs=n_seg, vocab=vocab, max_len=l_d, seed=0, device=dev)
    queries_np = synthetic.make_queries(corpus, n_queries=64, seed=1)
    from repro_torch.core import anchors

    d = torch.as_tensor(corpus.tokens, device=dev)
    dl = torch.as_tensor(corpus.lengths, device=dev)
    q = torch.as_tensor(queries_np, device=dev)
    stats = anchors.collection_stats(d, dl, vocab, chunk_size=16_384)
    modes, w, ab = scoring.lexical_epilogues(_bm25_grid(), q, stats)
    args = (q, w, ab, d, dl)
    plain = lexical_scan.lexical_scan_topk_ref(*args, modes=modes, k=k, block_d=16_384)
    kern = ops.lexical_scan_topk(*args, modes=modes, k=k, block_d=16_384, tile_d=16)
    torch.cuda.synchronize()
    err = _compare("full_segment", kern, plain)
    settings = [(16_384, 16), (4_096, 32), (65_536, 64)]
    for block_d, tile_d in settings[1:]:
        other = ops.lexical_scan_topk(*args, modes=modes, k=k, block_d=block_d, tile_d=tile_d)
        torch.cuda.synchronize()
        _compare(f"block_d={block_d},tile_d={tile_d}", other, kern)
    emit("kernels.full_segment", docs=n_seg, doc_len=l_d, n_q=q.shape[0], l_q=q.shape[1],
         models=len(modes), k=k, max_abs_err=err, block_settings=settings,
         identical_across_settings=True, nvidia_smi=ctx["smi"])

    ms = cuda_ms(lambda: lexical_scan.lexical_scan_topk_cuda(
        *args, modes=modes, k=k, block_d=16_384, tile_d=16), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: lexical_scan.lexical_scan_topk_ref(
        *args, modes=modes, k=k, block_d=16_384), reps=3)
    n_q, l_q = q.shape
    ops_count = 2 * n_q * l_q * n_seg * l_d  # one compare + one add per pair
    n_bytes = sum(t.numel() * t.element_size() for t in args) + 2 * len(modes) * n_q * k * 4
    bound_ms = 1e3 * max(ops_count / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    bound_by = "operations" if ops_count / INT32_OPS_PER_S >= n_bytes / HBM_BYTES_PER_S else "bytes"
    ctx["kernels"]["lexical_scan_topk"] = {
        "name": "lexical_scan_topk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lexical_scan.cu",
        "replaces": "src/repro/kernels/lexical_scan.py:125",
        "launches": None,  # from the experiment phase's run of the main path
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    emit("kernels.timing", kernel="lexical_scan_topk", shape="262144x128 docs, 64x4 queries, "
         "5 models, k 1000", ms=ms, plain_ms=plain_ms, plain_note="plain version: not a yardstick",
         bound_ms=bound_ms, bound_by=bound_by, compare_ops=ops_count, bytes=n_bytes,
         nvidia_smi=ctx["smi"])
    del corpus, d, dl, q, w, ab, args, plain, kern
    torch.cuda.empty_cache()
    _dense_kernels(ctx)


def _rows(seed, shape, dtype, integer=False):
    """Seeded rows drawn on the card: standard normal, or integers in -3..3."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if integer:
        x = torch.randint(-3, 4, shape, generator=g, device="cuda").to(torch.float32)
    else:
        x = torch.randn(shape, generator=g, device="cuda")
    return x.to(dtype)


def _dense_corpus():
    """The ``dense_scan`` corpus on the card: 2^24 standard-normal rows of
    ``dense_dim``, each over its L2 norm as `make_dense_corpus` does (drawn
    on the card from a seeded generator, not the reference's numpy bytes;
    the same seed gives the same corpus in both phases that use it)."""
    import torch

    from repro_torch.configs import get_config

    dim = get_config("mirex").dense_dim
    g = torch.Generator(device="cuda").manual_seed(4)
    v = torch.empty((DENSE_DOCS, dim), device="cuda")
    step = 1 << 20
    for a in range(0, DENSE_DOCS, step):
        blk = v[a : a + step]
        blk.normal_(generator=g)
        blk.div_(torch.linalg.vector_norm(blk, dim=-1, keepdim=True))
    return v


def _parity(name, kern, plain):
    """The CPU tests' rule on the card's results: scores within 1e-5, ids
    equal except at float near-ties (``plain`` may rank deeper than
    ``kern``); returns the max |diff| of the scores."""
    import torch
    from _torch_parity import assert_rankings_close

    ks, ki = (t.cpu() for t in kern)
    ps, pi = (t.cpu() for t in plain)
    assert_rankings_close(ks.numpy(), ki.numpy(), ps.numpy(), pi.numpy(), what=name)
    ps = ps[..., : ks.shape[-1]]
    finite = torch.isfinite(ps)
    diff = (ks[finite] - ps[finite]).abs()
    return float(diff.max()) if diff.numel() else 0.0


def _dense_kernels(ctx) -> None:
    import torch

    from repro_torch.kernels import ops, score_topk

    f32, bf16 = torch.float32, torch.bfloat16
    # name, seed, n_q, n_d, dim, k, block_d, dtype, integer-valued, zero query rows
    cases = [
        ("sweep_8x256x64_k5", 1, 8, 256, 64, 5, 128, f32, False, 0),
        ("sweep_16x512x128_k32_bf16", 2, 16, 512, 128, 32, 128, bf16, False, 0),
        ("sweep_128x1024x256_k32", 3, 128, 1024, 256, 32, 128, f32, False, 0),
        ("sweep_128x1024x256_k5_bf16", 4, 128, 1024, 256, 5, 128, bf16, False, 0),
        ("k_above_block", 5, 5, 256, 32, 100, 64, f32, False, 0),
        ("k_above_docs", 6, 5, 64, 32, 100, 64, f32, False, 0),
        ("zero_query_rows", 7, 6, 256, 64, 20, 64, f32, False, 2),
        ("groups_not_dividing", 8, 70, 2048, 256, 64, 256, bf16, False, 0),
        ("k_1000_small_corpus", 9, 3, 4096, 64, 1000, 512, f32, False, 1),
        ("integer_valued", 10, 40, 8192, 128, 300, 1024, f32, True, 1),
        ("integer_valued_bf16", 11, 24, 512, 64, 40, 128, bf16, True, 0),
    ]
    results = []
    for name, seed, n_q, n_d, dim, k, block_d, dtype, integer, n_zero in cases:
        q = _rows(seed, (n_q, dim), dtype, integer)
        q[:n_zero] = 0
        d = _rows(seed + 100, (n_d, dim), dtype, integer)
        kern = ops.score_topk(q, d, k=k, block_d=block_d)
        concat = ops.score_topk(q, d, k=k, block_d=block_d, merge="concat")
        torch.cuda.synchronize()
        if not (torch.equal(kern[1], concat[1]) and torch.equal(kern[0], concat[0])):
            raise AssertionError(f"{name}: merge='concat' differs from 'bitonic'")
        if integer:  # every product and sum exact: bit-equal, ties included
            plain = score_topk.score_topk_ref(q, d, k=k, block_d=block_d)
            err = _compare(name, tuple(t + 0.0 for t in kern[:1]) + kern[1:],
                           tuple(t + 0.0 for t in plain[:1]) + plain[1:])
        else:
            plain = score_topk.score_topk_ref(q, d, k=k + DEEPER, block_d=block_d)
            err = _parity(name, kern, plain)
        if n_zero and not torch.equal(kern[1][0, : min(k, n_d)],
                                      torch.arange(min(k, n_d), dtype=torch.int32, device="cuda")):
            raise AssertionError(f"{name}: a zero query row does not rank ids 0, 1, 2, ...")
        results.append({"case": name, "max_abs_err": err, "bit_equal": integer})
    emit("kernels.dense_edge", cases=results, nvidia_smi=ctx["smi"])

    # one full-width segment: chunk_size rows of the dense_scan shape, 64 queries, k 1000
    n_seg, dim, n_q, k = 16_384, 256, 64, 1000
    q, d = _rows(20, (n_q, dim), f32), _rows(21, (n_seg, dim), f32)
    q[0] = 0
    kern = ops.score_topk(q, d, k=k, block_d=n_seg)
    plain = score_topk.score_topk_ref(q, d, k=k + DEEPER, block_d=n_seg)
    err = _parity("dense_full_segment", kern, plain)
    for block_d in (1024, 4096):  # more splits: the same kernel scores, the same bits
        _compare(f"dense block_d={block_d}", ops.score_topk(q, d, k=k, block_d=block_d), kern)
    qi, di = _rows(22, (n_q, dim), f32, True), _rows(23, (n_seg, dim), f32, True)
    ki = ops.score_topk(qi, di, k=k, block_d=1024)
    pi = score_topk.score_topk_ref(qi, di, k=k, block_d=1024)
    _compare("dense_full_segment_integer", (ki[0] + 0.0, ki[1]), (pi[0] + 0.0, pi[1]))
    emit("kernels.dense_full_segment", docs=n_seg, dim=dim, n_q=n_q, k=k, max_abs_err=err,
         identical_across_block_d=[n_seg, 1024, 4096], integer_bit_equal=True,
         nvidia_smi=ctx["smi"])

    # time: one 64-query block over the whole dense_scan corpus
    corpus = _dense_corpus()
    q = _rows(24, (n_q, dim), f32)
    n_d = corpus.shape[0]
    geo = score_topk.launch_geometry(n_q, dim, n_d, k, 16_384, 4,
                                     torch.cuda.get_device_properties(0).multi_processor_count)
    ms = cuda_ms(lambda: score_topk.score_topk_cuda(q, corpus, k=k, block_d=16_384),
                 reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: score_topk.score_topk_ref(q, corpus, k=k, block_d=16_384),
                       reps=2, warmup=1)
    library_ms = cuda_ms(lambda: torch.topk(q @ corpus.T, k), reps=3, warmup=1)
    ops_count = 2 * n_q * n_d * dim
    n_bytes = (q.numel() + corpus.numel()) * 4 + n_q * k * 8
    bound_ms = 1e3 * max(ops_count / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    bound_by = "operations" if ops_count / FP32_OPS_PER_S >= n_bytes / HBM_BYTES_PER_S else "bytes"
    ctx["kernels"]["score_topk"] = {
        "name": "score_topk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/score_topk.cu",
        "replaces": "src/repro/kernels/score_topk.py:130",
        "launches": None,  # from the serve phase's dense run of the main path
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    emit("kernels.timing", kernel="score_topk", shape=f"{n_d}x{dim} f32 docs, {n_q} queries, "
         f"k {k}", geometry=geo, ms=ms, plain_ms=plain_ms,
         plain_note="plain version: not a yardstick", library_ms=library_ms,
         library_note="torch.topk(q @ d.T, k): two PyTorch calls, timed as a yardstick, "
         "never used by the port", bound_ms=bound_ms, bound_by=bound_by,
         fp32_ops=ops_count, bytes=n_bytes, nvidia_smi=ctx["smi"])
    del corpus  # 16 GiB: the experiment phase runs as it ran before this phase grew
    torch.cuda.empty_cache()


def _check_runs(report, n_docs: int, k: int) -> None:
    """Run files hold k ranked docs per query: ids in range and distinct,
    scores finite and non-increasing down each ranking."""
    import numpy as np

    from repro_torch.eval import trec

    for model, path in report["runs"].items():
        ids, scores, _ = trec.read_run(path)
        if ids.shape != (report["n_queries"], k):
            raise AssertionError(f"{model}: run shape {ids.shape}")
        if ids.min() < 0 or ids.max() >= n_docs:
            raise AssertionError(f"{model}: doc id out of range")
        if not np.isfinite(scores).all() or (np.diff(scores, axis=1) > 0).any():
            raise AssertionError(f"{model}: scores not finite and descending")
        if any(len(set(row)) != k for row in ids.tolist()):
            raise AssertionError(f"{model}: a ranking repeats a document")


def phase_experiment(ctx) -> None:
    import torch

    from repro_torch.experiments import grid as exp_grid
    from repro_torch.experiments import runner
    from repro_torch.kernels import ops

    spec = dataclasses.replace(
        exp_grid.get_experiment("bm25-grid"),
        n_docs=1 << 23, n_queries=64, vocab=65_536, max_doc_len=128, k=1000,
        chunk_size=16_384, segment_chunks=16, n_shards=1,
    )
    out = os.path.join(OUT, "bm25-grid")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    coll = runner.prepare_collection(spec, seed=0, device="cuda")
    prepare_s = time.monotonic() - t0
    ops.reset_launches()
    t1 = time.monotonic()
    report = runner.run_experiment(
        spec, out_dir=out, seed=0, collection=coll, device="cuda",
        trace_out=os.path.join(out, "trace.json"),
    )
    lifecycle_s = time.monotonic() - t1
    launches = ops.LAUNCHES["lexical_scan_topk"]
    n_segments = report["job"]["segments_total"]
    if launches != n_segments:
        raise AssertionError(f"{launches} kernel launches for {n_segments} segments")
    _check_runs(report, spec.n_docs, spec.k)
    phases = report["job"]["obs"]["phases"]
    scan_s = phases["(global)"]["experiment.scan"]["total_s"]
    ctx["launches"]["lexical_scan_topk"] = launches
    ctx["collection"] = coll  # the serve phase's lexical session scans this corpus
    emit("experiment", experiment=spec.name, n_docs=spec.n_docs, n_queries=spec.n_queries,
         vocab=spec.vocab, doc_len=spec.max_doc_len, k=spec.k, models=report["models"],
         segments=n_segments, launches=launches, prepare_s=prepare_s,
         lifecycle_s=lifecycle_s, scan_s=scan_s, docs_per_s=spec.n_docs / scan_s,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         map={m: v["map"] for m, v in report["metrics"].items()},
         p_at_10={m: v["p@10"] for m, v in report["metrics"].items()},
         phases=phases, nvidia_smi=ctx["smi"])


def phase_resume(ctx) -> None:
    from repro_torch.cluster import WorkerCrash
    from repro_torch.experiments import grid as exp_grid
    from repro_torch.experiments import runner
    from repro_torch.kernels import ops

    spec = exp_grid.get_experiment("smoke")
    clean = os.path.join(OUT, "smoke-clean")
    crashed = os.path.join(OUT, "smoke-crashed")
    for p in (clean, crashed):
        shutil.rmtree(p, ignore_errors=True)
    ops.reset_launches()
    runner.run_experiment(spec, out_dir=clean, device="cuda")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            runner.run_experiment(spec, out_dir=crashed, device="cuda", fail_at_segment=0)
    except WorkerCrash:
        pass
    else:
        raise AssertionError("the injected crash did not fire")
    report = runner.run_experiment(spec, out_dir=crashed, device="cuda")
    if report["job"]["resumed_from"] != 1 or report["job"]["segments_run"] != 1:
        raise AssertionError(f"resume did not start at segment 1: {report['job']}")
    for name in sorted(os.listdir(os.path.join(clean, "runs"))):
        with open(os.path.join(clean, "runs", name), "rb") as f:
            a = f.read()
        with open(os.path.join(crashed, "runs", name), "rb") as f:
            b = f.read()
        if a != b:
            raise AssertionError(f"run file {name} differs after crash and resume")
    emit("resume", experiment="smoke", crashed_after_segment=0, resumed_from=1,
         run_files_identical=True, launches=ops.LAUNCHES["lexical_scan_topk"],
         nvidia_smi=ctx["smi"])


def _serve_line(service, kind, wall_s, sweep) -> dict:
    """Per-block latency quantiles, µs per query and queries/s over the
    service's dispatches, and the sweep's curve (µs per query and queries/s
    at each bucket) with its amortisation."""
    import numpy as np

    recs = [r for r in service.metrics if r.kind == kind]
    lat = np.array([r.latency_s for r in recs])
    n = sum(r.n_real for r in recs)
    return {
        "dispatches": len(recs), "queries": n,
        "buckets": sorted({r.n_padded for r in recs}),
        "block_latency_ms": {"p50": float(np.quantile(lat, 0.5)) * 1e3,
                             "p99": float(np.quantile(lat, 0.99)) * 1e3},
        "us_per_query": float(lat.sum()) / n * 1e6, "qps": n / float(lat.sum()),
        "wall_s": wall_s, "wall_qps": n / wall_s,
        "sweep": [{k: pt[k] for k in ("batch", "n_padded", "n_blocks", "latency_ms",
                                      "us_per_query", "qps", "amortization_x")}
                  for pt in sweep["curve"]],
        "amortization_x": sweep.get("amortization_x"),
    }


def _answered_once(results, rids) -> None:
    if sorted(results) != sorted(rids):
        raise AssertionError(f"{len(results)} answers for {len(rids)} queries")


def phase_serve(ctx) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import scan
    from repro_torch.core.scoring import get_scorer, lexical_epilogues
    from repro_torch.data import synthetic
    from repro_torch.kernels import lexical_scan, ops
    from repro_torch.obs import Metrics
    from repro_torch.serve import DenseSession, LexicalSession, RetrievalService
    from repro_torch.serve.bench import sweep_batch_sizes

    cfg = get_config("mirex")
    k, chunk, sweep_sizes = cfg.k, cfg.chunk_size, (8, 64, 128)

    # dense: DenseSession over the dense_scan shape, default triggers
    corpus = _dense_corpus()
    session = DenseSession(corpus, "dense_dot", k=k, chunk_size=chunk)
    queries = _rows(30, (DENSE_QUERIES, cfg.dense_dim), torch.float32).cpu().numpy()
    service = RetrievalService({"dense": session}, registry=Metrics())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.monotonic()
    rids = [service.submit(q, "dense") for q in queries]
    results = service.poll()
    results.update(service.drain())
    wall_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    _answered_once(results, rids)
    if launches["score_topk"] != len(service.metrics) or launches["lexical_scan_topk"]:
        raise AssertionError(f"{launches} kernel launches for {len(service.metrics)} "
                             "dense dispatches")
    ctx["launches"]["score_topk"] = launches["score_topk"]
    sample = np.linspace(0, DENSE_QUERIES - 1, 8).astype(int)
    want = scan.search_dense_host(torch.as_tensor(queries[sample], device="cuda"), corpus,
                                  k + DEEPER)
    got = (torch.as_tensor(np.stack([results[rids[i]].scores for i in sample])),
           torch.as_tensor(np.stack([results[rids[i]].ids for i in sample])))
    err = _parity("serve.dense sampled queries", got, want)
    sweep = sweep_batch_sizes(
        session, lambda n, seed: _rows(40 + seed, (n, cfg.dense_dim), torch.float32).cpu().numpy(),
        sweep_sizes)
    emit("serve.dense", n_docs=session.n_docs, dim=session.dim, dtype="float32",
         resident_bytes=corpus.numel() * 4, scorer="dense_dot", k=k, chunk_size=chunk,
         launches=launches, sampled_max_abs_err=err,
         **_serve_line(service, "dense", wall_s, sweep), nvidia_smi=ctx["smi"])
    del corpus, session, service, results
    torch.cuda.empty_cache()

    # lexical: the experiment phase's corpus, 4 waves of 256 as serve_search does
    if "collection" not in ctx:  # phase run alone (--only serve): prepare it
        from repro_torch.experiments import grid as exp_grid
        from repro_torch.experiments import runner

        ctx["collection"] = runner.prepare_collection(dataclasses.replace(
            exp_grid.get_experiment("bm25-grid"), n_docs=1 << 23, n_queries=64,
            vocab=cfg.vocab, max_doc_len=cfg.max_doc_len, chunk_size=chunk),
            seed=0, device="cuda")
    coll = ctx["collection"]
    session = LexicalSession(coll.corpus.tokens, coll.corpus.lengths, cfg.scorer, k=k,
                             chunk_size=chunk, stats=coll.stats)
    n_wave = 256
    service = RetrievalService({"lexical": session}, max_batch=n_wave, registry=Metrics())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.monotonic()
    answers = {}
    waves = []
    for b in range(4):
        wave = synthetic.make_queries(coll.corpus, n_queries=n_wave, seed=10 + b)
        rids = [service.submit(q, "lexical") for q in wave]
        results = service.poll()
        results.update(service.drain())
        _answered_once(results, rids)
        answers.update({(b, j): results[r] for j, r in enumerate(rids)})
        waves.append(wave)
    wall_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    if launches["lexical_scan_topk"] != len(service.metrics) or launches["score_topk"]:
        raise AssertionError(f"{launches} kernel launches for {len(service.metrics)} "
                             "lexical dispatches")
    # sampled answers against the plain version on the card: bit-equal
    picks = [(0, 0), (1, 77), (2, 128), (3, 255)]
    q = torch.as_tensor(np.stack([waves[b][j] for b, j in picks]), device="cuda")
    modes, w, ab = lexical_epilogues((get_scorer(cfg.scorer),), q, session._stats)
    plain = lexical_scan.lexical_scan_topk_ref(q, w, ab, *session._docs, modes=modes, k=k,
                                               block_d=chunk)
    got = (torch.as_tensor(np.stack([answers[p].scores for p in picks]))[None],
           torch.as_tensor(np.stack([answers[p].ids for p in picks]))[None])
    _compare("serve.lexical sampled queries", got, tuple(t.cpu() for t in plain))
    sweep = sweep_batch_sizes(
        session, lambda n, seed: synthetic.make_queries(coll.corpus, n_queries=n,
                                                        seed=100 + seed), sweep_sizes)
    emit("serve.lexical", n_docs=session.n_docs, doc_len=cfg.max_doc_len, vocab=cfg.vocab,
         resident_bytes=session.resident_corpus_bytes, scorer=cfg.scorer, k=k,
         chunk_size=chunk, waves=4, wave_queries=n_wave, launches=launches,
         sampled_bit_equal=True, **_serve_line(service, "lexical", wall_s, sweep),
         nvidia_smi=ctx["smi"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of phases (default: all)")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    for p in only:
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p!r}; one of {PHASES}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, os.path.join(ROOT, "tests"))  # the CPU tests' parity rule
    import repro_torch  # noqa: F401 — fails here when the repository is absent

    os.makedirs(OUT, exist_ok=True)
    from repro_torch.obs import gpu_name_and_power_limit

    ctx = {"kernels": {}, "launches": {}, "smi": gpu_name_and_power_limit()}
    table = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
             "experiment": phase_experiment, "resume": phase_resume, "serve": phase_serve}
    for p in PHASES:
        if p in only:
            table[p](ctx)
    for name, entry in ctx["kernels"].items():
        entry["launches"] = ctx["launches"].get(name, 0)
    print(ctx["smi"])
    print(json.dumps({"kernels": list(ctx["kernels"].values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
