#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MIREX on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, as the check runs it

Phases, each one JSON line; any failure ends the run with a non-zero exit
code (nothing is caught and passed over):

1. ``env``        the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``      nvcc builds every kernel source for sm_90a (one nvcc each,
                  all started together, flags per source); build time and
                  each kernel's registers / static shared memory / spills.
3. ``kernels``    each kernel against its plain PyTorch version on the card,
                  on the same inputs: edge shapes, one full-width segment of
                  the ``mirex`` configuration, three block settings. The
                  lexical scan must agree to the bit; the dense score+top-k
                  within 1e-5 with ids equal except at float near-ties
                  (the CPU tests' rule, ``tests/_torch_parity.py``), and to
                  the bit on integer-valued inputs; the flash attention and
                  decode kernels, on the reference's sweeps, head_dim 80,
                  128 and 256 and two block geometries, the wgmma route's
                  tile edges, decode positions on the card (equal to the
                  host-int call; out of range: NaN and the error word;
                  replayed from a CUDA graph at two positions), within
                  3e-4 / 3e-5 in float32 and 3e-2 in bfloat16, and in
                  bfloat16 also within a limit scaled to each output row
                  (``FLASH_ROW_TOL``), which at gemma2-2b's shapes a
                  control (the band one key block narrower) must fail.
                  Then each kernel's time by CUDA events (decode: CUDA
                  graphs of 50 calls) beside its bound, its achieved rate
                  and the plain version's time, and, where one PyTorch call
                  computes the same function, that call's time
                  (``library_ms``; for the flash kernels
                  `scaled_dot_product_attention`, which has no soft cap,
                  beside the kernel run with ``cap=None``).
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
7. ``lm``         LM serving of gemma2-2b at its full width and depth (26
                  layers, bfloat16, seeded random weights, 6.4 GB) through
                  `make_prefill_step` and `make_serve_step`: 4 prompts of
                  8,192 tokens from `make_lm_batch` (twice the sliding
                  window; one untimed prefill first, then the timed one),
                  the cache copied into 8,704 slots, one untimed and 128
                  timed greedy
                  decode steps; every layer's attention must launch the
                  flash kernel (26 prefill launches, 26 x 128 decode
                  launches), every logit must be finite and the decode
                  kernel's error word clear. Then the same
                  entry points at full width and 2 layers on 2 prompts of
                  1,024 tokens, on the card and on the CPU (plain
                  versions) from the same weights: last-position logits
                  within the bfloat16 tolerance ``LM_TOL``, greedy tokens
                  of 8 decode steps equal except at a named logit
                  near-tie, and every attention output within the
                  row-scaled limit times ``LM_ATTN_SLACK``; a control run
                  on the card with the window one key block short of the
                  prompt must fail that limit. `torch.profiler` over one
                  prefill and 8 decode steps gives the device busy and
                  idle time, the top kernels and each flash kernel's
                  device time.

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
PHASES = ("env", "build", "kernels", "experiment", "resume", "serve", "lm")

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
# bfloat16 dense tensor-core peak (NVIDIA data sheet, H100 SXM at 700 W)
BF16_OPS_PER_S = 989e12
# the kernels' tolerances against their plain versions (the reference's own,
# tests/test_kernels.py): (rtol, atol) by dtype name
FLASH_TOL = {"float32": (3e-4, 3e-5), "bfloat16": (3e-2, 3e-2)}
# bfloat16 outputs are also held to each output row's own scale: a softmax
# average of n standard-normal V rows has a spread of about sqrt(e/n), 0.018
# at n = 8192, so FLASH_TOL's atol would pass a kernel that dropped a key
# block. Per element |got - want| <= rtol |want| + tau rms(want's row over
# hd): rtol 2^-6 is two bfloat16 ulps of the value (the two sides round p
# and the output at different points), tau 0.05 of the row's scale lies far
# above p's rounding noise (2^-9 relative per term) and far below a key
# block misplaced at the band's edge, a control the check must fail
FLASH_ROW_TOL = (2.0 ** -6, 0.05)
# card against CPU at full width, 2 layers, bfloat16: last-position logits
# (O(1) with the seeded init) may differ by this much in absolute terms —
# every product rounds to bfloat16 at other places on the two devices
# (cuBLAS against oneDNN, the kernels against the plain versions), about
# 2^-8 relative per rounding, compounded over two layers. The logits mix
# attention with everything else, so the attention outputs themselves
# (before wo) are held to FLASH_ROW_TOL's limit scaled by LM_ATTN_SLACK:
# their inputs already differ by the card's and the CPU's roundings
# upstream. A control run on the card with the window one key block short
# must fail that check (PERF.md has both checks' sound and control readings)
LM_TOL = 0.1
LM_ATTN_SLACK = 4.0
# phase lm: gemma2-2b serving 4 prompts of 8,192 tokens (twice the window)
# into a cache of 8,704 slots (a multiple of decode_block_s 512), then 128
# greedy steps; the card-vs-CPU check on 2 prompts of 1,024 tokens
LM_BATCH, LM_PROMPT, LM_SLOTS, LM_DECODE, CHECK_PROMPT = 4, 8192, 8704, 128, 1024


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


def graph_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after two calls outside it), the replay timed by cuda_ms. For
    kernels of tens of microseconds, whose eager loop waits on Python."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=5, warmup=1) / reps
    del graph
    return ms


def phase_env(ctx) -> None:
    import torch

    emit("env", nvidia_smi=ctx["smi"], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())


def _ptxas_kernels(report: str) -> list[dict]:
    """Each kernel's registers, static shared memory and spills from nvcc's
    ``-Xptxas -v`` report (names demangled by c++filt where it exists)."""
    import re

    out, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "static_smem": 0,
                   "spill_stores": None, "spill_loads": None}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    if shutil.which("c++filt"):
        import subprocess

        names = subprocess.run(["c++filt"], input="\n".join(k["kernel"] for k in out),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(out):
            for k, name in zip(out, names):
                k["kernel"] = name.replace("(anonymous namespace)::", "")
    return out


def phase_build(ctx) -> None:
    import torch

    from repro_torch.kernels import _build, flash_attn, flash_decode

    names = ["lexical_scan", "score_topk", "flash_attn", "flash_decode"]
    t0 = time.monotonic()
    paths = _build.build_all(names)
    seconds = time.monotonic() - t0
    kernels = {name: _ptxas_kernels(_build.BUILD_LOG[name]["ptxas"]) for name in paths}
    for name, ks in kernels.items():
        for k in ks:
            if k["spill_stores"] or k["spill_loads"]:
                print(f"chip_smoke: {name}: {k['kernel']} spills {k['spill_stores']} / "
                      f"{k['spill_loads']} bytes", file=sys.stderr)
    emit("build", seconds=seconds,
         nvcc_flags={name: " ".join(_build.flags(name)) for name in names}, kernels=kernels,
         dynamic_smem_at_gemma2_2b={
             "flash_attn_wgmma<256>": flash_attn.wgmma_smem_bytes(256),
             "flash_decode_kernel<bf16, 2>": flash_decode.smem_bytes(2, 256, torch.bfloat16, 33)},
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
    _flash_kernels(ctx)


def _row_excess(got, want) -> float:
    """The largest ratio of |got - want| to FLASH_ROW_TOL's limit (above 1
    fails); rows run along the last axis (hd)."""
    rtol, tau = FLASH_ROW_TOL
    g, w = got.float(), want.float()
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    return float(((g - w).abs() / (rtol * w.abs() + tau * rms).clamp_min(1e-30)).max())


def _flash_close(name, got, want, dtype) -> dict:
    import torch

    rtol, atol = FLASH_TOL[str(dtype).removeprefix("torch.")]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol, msg=name)
    excess = _row_excess(got, want) if dtype == torch.bfloat16 else None
    if excess is not None and excess > 1:
        raise AssertionError(f"{name}: {excess} times the row-scaled limit {FLASH_ROW_TOL}")
    return {"max_abs_err": float((got.float() - want.float()).abs().max()), "row_excess": excess}


def _control_fails(name, wrong, want) -> float:
    """A deliberately wrong plain result must fail the row-scaled check:
    proof that the check sees a fault of that size at these shapes."""
    excess = _row_excess(wrong, want)
    if excess <= 1:
        raise AssertionError(f"{name}: the control passes the row-scaled check ({excess})")
    return excess


def _window_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal layer scores: j <= i and i - j < window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _flash_kernels(ctx) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn, flash_decode, ops

    f32, bf16 = torch.float32, torch.bfloat16
    results = []
    # the reference's sweep (tests/test_kernels.py:31-53) in both dtypes and two geometries
    for s, h, kv, hd in ((128, 4, 4, 32), (256, 4, 2, 64), (256, 8, 1, 32)):
        for window, cap in ((None, None), (64, None), (None, 30.0), (32, 50.0)):
            for dtype in (f32, bf16):
                for bq, bk in ((64, 64), (128, 128)):
                    seed = len(results)
                    q = _rows(seed, (2, s, h, hd), dtype)
                    k, v = _rows(seed + 1000, (2, s, kv, hd), dtype), _rows(seed + 2000, (2, s, kv, hd), dtype)
                    name = f"attn s{s} h{h} kv{kv} hd{hd} w{window} cap{cap} {dtype} {bq}/{bk}"
                    got = ops.flash_attention(q, k, v, window=window, cap=cap, block_q=bq, block_k=bk)
                    want = flash_attn.flash_attention_ref(q, k, v, window=window, cap=cap)
                    results.append({"case": name, **_flash_close(name, got, want, dtype)})
    # the models' head dims: gemma2-2b 256, h2o-danube 80, gemma2-27b 128
    for hd, h, kv in ((256, 8, 4), (80, 32, 8), (128, 32, 16)):
        for causal, window, cap in ((True, 200, 50.0), (True, None, None), (False, 100, 50.0)):
            for dtype in (f32, bf16):
                bq, bk = (128, 128) if causal and window else (64, 64)
                seed = len(results)
                q = _rows(seed, (1, 512, h, hd), dtype)
                k, v = _rows(seed + 1000, (1, 512, kv, hd), dtype), _rows(seed + 2000, (1, 512, kv, hd), dtype)
                name = f"attn hd{hd} h{h} kv{kv} causal{causal} w{window} cap{cap} {dtype} {bq}/{bk}"
                got = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                                          block_q=bq, block_k=bk)
                want = flash_attn.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
                results.append({"case": name, **_flash_close(name, got, want, dtype)})
    # the wgmma route's own geometry (head_dim 64 / 128 / 256; 128-row query
    # blocks, 64- or 128-key tiles): one block, less than one block, no
    # causal mask, windows one key either side of a tile's edge
    for hd in flash_attn.WGMMA_HEAD_DIMS:
        bk = flash_attn.wgmma_block_k(hd)
        for s, causal, window, cap in ((128, False, None, None), (64, True, None, 50.0),
                                       (384, True, bk + 1, 50.0), (384, True, bk - 1, None),
                                       (256, False, bk + 1, 30.0)):
            for dtype in (f32, bf16):
                seed = len(results)
                q = _rows(seed, (2, s, 8, hd), dtype)
                k, v = _rows(seed + 1000, (2, s, 4, hd), dtype), _rows(seed + 2000, (2, s, 4, hd), dtype)
                name = f"attn wgmma geometry hd{hd} s{s} causal{causal} w{window} cap{cap} {dtype}"
                got = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                                          block_q=64, block_k=64)
                want = flash_attn.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
                results.append({"case": name, **_flash_close(name, got, want, dtype)})
    # the reference's decode sweep (tests/test_kernels.py:56-67), both dtypes, two block sizes
    for s, kv, g, t in ((512, 2, 2, 300), (1024, 4, 1, 1023), (512, 1, 8, 0)):
        for window in (None, 128):
            for dtype in (f32, bf16):
                for bs in (128, 512):
                    seed = len(results)
                    q = _rows(seed, (2, kv * g, 32), dtype)
                    kc, vc = _rows(seed + 1000, (2, s, kv, 32), dtype), _rows(seed + 2000, (2, s, kv, 32), dtype)
                    name = f"decode s{s} kv{kv} g{g} t{t} w{window} {dtype} bs{bs}"
                    got = ops.flash_decode(q, kc, vc, t, window=window, block_s=bs)
                    want = flash_decode.flash_decode_ref(q, kc, vc, t, window=window)
                    results.append({"case": name, **_flash_close(name, got, want, dtype)})
    for hd, kv, g in ((256, 4, 2), (80, 8, 4), (128, 16, 2)):
        for window, cap, t in ((None, 50.0, 1030), (512, 50.0, 1030), (300, None, 77)):
            for dtype, bs in ((f32, 256), (bf16, 512)):
                seed = len(results)
                q = _rows(seed, (2, kv * g, hd), dtype)
                kc, vc = _rows(seed + 1000, (2, 1100, kv, hd), dtype), _rows(seed + 2000, (2, 1100, kv, hd), dtype)
                name = f"decode hd{hd} kv{kv} g{g} t{t} w{window} cap{cap} {dtype} bs{bs}"
                got = ops.flash_decode(q, kc, vc, t, window=window, cap=cap, block_s=bs)
                want = flash_decode.flash_decode_ref(q, kc, vc, t, window=window, cap=cap)
                results.append({"case": name, **_flash_close(name, got, want, dtype)})
    # t on the device: 0, either side of a split edge, the last slot; windows
    # narrower than one split and across one; equal to the host-int call
    b, s, kv, g, hd = 2, 1100, 4, 2, 256
    block, _ = flash_decode.split_plan(s, None, b * kv, flash_decode.sm_count("cuda"), 512)
    for dtype in (f32, bf16):
        seed = len(results)
        q = _rows(seed, (b, kv * g, hd), dtype)
        kc, vc = _rows(seed + 1000, (b, s, kv, hd), dtype), _rows(seed + 2000, (b, s, kv, hd), dtype)
        for window in (None, 5, block + 3):
            for t in (0, block - 1, block, s - 1):
                name = f"decode device t{t} w{window} split {block} {dtype}"
                got = ops.flash_decode(q, kc, vc, torch.tensor(t, dtype=torch.int32, device="cuda"),
                                       window=window, cap=50.0)
                if not torch.equal(got, ops.flash_decode(q, kc, vc, t, window=window, cap=50.0)):
                    raise AssertionError(f"{name}: differs from the host-int call")
                want = flash_decode.flash_decode_ref(q, kc, vc, t, window=window, cap=50.0)
                results.append({"case": name, **_flash_close(name, got, want, dtype)})
    if flash_decode.take_error("cuda"):
        raise AssertionError("the decode kernel set its error word on an in-range t")
    bad = ops.flash_decode(q, kc, vc, torch.tensor(s, dtype=torch.int32, device="cuda"))
    if not torch.isnan(bad.float()).all() or flash_decode.take_error("cuda") != 1:
        raise AssertionError("a device t outside the cache did not give NaN and the error word")
    torch.cuda.synchronize()
    emit("kernels.flash_edge", cases=len(results),
         max_abs_err_attn_f32=max(r["max_abs_err"] for r in results if "attn" in r["case"] and "float32" in r["case"]),
         max_abs_err_attn_bf16=max(r["max_abs_err"] for r in results if "attn" in r["case"] and "bfloat16" in r["case"]),
         max_abs_err_decode_f32=max(r["max_abs_err"] for r in results if "decode" in r["case"] and "float32" in r["case"]),
         max_abs_err_decode_bf16=max(r["max_abs_err"] for r in results if "decode" in r["case"] and "bfloat16" in r["case"]),
         row_excess_bf16=max(r["row_excess"] for r in results if r["row_excess"] is not None),
         row_tol=FLASH_ROW_TOL,
         detail=results, nvidia_smi=ctx["smi"])

    # time: gemma2-2b's prefill attention, B 4, S 8192, H 8, KV 4, hd 256, bf16, cap 50
    b, s, h, kv, hd, cap = 4, 8192, 8, 4, 256, 50.0
    q = _rows(50, (b, s, h, hd), bf16)
    k, v = _rows(51, (b, s, kv, hd), bf16), _rows(52, (b, s, kv, hd), bf16)
    n_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    timing = {}
    for label, window in (("global", None), ("local", 4096)):
        kern = lambda c=cap, w=window: flash_attn.flash_attention_cuda(
            q, k, v, causal=True, window=w, cap=c, block_q=128, block_k=128)
        got, want = kern(), flash_attn.flash_attention_ref(q, k, v, window=window, cap=cap)
        close = _flash_close(f"attn gemma2-2b {label}", got, want, bf16)
        # control: the band one 128-key block narrower (the rows it reaches lose up to 128 keys)
        control = _control_fails(f"attn gemma2-2b {label}", flash_attn.flash_attention_ref(
            q, k, v, window=(window or s) - 128, cap=cap), want)
        del got, want
        ms = cuda_ms(kern, reps=10, warmup=2)
        ms_nocap = cuda_ms(lambda w=window: kern(None, w), reps=10, warmup=2)
        plain_ms = cuda_ms(lambda w=window: flash_attn.flash_attention_ref(q, k, v, window=w, cap=cap),
                           reps=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's [B, heads, S, hd]
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        torch.testing.assert_close(lib().transpose(1, 2).float(), kern(None, window).float(),
                                   rtol=3e-2, atol=3e-2, msg=f"sdpa {label}")
        library_ms = cuda_ms(lib, reps=10, warmup=2)
        flops = 4 * b * h * hd * _window_pairs(s, window)
        bound_ms = 1e3 * max(flops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
        bound_by = "operations" if flops / BF16_OPS_PER_S >= n_bytes / HBM_BYTES_PER_S else "bytes"
        timing[label] = {"ms": ms, "ms_cap_none": ms_nocap,
                         "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "tflop_per_s": flops / ms * 1e-9, "tflop_per_s_cap_none": flops / ms_nocap * 1e-9,
                         "library_tflop_per_s": flops / library_ms * 1e-9,
                         **close, "control_row_excess": control, "ops": flops, "bytes": n_bytes}
        emit("kernels.timing", kernel="flash_attention", layer=label,
             shape=f"B {b}, S {s}, H {h}, KV {kv}, hd {hd}, bf16, cap {cap}, window {window}, "
             f"route {flash_attn.route(bf16, hd)}", **timing[label],
             plain_note="plain version: not a yardstick",
             library_note="scaled_dot_product_attention(enable_gqa=True), causal"
             + (" with a boolean window mask" if window else "") + ": no soft cap, so it "
             "stands beside ms_cap_none; timed as a yardstick, never used by the port",
             nvidia_smi=ctx["smi"])
    g = timing["global"]
    ctx["kernels"]["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn.py:74",
        "launches": None,  # from the lm phase's prefill
        "max_abs_err": max(t["max_abs_err"] for t in timing.values()),
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
    }
    del q, k, v

    # time: gemma2-2b's decode, B 4, a cache of 8704 slots, t 8191
    slots, t = 8704, 8191
    q = _rows(53, (b, h, hd), bf16)
    kc, vc = _rows(54, (b, slots, kv, hd), bf16), _rows(55, (b, slots, kv, hd), bf16)
    t_dev = torch.tensor(t, dtype=torch.int32, device="cuda")
    # one call captured in a CUDA graph, replayed after writing two values of
    # t into the same device tensor (first calls outside the capture)
    replays = []
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, kc, vc, t_dev, window=4096, cap=cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.flash_decode(q, kc, vc, t_dev, window=4096, cap=cap)
    # a call at twice the (batch, KV head) pairs between the capture and the
    # replays: it must not disturb what the graph holds
    wide = [torch.cat([x, x]) for x in (q, kc, vc)]
    want = flash_decode.flash_decode_ref(*wide, t, window=4096, cap=cap)
    replays.append({"t": t, "pairs": 2 * b * kv, **_flash_close(
        "decode after the capture, twice the pairs", ops.flash_decode(*wide, t_dev, window=4096, cap=cap),
        want, bf16)})
    del wide, want
    for t_r in (t, 5000):
        t_dev.fill_(t_r)
        graph.replay()
        torch.cuda.synchronize()
        want = flash_decode.flash_decode_ref(q, kc, vc, t_r, window=4096, cap=cap)
        replays.append({"t": t_r, **_flash_close(f"decode graph replay t{t_r}", replayed, want, bf16)})
    del graph, replayed
    t_dev.fill_(t)
    timing = {}
    for label, window in (("global", None), ("local", 4096)):
        kern = lambda c=cap, w=window: flash_decode.flash_decode_cuda(
            q, kc, vc, t_dev, window=w, cap=c, block_s=512)
        want = flash_decode.flash_decode_ref(q, kc, vc, t, window=window, cap=cap)
        close = _flash_close(f"decode gemma2-2b {label}", kern(), want, bf16)
        # control: one of the 512-position blocks dropped at the band's far edge
        control = _control_fails(f"decode gemma2-2b {label}", flash_decode.flash_decode_ref(
            q, kc, vc, t, window=(window or t + 1) - 512, cap=cap), want)
        # device time from a CUDA graph of 50 calls (a kernel of tens of
        # microseconds waits on Python in an eager loop: ms_eager beside it)
        ms = graph_ms(kern, 50)
        ms_nocap = graph_ms(lambda w=window: kern(None, w), 50)
        ms_eager = cuda_ms(kern, reps=100, warmup=5)
        plain_ms = cuda_ms(lambda w=window: flash_decode.flash_decode_ref(q, kc, vc, t, window=w, cap=cap),
                           reps=10, warmup=1)
        lo, hi = flash_decode.allowed_range(t, window)
        qt = q[:, :, None]  # [B, H, 1, hd]
        kt, vt = kc[:, lo : hi + 1].transpose(1, 2), vc[:, lo : hi + 1].transpose(1, 2)
        lib = lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        torch.testing.assert_close(lib()[:, :, 0].float(), kern(None, window).float(),
                                   rtol=3e-2, atol=3e-2, msg=f"sdpa decode {label}")
        library_ms = graph_ms(lib, 50)
        library_ms_eager = cuda_ms(lib, reps=100, warmup=5)
        n_pos = hi - lo + 1
        dec_bytes = 2 * (2 * q.numel() + 2 * b * n_pos * kv * hd)
        flops = 4 * b * h * hd * n_pos
        bound_ms = 1e3 * max(flops / BF16_OPS_PER_S, dec_bytes / HBM_BYTES_PER_S)
        bound_by = "operations" if flops / BF16_OPS_PER_S >= dec_bytes / HBM_BYTES_PER_S else "bytes"
        timing[label] = {"ms": ms, "ms_cap_none": ms_nocap, "ms_eager": ms_eager,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "library_ms_eager": library_ms_eager, "bound_ms": bound_ms, "bound_by": bound_by,
                         "gb_per_s": dec_bytes / ms * 1e-6, "gb_per_s_cap_none": dec_bytes / ms_nocap * 1e-6,
                         "library_gb_per_s": dec_bytes / library_ms * 1e-6,
                         **close, "control_row_excess": control, "ops": flops, "bytes": dec_bytes}
        plan = flash_decode.split_plan(slots, window, b * kv, flash_decode.sm_count("cuda"), 512)
        emit("kernels.timing", kernel="flash_decode", layer=label,
             shape=f"B {b}, {slots} slots, t {t} (a device int32), H {h}, KV {kv}, hd {hd}, "
             f"bf16, cap {cap}, window {window}, splits of {plan[0]} positions, {plan[1]} a pair",
             **timing[label], graph_replays=replays,
             plain_note="plain version: not a yardstick",
             library_note="scaled_dot_product_attention(enable_gqa=True) over the allowed "
             "positions: no soft cap, so it stands beside ms_cap_none; timed as a yardstick, "
             "never used by the port", timing_note="ms, ms_cap_none and library_ms from CUDA "
             "graphs of 50 calls; ms_eager and library_ms_eager from Python loops",
             nvidia_smi=ctx["smi"])
    g = timing["global"]
    ctx["kernels"]["flash_decode"] = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:67",
        "launches": None,  # from the lm phase's decode
        "max_abs_err": max(t["max_abs_err"] for t in timing.values()),
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
    }
    del q, kc, vc
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


def _record_calls(fn, outs: list):
    """``fn`` wrapped to keep a float32 CPU copy of every result."""

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        outs.append(out.float().cpu())
        return out

    return recorded


def _lm_run(cfg, params, tokens, feed=None) -> dict:
    """Prefill, then 8 greedy decode steps, through the entry points, with
    every attention output (before wo) recorded: the decode steps take the
    tokens ``feed`` when given, else their own argmax."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    dev = params["embed"].device
    attn = []
    real = ops.flash_attention, ops.flash_decode
    ops.flash_attention, ops.flash_decode = (_record_calls(f, attn) for f in real)
    try:
        t0 = time.monotonic()
        logits, cache = tfm.make_prefill_step(cfg)(params, tokens.to(dev))
        prefill_s = time.monotonic() - t0
        full = tfm.init_cache(cfg, 2, CHECK_PROMPT + 8, device=dev)
        full["k"][:, :, :CHECK_PROMPT], full["v"][:, :, :CHECK_PROMPT] = cache["k"], cache["v"]
        del cache
        step = tfm.make_serve_step(cfg, batch=2)
        out, fed = [logits.cpu()], []
        for i in range(8):
            fed.append(feed[i] if feed is not None else out[-1].argmax(dim=-1))
            logits, full = step(params, full, fed[-1].to(dev), CHECK_PROMPT + i)
            out.append(logits.cpu())
    finally:
        ops.flash_attention, ops.flash_decode = real
    return {"logits": out, "fed": fed, "attn": attn, "prefill_s": prefill_s}


def _on_card_and_cpu_agree(cfg_full, params) -> dict:
    """Full width, 2 layers, bfloat16: the same entry points on the card and
    on the CPU from the same weights, 2 prompts of 1,024 tokens, then 8
    greedy decode steps (all fed the CPU's tokens). Logits and every
    attention output are compared; then a control run on the card, its
    window one 128-key block short of the prompt, must fail the attention
    check."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    two = {"embed": params["embed"], "final_norm": params["final_norm"],
           "unembed": params["unembed"],
           "layers": {n: w[:2] for n, w in params["layers"].items()}}
    on_cpu = {"embed": two["embed"].cpu(), "final_norm": two["final_norm"].cpu(),
              "unembed": two["unembed"].cpu(),
              "layers": {n: w.cpu() for n, w in two["layers"].items()}}
    tokens = torch.as_tensor(synthetic.make_lm_batch(batch=2, seq_len=CHECK_PROMPT,
                                                     vocab=cfg.vocab, seed=1)["tokens"])
    cpu = _lm_run(cfg, on_cpu, tokens)
    before = dict(ops.LAUNCHES)
    card = _lm_run(cfg, two, tokens, feed=cpu["fed"])
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    if launched["flash_attention"] != cfg.n_layers or launched["flash_decode"] != 8 * cfg.n_layers:
        raise AssertionError(f"{launched} launches in a prefill and 8 decode steps of "
                             f"{cfg.n_layers} layers")
    ties, errs = [], []
    for i, (got, want) in enumerate(zip(card["logits"], cpu["logits"])):
        errs.append(float((got - want).abs().max()))
        if not torch.isfinite(got).all() or errs[-1] > LM_TOL:
            raise AssertionError(f"card vs CPU logits at step {i} differ by {errs[-1]} (> {LM_TOL})")
        for row in range(2):
            w, g = int(want[row].argmax()), int(got[row].argmax())
            if w != g:
                margin = float(want[row, w] - want[row, g])
                if margin > LM_TOL:
                    raise AssertionError(f"step {i} row {row}: card token {g}, CPU token "
                                         f"{w}, CPU margin {margin} (> {LM_TOL})")
                ties.append({"step": i, "row": row, "card": g, "cpu": w, "cpu_margin": margin})
    # attention outputs: 2 prefill layers, then 2 layers for each decode step
    attn = [_row_excess(g, w) / LM_ATTN_SLACK for g, w in zip(card["attn"], cpu["attn"])]
    if max(attn) > 1:
        raise AssertionError(f"card vs CPU attention outputs: {max(attn)} times the limit")
    short = dataclasses.replace(cfg, sliding_window=CHECK_PROMPT - 128)
    control = _lm_run(short, two, tokens, feed=cpu["fed"])
    control_attn = [_row_excess(g, w) / LM_ATTN_SLACK for g, w in zip(control["attn"], cpu["attn"])]
    if max(control_attn) <= 1:
        raise AssertionError(f"the control (window {short.sliding_window}) passes the "
                             f"attention check ({max(control_attn)})")
    return {"layers": cfg.n_layers, "prompts": [2, CHECK_PROMPT], "decode_steps": 8, "tol": LM_TOL,
            "prefill_max_abs_diff": errs[0], "decode_max_abs_diff": errs[1:],
            "logit_scale": float(cpu["logits"][0].abs().max()),
            "greedy_tokens_equal": not ties, "near_ties": ties,
            "attn_limit": {"row_tol": FLASH_ROW_TOL, "slack": LM_ATTN_SLACK},
            "attn_excess_prefill": attn[:2], "attn_excess_decode_max": max(attn[2:]),
            "control_window": short.sliding_window,
            "control_attn_excess_prefill": control_attn[:2],
            "control_attn_excess_decode_max": max(control_attn[2:]),
            "control_logits_max_abs_diff": max(float((g - w).abs().max()) for g, w in
                                               zip(control["logits"], cpu["logits"])),
            "cpu_prefill_s": cpu["prefill_s"]}


def _profile_lm(params, tokens, cfg, cache, step, tok, t) -> dict:
    """Where the device time goes: `torch.profiler` over one prefill and
    over 8 decode steps (after the timed runs; the decode steps write
    positions past the timed ones). Per window: wall seconds (profiling
    adds host time), the device's busy seconds (the sum of its activities'
    device time: one stream, so they do not overlap), the idle share and
    the top activities by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tfm

    def window(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        # device activity only (kernels, copies); the host ops that launched
        # them and CUPTI's "Command Buffer Full" waits carry the same time
        rows = [(e.key, e.self_device_time_total * 1e-6, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and e.key != "Command Buffer Full"]
        busy = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        return {"wall_s": wall, "device_busy_s": busy,
                "idle_share": 1.0 - busy / wall if busy else "not measured",
                "flash_s": {name: sum(d for k, d, _ in rows if tag in k) for name, tag in
                            (("flash_attention", "flash_attn"), ("flash_decode", "flash_decode"))},
                "top": [{"kernel": k[:120], "s": d, "calls": c} for k, d, c in rows[:12]]}

    out = {"prefill": window(lambda: tfm.make_prefill_step(cfg)(params, tokens))}

    def decode():
        nonlocal tok
        for i in range(8):
            logits, _ = step(params, cache, tok, t + i)
            tok = torch.argmax(logits, dim=-1)

    out["decode_8_steps"] = window(decode)
    return out


def phase_lm(ctx) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_decode, ops
    from repro_torch.models import transformer as tfm

    ctx.pop("collection", None)  # the serve phase's corpora go first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma2-2b")
    batch, prompt, slots, n_decode = LM_BATCH, LM_PROMPT, LM_SLOTS, LM_DECODE
    t0 = time.monotonic()
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [params["embed"], params["final_norm"], params["unembed"],
                        *params["layers"].values()])
    tokens = torch.as_tensor(synthetic.make_lm_batch(batch=batch, seq_len=prompt,
                                                     vocab=cfg.vocab, seed=0)["tokens"],
                             device="cuda")
    prefill = tfm.make_prefill_step(cfg)
    # one untimed prefill first: kernel builds (when the build phase did not
    # run), module loads and cuBLAS's first calls stay out of the timing
    prefill(params, tokens)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.monotonic()
    logits, cache = prefill(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    prefill_launches = dict(ops.LAUNCHES)
    if prefill_launches["flash_attention"] != cfg.n_layers or prefill_launches["flash_decode"]:
        raise AssertionError(f"prefill launched {prefill_launches} for {cfg.n_layers} layers")
    finite = bool(torch.isfinite(logits).all())
    full = tfm.init_cache(cfg, batch, slots, device="cuda")
    full["k"][:, :, :prompt], full["v"][:, :, :prompt] = cache["k"], cache["v"]
    del cache
    torch.cuda.empty_cache()
    step = tfm.make_serve_step(cfg, batch=batch)
    tok = torch.argmax(logits, dim=-1)
    step(params, full, tok, prompt)  # untimed: the timed first step rewrites position t
    step_s, seq0 = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    for t in range(prompt, prompt + n_decode):
        t1 = time.monotonic()
        logits, full = step(params, full, tok, t)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        finite &= bool(torch.isfinite(logits).all())
        seq0.append(int(tok[0]))
    decode_launches = dict(ops.LAUNCHES)
    if decode_launches["flash_decode"] != cfg.n_layers * n_decode or \
            decode_launches["flash_attention"]:
        raise AssertionError(f"decode launched {decode_launches} for {n_decode} steps of "
                             f"{cfg.n_layers} layers")
    if not finite:
        raise AssertionError("non-finite logits in prefill or decode")
    if flash_decode.take_error("cuda"):
        raise AssertionError("the decode kernel set its error word (a position outside the cache)")
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"]["flash_attention"] = prefill_launches["flash_attention"]
    ctx["launches"]["flash_decode"] = decode_launches["flash_decode"]
    steps = np.array(step_s)
    # each flash kernel's device time from the profiler (one prefill, 8
    # decode steps), over the timed runs' wall time
    profile = _profile_lm(params, tokens, cfg, full, step, tok, prompt + n_decode)
    attn_s = profile["prefill"]["flash_s"]["flash_attention"]
    decode_step_s = profile["decode_8_steps"]["flash_s"]["flash_decode"] / 8
    emit("lm", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, vocab=cfg.vocab, dtype=cfg.dtype,
         weight_bytes=weight_bytes, init_s=init_s, batch=batch, prompt=prompt,
         cache_slots=slots, cache_bytes=sum(x.numel() * x.element_size() for x in full.values()),
         prefill_s=prefill_s, prefill_tokens_per_s=batch * prompt / prefill_s,
         prefill_launches=prefill_launches, flash_attention_device_s=attn_s,
         flash_attention_share=attn_s / prefill_s,
         decode_steps=n_decode, decode_launches=decode_launches,
         decode_ms_p50=float(np.quantile(steps, 0.5)) * 1e3,
         decode_ms_p99=float(np.quantile(steps, 0.99)) * 1e3,
         decode_tokens_per_s=batch * n_decode / float(steps.sum()),
         flash_decode_device_ms_per_step=decode_step_s * 1e3,
         flash_decode_share=decode_step_s / float(steps.mean()),
         seq0_tokens=seq0[:16], logits_finite=finite, max_memory_allocated=peak,
         nvidia_smi=ctx["smi"])
    emit("lm.profile", **profile, nvidia_smi=ctx["smi"])
    del full
    torch.cuda.empty_cache()
    check = _on_card_and_cpu_agree(cfg, params)
    emit("lm.card_vs_cpu", **check, nvidia_smi=ctx["smi"])


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
             "experiment": phase_experiment, "resume": phase_resume, "serve": phase_serve,
             "lm": phase_lm}
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
