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
                  lexical scan must agree to the bit (also at 128 queries
                  with repeated terms, and above the term bitmap's
                  vocabulary); the dense score+top-k within 1e-5 with ids
                  equal except at float near-ties (the CPU tests' rule,
                  ``tests/_torch_parity.py``), at the serving buckets 8 and
                  128 with k 1000, and to the bit on integer-valued inputs
                  (float32 and bfloat16) and where most documents tie; a
                  query's dense result must be the same bits in a bucket of
                  8, 64 or 128; the lexical scan's packed-tile path
                  (uint8 and uint16 rows, bit-planes of 1, 17 and 18 bits)
                  to the bit against the unpacked kernel on the unpacked
                  tokens and against its plain version, on ragged rows,
                  PAD-only and zero-length rows, tiles that are not whole
                  warps and row ranges that start off a 4-byte boundary;
                  the flash attention and
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
                  graphs of 50 calls) beside its bound (the scan kernels:
                  the least work of their inputs, with the earlier designs'
                  bounds beside it), its achieved rate, registers and
                  spills, and the plain version's time, and, where one PyTorch call
                  computes the same function, that call's time
                  (``library_ms``; for the flash kernels
                  `scaled_dot_product_attention`, which has no soft cap,
                  beside the kernel run with ``cap=None``).
4. ``experiment`` the ``bm25-grid`` experiment at the ``mirex`` width
                  (2^23 docs x 128 tokens, vocab 65,536, 64 queries, k 1000,
                  5 models, 32 segments) through `runner.run_experiment` on
                  the card, first on the synchronous executor
                  (``pipelined=False``), then on the pipelined one
                  (``experiment.pipelined``: streamed segments, asynchronous
                  checkpoints); every segment must launch the scan kernel
                  once, and the pipelined run's files and checkpoint bytes
                  must be the synchronous run's. Each run reports its scan
                  span, docs/s, its busy share (the kernel calls' CUDA-event
                  time, on the stream each ran on, over that span), the
                  executor's spans and its peak device memory. Then the
                  same run with ``token_pack="auto"`` (17-bit planes) on the
                  same collection: run files and checkpoint bytes identical
                  to the unpacked run's, one launch a segment. Then
                  ``experiment.streamed``: `run_sharded_scan_job` over the
                  same corpus kept on the host (pinned once, before the
                  scan), streamed to the card by `prefetch_segments`, and
                  ``experiment.job``: the same job over the corpus on the
                  card. Both states and checkpoints must be the runner's
                  bit for bit; the streamed run's device memory above the
                  collection must stay within the device-resident job's
                  plus (prefetch_depth + 1) segments plus half a segment.
                  Then ``experiment.pipelined_again``: the pipelined runner
                  once more (the same files), and `torch.profiler` over one
                  device-resident job: the device time a segment of the scan
                  kernel, its list merge and everything else.
5. ``paper``      the paper's preparation and baseline jobs: the anchor-text
                  job (``make_links`` at 2^23 pages, 2^25 links of up to 6
                  tokens; ``extract_anchors`` on the card to 64 tokens a
                  page, byte for byte the CPU's run of the same inputs;
                  links/s, device memory, the share of pages with
                  anchors); Fig. 2 over 2^20 docs at the ``mirex`` widths
                  (``ql_lm``, k 1000): the numpy inverted index's build time
                  and time a query over 200 queries, the scan through the
                  lexical kernel at 50, 500, 1,000, 2,500 and 5,000 queries
                  (median of 3 after a warm-up), the index's answers equal
                  to the scan's (scores within 3e-5, ids by the near-tie
                  rule), C1 (time a query at 50 over at 5,000) and C2 (the
                  index/scan gap at 50 against at 5,000); the
                  models-per-pass curve on mirex-8M at 1, 2, 4 and 8 models
                  (the 4-model pass's rankings those of four single passes,
                  bit for bit) and the CLI's ``--bench`` at ``smoke`` size;
                  then ``examples/torch_quickstart.py`` in a process of its
                  own, which must exit with 0.
6. ``tune``       `tune.search` over the scan job's knobs (``chunk_size``,
                  ``prefetch_depth``, ``token_pack``; a chunk the plan
                  cannot cut is left out) on mirex-8M, 6 trials, each
                  trial's top-k state the default config's bytes; the
                  winner recorded in a `TuneCache`, then
                  ``run_experiment(tune_lookup=True)`` must hit and write
                  the default run's files; a lookup under the CPU's backend
                  signature must miss.
7. ``resume``     the ``smoke`` experiment crashed after its first segment,
                  then resumed, on the synchronous and on the pipelined
                  executor: run files byte-identical to an uninterrupted
                  run. Then the reliability layer on two scheduler workers
                  (two CUDA streams on the one card), 4 shards of 2
                  segments: seeded chaos schedules (seeds 0 and 1; retries
                  and speculation), a writer error that retries, each with
                  the clean run's files byte for byte, and a permanent crash
                  that surfaces its original error.
8. ``serve``      retrieval serving through `RetrievalService`: a
                  `DenseSession` over the ``dense_scan`` shape (2^24 docs x
                  256 dims, float32, 16 GiB resident; 4,096 queries, k 1000)
                  and a `LexicalSession` over the ``experiment`` phase's
                  corpus (4 waves of 256 queries); every dispatch must launch
                  its kernel once, sampled answers must match the plain
                  oracles; then a batch-size sweep at 8, 64 and 128; then the
                  lexical corpus resident packed (``token_pack="auto"``),
                  the same waves, every answer the unpacked session's.
9. ``mesh``       the mesh on one card, every mesh entry ``cuda:0`` and one
                  CUDA stream a shard: `cluster.search_mesh` over mirex-8M's
                  collection (``bm25-grid``, 5 models, 64 queries, k 1000)
                  on a (1,) mesh, a (4,) mesh over ``data`` and a (2, 2)
                  mesh over ``(data, model)``; each call's merged state
                  must equal, byte for byte, the one-shard scan job's
                  (`run_sharded_scan_job`, run in the same call), with one
                  kernel launch a shard; each call's seconds, docs/s and
                  device memory above the collection; one call under
                  ``set_sync_debug_mode("error")`` must make no host sync;
                  `collection_stats` over 4 shards must equal the unsharded
                  statistics exactly. Then `ShardedLexicalSession` on a (4,)
                  mesh over serve-lexical-8M's corpus (``ql_lm``), unpacked
                  and packed, beside `LexicalSession` on the same corpus: 4
                  waves of 256 queries through `RetrievalService`, every row
                  byte-identical, block p50 / p99 side by side, resident
                  bytes (and the device memory each session holds) equal
                  within 1 MB.
10. ``lm``        LM serving of gemma2-2b at its full width and depth (26
                  layers, bfloat16, seeded random weights, 6.4 GB) through
                  `make_prefill_step` and `make_serve_step`: 4 prompts of
                  8,192 tokens from `make_lm_batch` (twice the sliding
                  window; one untimed prefill first, then the timed one),
                  the cache copied into 8,704 slots, one untimed and 128
                  timed greedy
                  decode steps (``t`` a device int32 advanced on the card;
                  8 more under ``set_sync_debug_mode("error")`` must make
                  no host sync and give the host-int steps' logits and
                  tokens bit for bit); every layer's attention must launch the
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
11. ``lm_moe``    MoE serving of qwen3-moe-30b-a3b at full width (48
                  layers, d_model 2,048, 32 / 4 heads of 64, 128 experts
                  top-8, d_ff 768, vocab 151,936, bfloat16, seeded weights
                  on the card) on a 1x1 mesh of the card, its experts on the
                  ``fsdp_experts`` path. First the flash kernels at this
                  geometry (head_dim 64, 8 query heads a KV head) against
                  their plain versions, timed beside SDPA. Then the memory
                  plan (weights, caches, dispatch buffers against the free
                  memory; the depth is cut, and the cut printed, only if
                  they do not fit). Prefill of 4 prompts of 2,048 tokens
                  (``tokens_per_shard`` 8,192: capacity 640 an expert; the
                  share of routed pairs capacity drops, from an untimed
                  prefill), a 2,176-slot cache, 64 timed greedy steps with
                  ``t`` on the card (``tokens_per_shard`` 4: capacity 8);
                  48 attention launches in the prefill and 48 x 64 in
                  decode; decode p50 / p99 beside the weight-byte bound of a
                  step; the device idle share and each flash kernel's share
                  (`torch.profiler`); peak memory. Then the card against
                  the CPU at full width and 2 layers, 2 prompts of 256
                  tokens, from the same weights: logits within ``LM_TOL``,
                  greedy tokens of 8 steps equal except at a named logit
                  near-tie, and every layer's router choices equal except
                  where the experts that differ lie within
                  ``ROUTER_MARGIN`` of the k-th (counted and printed).

Each phase's wall time follows it (``phase_time``). The last three lines
are the card's ``nvidia-smi`` name and power limit, a
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
PHASES = ("env", "build", "kernels", "experiment", "paper", "tune", "resume", "serve", "mesh",
          "lm", "lm_moe")

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
# bfloat16 and TF32 dense tensor-core peaks (NVIDIA data sheet, H100 SXM at 700 W)
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
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


def _case_inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty, grid, device, repeat=False,
                 n_all_pad=0):
    """Random tokens from a small vocab (ties everywhere), query pads, and
    ``n_empty`` zero-length rows, with the epilogues of ``grid``; with
    ``repeat`` the second half of the queries repeats the first;
    ``n_all_pad`` rows keep their length but hold only PAD tokens."""
    import numpy as np
    import torch

    from repro_torch.core import anchors, scoring

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l_d + 1, size=n_d).astype(np.int32)
    lens[rng.choice(n_d, size=n_empty, replace=False)] = 0
    toks = rng.integers(0, vocab, size=(n_d, l_d)).astype(np.int32)
    toks[np.arange(l_d)[None, :] >= lens[:, None]] = scoring.PAD_TOKEN
    toks[rng.choice(n_d, size=n_all_pad, replace=False)] = scoring.PAD_TOKEN
    q = rng.integers(0, vocab, size=(n_q, l_q)).astype(np.int32)
    q_lens = rng.integers(1, l_q + 1, size=n_q)
    q[np.arange(l_q)[None, :] >= q_lens[:, None]] = scoring.PAD_TOKEN
    if repeat:
        q[n_q // 2 : 2 * (n_q // 2)] = q[: n_q // 2]
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


def _ptxas_of(name: str) -> list[dict]:
    """Registers, static shared memory and spills of a source's kernels, from
    the nvcc report of its build in this process."""
    from repro_torch.kernels import _build

    return _ptxas_kernels(_build.BUILD_LOG.get(name, {}).get("ptxas", ""))


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
    # name, seed, n_d, L_d, n_q, L_q, vocab, zero-length rows, grid, k, block_d, tile_d[, repeat]
    cases = [
        ("edge_mixed", 1, 300, 23, 7, 5, 30, 40, mixed, 37, 100, 16),
        ("k_above_docs", 2, 64, 16, 5, 3, 12, 8, mixed, 100, 64, 16),
        ("k_one", 3, 512, 40, 9, 4, 20, 10, mixed, 1, 128, 32),
        ("all_zero_length", 4, 32, 8, 3, 2, 5, 32, mixed, 10, 32, 16),
        ("bm25_ties", 5, 2048, 12, 16, 4, 6, 100, bm25_only, 50, 512, 16),
        ("pow2_k_small_block", 6, 4096, 64, 12, 8, 200, 64, mixed, 64, 32, 64),
        ("rows_of_200", 7, 1024, 200, 6, 4, 50, 16, mixed, 30, 512, 16),
        ("rows_of_300", 8, 512, 300, 5, 3, 60, 16, mixed, 30, 256, 32),
        # k_pad 4096: states longer than the corpus's share of any CTA
        ("long_states", 9, 8192, 24, 4, 4, 40, 64, mixed, 3000, 4096, 16),
        # 128 queries (a serving block), the second half repeating the first,
        # over many tiles: one term table, shared counts, 640 lists a CTA
        ("queries_128_repeated", 10, 16_384, 64, 128, 4, 300, 200, mixed, 100, 4096, 32, True),
        ("queries_128_one_model", 11, 32_768, 128, 128, 4, 2000, 100, bm25_only, 1000, 8192, 16,
         True),
        # 300 query terms in 75 queries: a vocabulary above the bitmap's 65,536
        ("vocab_above_bitmap", 12, 4096, 32, 75, 4, 200_000, 50, mixed, 64, 1024, 16),
    ]
    results = []
    for name, seed, n_d, l_d, n_q, l_q, vocab, n_empty, grid, k, block_d, tile_d, *rep in cases:
        q, w, ab, d, dl, modes = _case_inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty, grid, dev,
                                              repeat=bool(rep))
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
    # the least work of these inputs: every input read once and the outputs
    # written once; one lookup per token and one epilogue + compare per
    # (model, query, doc), counted at the INT32 rate (the epilogue's float
    # operations run at twice it); and the first design's compare-all count
    # beside it (one compare + one add per (query term, token) pair)
    n_bytes = sum(t.numel() * t.element_size() for t in args) + 2 * len(modes) * n_q * k * 4
    ops_count = n_seg * l_d + len(modes) * n_q * n_seg
    compare_all = 2 * n_q * l_q * n_seg * l_d
    bound_ms = 1e3 * max(ops_count / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    bound_by = "operations" if ops_count / INT32_OPS_PER_S >= n_bytes / HBM_BYTES_PER_S else "bytes"
    bound_compare_all_ms = 1e3 * compare_all / INT32_OPS_PER_S
    # a serving block's shape on the same segment: 128 queries, one model
    q128 = torch.as_tensor(synthetic.make_queries(corpus, n_queries=128, seed=2), device=dev)
    m128, w128, ab128 = scoring.lexical_epilogues((scoring.get_scorer("ql_lm"),), q128, stats)
    ms_128 = cuda_ms(lambda: lexical_scan.lexical_scan_topk_cuda(
        q128, w128, ab128, d, dl, modes=m128, k=k, block_d=16_384, tile_d=16), reps=20, warmup=2)
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
         bound_ms=bound_ms, bound_by=bound_by, ops=ops_count, bytes=n_bytes,
         bound_compare_all_ms=bound_compare_all_ms, compare_all_ops=compare_all,
         ms_128_queries_one_model=ms_128,
         geometry=lexical_scan.launch_geometry(len(modes), n_q, l_q, n_seg, l_d, k, 16_384, 16),
         ptxas=_ptxas_of("lexical_scan"), nvidia_smi=ctx["smi"])
    _packed_lexical_kernels(ctx, mixed, corpus, args, modes, k, kern, ms,
                            (q128, w128, ab128, m128))
    del corpus, d, dl, q, w, ab, args, plain, kern, q128, w128
    torch.cuda.empty_cache()
    _dense_kernels(ctx)


def _packed_lexical_kernels(ctx, mixed, corpus, args, modes, k, kern, unpacked_ms,
                            serving) -> None:
    """The lexical kernel's packed-tile path: bit-equal to the unpacked kernel
    on the unpacked tokens and to the plain version (which unpacks each
    block), for uint8 and uint16 rows and bit-planes of 1, 17 and 18 bits,
    on ragged row lengths, PAD-only and zero-length rows, tiles that are not
    a whole number of warps and a uint8 row range that starts off a 4-byte
    boundary; then its time per mirex-8M segment (17-bit planes) beside the
    unpacked time and the packed byte bound, and at a serving block's shape
    (``serving``: 128 queries, one model) beside the unpacked kernel."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import lexical_scan, ops

    dev = torch.device("cuda")
    # name, seed, n_d, L_d, n_q, L_q, vocab, zero-length rows, PAD-only rows, k, block_d,
    # tile_d, token_pack, first row (the rows before it are sliced off)
    cases = [
        ("u8_rows_23_off_boundary", 21, 301, 23, 7, 5, 200, 40, 10, 37, 300, 16, "8", 1),
        ("u8_rows_128_tile_48", 22, 2048, 128, 9, 4, 255, 30, 30, 50, 512, 48, "auto", 0),
        ("u8_rows_300_off_16_bytes", 23, 513, 300, 6, 3, 90, 16, 8, 30, 256, 32, "8", 1),
        ("u16_rows_300", 24, 512, 300, 5, 3, 60_000, 16, 16, 30, 256, 32, "16", 0),
        ("u16_rows_23_tile_40", 25, 4096, 23, 16, 4, 2048, 100, 100, 64, 1024, 40, "auto", 0),
        ("u16_rows_23_off_boundary", 26, 1025, 23, 8, 4, 65_535, 20, 5, 40, 512, 16, "16", 1),
        ("bits_1_rows_23", 27, 1024, 23, 4, 2, 1, 64, 64, 20, 256, 16, "bitpack", 0),
        ("bits_1_all_zero_length", 28, 64, 40, 3, 2, 1, 64, 0, 10, 64, 16, "bitpack", 0),
        ("bits_17_rows_128", 29, 8192, 128, 64, 4, 65_536, 200, 200, 100, 4096, 16, "auto", 0),
        ("bits_17_rows_300_tile_33", 30, 1024, 300, 5, 3, 65_536, 16, 16, 30, 512, 33, "auto",
         0),
        ("bits_18_rows_23", 31, 2048, 23, 9, 4, 200_000, 300, 300, 40, 512, 24, "auto", 0),
        ("bits_18_rows_128_queries_75", 32, 4096, 128, 75, 4, 200_000, 50, 50, 64, 1024, 16,
         "auto", 0),
    ]
    results = []
    for (name, seed, n_d, l_d, n_q, l_q, vocab, n_empty, n_pad, k_c, block_d, tile_d, mode,
         first) in cases:
        q, w, ab, d, dl, mds = _case_inputs(seed, n_d, l_d, n_q, l_q, vocab, n_empty, mixed, dev,
                                            n_all_pad=n_pad)
        spec = packing.make_spec(vocab, l_d, mode)
        p = torch.as_tensor(packing.pack_tokens(d.cpu().numpy(), spec), device=dev)
        d, dl, p = d[first:], dl[first:], p[first:]  # row slices stay contiguous
        before = ops.LAUNCHES["lexical_scan_topk"]
        got = ops.lexical_scan_topk(q, w, ab, p, dl, modes=mds, k=k_c, block_d=block_d,
                                    tile_d=tile_d, pack_spec=spec)
        unpacked = ops.lexical_scan_topk(q, w, ab, d, dl, modes=mds, k=k_c, block_d=block_d,
                                         tile_d=tile_d)
        plain = lexical_scan.lexical_scan_topk_ref(q, w, ab, p, dl, modes=mds, k=k_c,
                                                   block_d=block_d, tile_d=tile_d, pack_spec=spec)
        torch.cuda.synchronize()
        if ops.LAUNCHES["lexical_scan_topk"] != before + 2:
            raise AssertionError(f"{name}: the packed call did not launch the kernel")
        _compare(f"{name} packed against unpacked kernel", got, unpacked)
        results.append({"case": name, "mode": spec.mode, "bits": spec.bits,
                        "row_bytes": lexical_scan.row_bytes(p.shape[1], spec),
                        "start_byte_mod_16": p.data_ptr() % 16,
                        "max_abs_err": _compare(f"{name} packed against plain", got, plain)})
    emit("kernels.packed_edge", cases=results, nvidia_smi=ctx["smi"])

    # one mirex-8M segment in 17-bit planes: the same result as unpacked, then timed
    q, w, ab, d, dl = args
    n_seg, l_d = d.shape
    spec = packing.make_spec(65_536, l_d, "auto")
    p = torch.as_tensor(packing.pack_tokens(corpus.tokens, spec), device="cuda")
    pargs = (q, w, ab, p, dl)
    got = ops.lexical_scan_topk(*pargs, modes=modes, k=k, block_d=16_384, tile_d=16,
                                pack_spec=spec)
    torch.cuda.synchronize()
    _compare("full_segment packed against unpacked kernel", got, kern)
    plain = lexical_scan.lexical_scan_topk_ref(*pargs, modes=modes, k=k, block_d=16_384,
                                               pack_spec=spec)
    err = _compare("full_segment packed against plain", got, plain)
    ms = cuda_ms(lambda: lexical_scan.lexical_scan_topk_cuda(
        *pargs, modes=modes, k=k, block_d=16_384, tile_d=16, pack_spec=spec), reps=20, warmup=2)
    # the unpacked kernel again in the same call, for a side-by-side time
    ms_unpacked = cuda_ms(lambda: lexical_scan.lexical_scan_topk_cuda(
        *args, modes=modes, k=k, block_d=16_384, tile_d=16), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: lexical_scan.lexical_scan_topk_ref(
        *pargs, modes=modes, k=k, block_d=16_384, pack_spec=spec), reps=3)
    q128, w128, ab128, m128 = serving
    ms_128 = {name: cuda_ms(lambda tok=tok, ps=ps: lexical_scan.lexical_scan_topk_cuda(
        q128, w128, ab128, tok, dl, modes=m128, k=k, block_d=16_384, tile_d=16, pack_spec=ps),
        reps=20, warmup=2) for name, tok, ps in (("packed", p, spec), ("unpacked", d, None))}
    n_q = q.shape[0]
    # the unpacked row's bound with the packed tokens' bytes
    n_bytes = sum(t.numel() * t.element_size() for t in pargs) + 2 * len(modes) * n_q * k * 4
    ops_count = n_seg * l_d + len(modes) * n_q * n_seg
    bound_ms = 1e3 * max(ops_count / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    bound_by = "operations" if ops_count / INT32_OPS_PER_S >= n_bytes / HBM_BYTES_PER_S else "bytes"
    ctx["kernels"]["lexical_scan_topk[packed]"] = {
        "name": "lexical_scan_topk[packed]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lexical_scan.cu",
        "replaces": "src/repro/kernels/lexical_scan.py:96",
        "launches": None,  # from the experiment phase's packed run of the main path
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    emit("kernels.timing", kernel="lexical_scan_topk[packed]",
         shape=f"{n_seg}x{l_d} docs in {spec.bits}-bit planes ({spec.packed_width} int32 words "
         f"a row), {n_q}x{q.shape[1]} queries, {len(modes)} models, k {k}",
         ms=ms, unpacked_ms_same_call=ms_unpacked, unpacked_ms_earlier=unpacked_ms,
         ms_128_queries_one_model=ms_128["packed"],
         unpacked_ms_128_queries_one_model=ms_128["unpacked"],
         plain_ms=plain_ms, plain_note="plain version: not a yardstick", bound_ms=bound_ms,
         bound_by=bound_by, ops=ops_count, bytes=n_bytes, token_bytes=p.numel() * 4,
         unpacked_token_bytes=d.numel() * 4,
         geometry=lexical_scan.launch_geometry(len(modes), n_q, q.shape[1], n_seg,
                                               spec.packed_width, k, 16_384, 16, pack_spec=spec),
         nvidia_smi=ctx["smi"])


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
    import numpy as np
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
        # the serving buckets at k 1000, a block not a multiple of 8, bf16
        ("bucket_8_k1000", 12, 8, 65_536, 256, 1000, 4096, f32, False, 1),
        ("bucket_128_k1000", 13, 128, 65_536, 256, 1000, 4096, f32, False, 2),
        ("n_q_13", 14, 13, 8192, 256, 100, 1024, f32, False, 0),
        ("bf16_k1000", 15, 64, 65_536, 256, 1000, 4096, bf16, False, 0),
        ("integer_bf16_bucket_128_k1000", 16, 128, 32_768, 256, 1000, 4096, bf16, True, 1),
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
    # most documents tie: 90% of the rows are one integer vector, so their
    # scores are equal and only the ids order them; bit-equal, ids and all
    g = np.random.default_rng(17)
    qt = torch.tensor(g.integers(-3, 4, (64, 256)).astype(np.float32), device="cuda")
    dt = torch.tensor(g.integers(-3, 4, (32_768, 256)).astype(np.float32), device="cuda")
    dt[torch.tensor(g.random(32_768) < 0.9, device="cuda")] = dt[7].clone()
    _compare("most_docs_tie", tuple(t + 0.0 if t.is_floating_point() else t
                                    for t in ops.score_topk(qt, dt, k=1000, block_d=1024)),
             tuple(t + 0.0 if t.is_floating_point() else t
                   for t in score_topk.score_topk_ref(qt, dt, k=1000, block_d=1024)))
    results.append({"case": "most_docs_tie", "max_abs_err": 0.0, "bit_equal": True})
    # a query's scores and ids are the same bits in a bucket of 8, 64 or 128
    qb, db = _rows(18, (128, 256), f32), _rows(19, (65_536, 256), f32)
    full = ops.score_topk(qb, db, k=1000, block_d=4096)
    for n in (8, 64):
        _compare(f"bucket {n} against 128", ops.score_topk(qb[:n].contiguous(), db, k=1000,
                                                           block_d=4096),
                 (full[0][:n], full[1][:n]))
    emit("kernels.dense_edge", cases=results, bucket_independent=[8, 64, 128],
         nvidia_smi=ctx["smi"])

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
    q128 = _rows(25, (128, dim), f32)
    ms_128 = cuda_ms(lambda: score_topk.score_topk_cuda(q128, corpus, k=k, block_d=16_384),
                     reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: score_topk.score_topk_ref(q, corpus, k=k, block_d=16_384),
                       reps=2, warmup=1)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the library yardstick must run in full float32 (allow_tf32 False)")
    library_ms = cuda_ms(lambda: torch.topk(q @ corpus.T, k), reps=3, warmup=1)
    # least time at float32-level accuracy: the bytes, or three TF32
    # products per multiply-add on the tensor cores; the CUDA cores' FP32
    # pipe (one FMA per multiply-add, the earlier CUDA-core design's bound)
    # beside it
    ops_count = 2 * n_q * n_d * dim
    n_bytes = (q.numel() + corpus.numel()) * 4 + n_q * k * 8
    bound_ms = 1e3 * max(3 * ops_count / TF32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    bound_by = "operations" if 3 * ops_count / TF32_OPS_PER_S >= n_bytes / HBM_BYTES_PER_S \
        else "bytes"
    bound_fp32_pipe_ms = 1e3 * max(ops_count / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
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
         "never used by the port; float32 matmul with allow_tf32 False (the default)",
         bound_ms=bound_ms, bound_by=bound_by, bound_fp32_pipe_ms=bound_fp32_pipe_ms,
         ops=ops_count, tf32_ops=3 * ops_count, bytes=n_bytes, gb_per_s=n_bytes / ms * 1e-6,
         ms_128_queries=ms_128, ptxas=_ptxas_of("score_topk"), nvidia_smi=ctx["smi"])
    del corpus, q128  # 16 GiB: the experiment phase runs as it ran before this phase grew
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


class _KernelTime:
    """Device time of a run's scan-kernel calls: a CUDA event pair around
    each call of the kernel wrapper (its scan and merge kernels), recorded
    on the stream the call launches on (the worker's stream under the
    pipelined executor). Wraps ``ops.lexical_scan_topk`` for the ``with``
    body; it counts nothing and changes no argument or result."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops

        self.pairs = []
        self._real = real = ops.lexical_scan_topk

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kwargs)
            stop.record()
            self.pairs.append((start, stop))
            return out

        ops.lexical_scan_topk = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.lexical_scan_topk = self._real
        return False

    def seconds(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def _device_profile(fn) -> dict:
    """``fn()`` under `torch.profiler`: wall seconds (profiling adds host
    time), the device's busy seconds (the sum of its activities' device
    time; activities of several streams may overlap) and every device
    activity as ``(name, seconds, calls)``, longest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    rows.sort(key=lambda r: -r[1])
    return {"wall_s": wall, "device_busy_s": sum(r[1] for r in rows), "rows": rows}


def _span_totals(phases: dict, names) -> dict:
    """Total seconds of each named span over every label of a phase rollup."""
    return {n: sum(agg[n]["total_s"] for agg in phases.values() if n in agg) for n in names}


PIPELINE_SPANS = ("segment.prefetch_wait", "segment.fold", "segment.commit",
                  "segment.commit_submit", "ckpt.drain_wait", "ckpt.save")


def _ckpt_files(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _via_runner(spec, coll, out, **kw):
    """The lifecycle through `runner.run_experiment` on the card: a callable
    giving its report and the scan's measures (the ``experiment.scan`` span,
    the job's segments, phase rollup and counters) from the report."""
    from repro_torch.experiments import runner

    def run():
        report = runner.run_experiment(spec, out_dir=out, seed=0, collection=coll, device="cuda",
                                       trace_out=os.path.join(out, "trace.json"), **kw)
        job = report["job"]
        phases = job["obs"]["phases"]
        return report, {"pipelined": job["pipelined"], "segments": job["segments_total"],
                        "segments_run": job["segments_run"],
                        "scan_s": phases["(global)"]["experiment.scan"]["total_s"],
                        "phases": phases, "counters": job["obs"]["metrics"]["counters"]}
    return run


def _via_job(spec, corpus, queries, stats, out):
    """`run_sharded_scan_job` alone (pipelined, one device, no eval) over
    ``corpus``: a callable giving its result and its measures, the span
    being the call's wall time up to a device synchronisation."""
    import torch

    from repro_torch import obs
    from repro_torch.cluster import run_sharded_scan_job
    from repro_torch.obs import export

    def run():
        with obs.session() as (tr, met):
            t1 = time.monotonic()
            job = run_sharded_scan_job(
                queries, corpus, spec.scorers(), k=spec.k, chunk_size=spec.chunk_size,
                segment_chunks=spec.segment_chunks, stats=stats, ckpt_dir=out,
                devices=["cuda"], pipelined=True,
            )
            torch.cuda.synchronize()
            scan_s = time.monotonic() - t1
        return job, {"pipelined": True, "segments": job.segments_total,
                     "segments_run": job.segments_run, "scan_s": scan_s,
                     "phases": export.phase_rollup(tr), "counters": met.summary()["counters"]}
    return run


def _timed(run, n_docs: int, out: str):
    """``run()`` (from `_via_runner` or `_via_job`, writing under ``out``)
    on the card under the instruments: one launch of the scan kernel a
    segment run (checked), the scan span and docs/s, the busy share (the
    kernel calls' CUDA-event time over the span), the executor's spans and
    counters, and the peak device memory, in all and above what was
    allocated before the run (the prepared collection)."""
    import torch

    from repro_torch.kernels import ops

    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t1 = time.monotonic()
    with _KernelTime() as kt:
        result, m = run()
    wall_s = time.monotonic() - t1
    launches = ops.LAUNCHES["lexical_scan_topk"]
    if launches != m["segments_run"]:
        raise AssertionError(f"{launches} kernel launches for {m['segments_run']} segments run")
    kernel_s = kt.seconds()
    peak = torch.cuda.max_memory_allocated()
    counters = m.pop("counters")
    return result, {
        **m, "launches": launches, "wall_s": wall_s, "docs_per_s": n_docs / m["scan_s"],
        "kernel_device_s": kernel_s, "busy_share": kernel_s / m["scan_s"],
        "spans_s": _span_totals(m["phases"], PIPELINE_SPANS),
        "ckpt_written_bytes": counters.get("ckpt.written_bytes"),
        "staged_bytes": counters.get("pipeline.staged_bytes"),
        "max_memory_allocated": peak, "peak_above_base": peak - base,
    }


def _scan_profile(run, segments: int) -> dict:
    """Where a pipelined scan's device time goes, from one `torch.profiler`
    trace of ``run()``: the scan kernel, its list merge, and every other
    device activity (the fold's state merge and epilogue weights, the
    snapshot copies), each in ms a segment, with the top activities."""
    prof = _device_profile(run)
    rows = prof["rows"]
    scan = sum(d for k, d, _ in rows if "lexical_scan_kernel" in k)
    merge = sum(d for k, d, _ in rows if "lexical_scan_merge" in k)
    ms = 1e3 / segments
    return {"wall_s": prof["wall_s"], "device_busy_s": prof["device_busy_s"],
            "ms_per_segment": {"device": prof["device_busy_s"] * ms, "scan_kernel": scan * ms,
                               "list_merge_kernel": merge * ms,
                               "rest": (prof["device_busy_s"] - scan - merge) * ms},
            "top": [{"kernel": k[:120], "s": d, "calls": c} for k, d, c in rows[:12]]}


def _mirex_spec():
    """mirex-8M: ``bm25-grid`` (5 models) at the ``mirex`` widths, 2^23
    docs, 64 queries, k 1000, 32 segments of 262,144 docs, one shard."""
    from repro_torch.experiments import grid as exp_grid

    return dataclasses.replace(
        exp_grid.get_experiment("bm25-grid"),
        n_docs=1 << 23, n_queries=64, vocab=65_536, max_doc_len=128, k=1000,
        chunk_size=16_384, segment_chunks=16, n_shards=1,
    )


def _mirex_collection(ctx):
    """The experiment phase's mirex-8M collection, prepared here when that
    phase did not run (``--only``)."""
    if "collection" not in ctx:
        from repro_torch.experiments import runner

        ctx["collection"] = runner.prepare_collection(_mirex_spec(), seed=0, device="cuda")
    return ctx["collection"]


def phase_experiment(ctx) -> None:
    import numpy as np
    import torch

    from repro_torch.experiments import runner
    from repro_torch.tune import TuningConfig

    spec = _mirex_spec()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    coll = runner.prepare_collection(spec, seed=0, device="cuda")
    prepare_s = time.monotonic() - t0
    prepare_peak = torch.cuda.max_memory_allocated()
    n = spec.n_docs

    # the synchronous executor, as in the earlier slices
    out = os.path.join(OUT, "bm25-grid")
    report, sync = _timed(_via_runner(spec, coll, out, pipelined=False), n, out)
    _check_runs(report, spec.n_docs, spec.k)
    ctx["launches"]["lexical_scan_topk"] = sync["launches"]
    # the later phases' mirex-8M corpus, and the default run's files
    ctx["collection"], ctx["mirex_runs"] = coll, out
    emit("experiment", experiment=spec.name, n_docs=spec.n_docs, n_queries=spec.n_queries,
         vocab=spec.vocab, doc_len=spec.max_doc_len, k=spec.k, models=report["models"],
         prepare_s=prepare_s, prepare_max_memory_allocated=prepare_peak, **sync,
         map={m: v["map"] for m, v in report["metrics"].items()},
         p_at_10={m: v["p@10"] for m, v in report["metrics"].items()}, nvidia_smi=ctx["smi"])

    # the pipelined executor on the same collection: the same run files and
    # checkpoint bytes, one launch a segment
    out_pl = os.path.join(OUT, "bm25-grid-pipelined")
    _, pipe = _timed(_via_runner(spec, coll, out_pl, pipelined=True), n, out_pl)
    _same_scan(out, out_pl, pipe, sync, "pipelined")
    emit("experiment.pipelined", experiment=spec.name, run_files_identical=True,
         checkpoints_identical=True, **pipe, synchronous_scan_s=sync["scan_s"],
         synchronous_docs_per_s=sync["docs_per_s"], synchronous_busy_share=sync["busy_share"],
         nvidia_smi=ctx["smi"])

    # the same run with packed corpus segments (token_pack "auto": 17-bit
    # planes at vocab 65,536) on the synchronous executor, as measured
    # before: the run files and the checkpoint bytes are the unpacked run's
    out_p = os.path.join(OUT, "bm25-grid-packed")
    packed, pk = _timed(_via_runner(spec, coll, out_p, pipelined=False,
                                    tuning=TuningConfig(token_pack="auto")), n, out_p)
    resolved = packed["job"]["tuning"]["pack_resolved"]
    if resolved != "bitpack":
        raise AssertionError(f"token_pack auto resolved to {resolved!r} at vocab {spec.vocab}")
    _assert_same_runs(out, out_p, "packed")
    if pk["ckpt_written_bytes"] != sync["ckpt_written_bytes"]:
        raise AssertionError(f"checkpoint bytes written: unpacked {sync['ckpt_written_bytes']}, "
                             f"packed {pk['ckpt_written_bytes']}")
    ctx["launches"]["lexical_scan_topk[packed]"] = pk["launches"]
    emit("experiment.packed", experiment=spec.name, token_pack="auto", pack_resolved=resolved,
         bits=int(spec.vocab).bit_length(), run_files_identical=True, **pk,
         unpacked_scan_s=sync["scan_s"], unpacked_docs_per_s=sync["docs_per_s"],
         nvidia_smi=ctx["smi"])

    # the corpus kept on the host, pinned once before the scan, streamed to
    # the card prefetch_depth segments ahead of the fold; then the same job
    # over the corpus on the card, whose memory above the collection is the
    # scan's own (segments are slices): the streamed run may take that, its
    # depth + 1 staged segments (the fold may hold its last while the
    # producer stages the next depth) and less than one segment more
    t_pin = time.monotonic()
    host = (torch.from_numpy(coll.corpus.tokens).pin_memory(),
            torch.from_numpy(coll.corpus.lengths).pin_memory())
    pin_s = time.monotonic() - t_pin
    queries = torch.as_tensor(coll.queries, device="cuda")
    device_corpus = (torch.as_tensor(coll.corpus.tokens, device="cuda"),
                     torch.as_tensor(coll.corpus.lengths, device="cuda"))
    depth = TuningConfig().prefetch_depth
    # the host-to-card rate of one segment's tokens copied from the pinned
    # corpus alone, beside which the streamed run's prefetch wait is read
    rows = spec.chunk_size * spec.segment_chunks
    landing = torch.empty_like(device_corpus[0][:rows])
    h2d_ms = cuda_ms(lambda: landing.copy_(host[0][:rows], non_blocking=True), reps=8)
    h2d = {"segment_tokens_bytes": landing.numel() * 4, "ms": h2d_ms,
           "bytes_per_s": landing.numel() * 4 / (h2d_ms * 1e-3)}
    del landing
    out_s = os.path.join(OUT, "bm25-grid-streamed")
    job_s, streamed = _timed(_via_job(spec, host, queries, coll.stats, out_s), n, out_s)
    out_d = os.path.join(OUT, "bm25-grid-job")
    job_d, resident = _timed(_via_job(spec, device_corpus, queries, coll.stats, out_d), n, out_d)
    segment_bytes = rows * (spec.max_doc_len + 1) * 4
    limit = resident["peak_above_base"] + (depth + 1) * segment_bytes + segment_bytes // 2
    if streamed["peak_above_base"] > limit:
        raise AssertionError(f"streamed scan took {streamed['peak_above_base']} B of device "
                             f"memory above the collection, limit {limit}")
    last = os.path.join(out, "ckpt", f"step_{job_s.segments_total:08d}")
    want = [np.load(os.path.join(last, f"leaf_{i:05d}.npy")) for i in range(2)]
    for name, job in (("streamed", job_s), ("device-resident job", job_d)):
        got = [job.state.scores.cpu().numpy(), job.state.ids.cpu().numpy()]
        if any(a.tobytes() != b.tobytes() for a, b in zip(got, want)):
            raise AssertionError(f"the {name} state differs from the runner's")
    ckpts = _ckpt_files(os.path.join(out, "ckpt"))
    if _ckpt_files(out_s) != ckpts or _ckpt_files(out_d) != ckpts:
        raise AssertionError("the scan job's checkpoints differ from the runner's")
    emit("experiment.streamed", experiment=spec.name, corpus="host, pinned", pin_s=pin_s,
         pinned=host[0].is_pinned(), h2d_copy=h2d, prefetch_depth=depth, **streamed, memory_limit=limit,
         memory_limit_parts={"device_resident_peak_above_base": resident["peak_above_base"],
                             "staged_segments": (depth + 1) * segment_bytes,
                             "margin": segment_bytes // 2},
         state_identical=True, checkpoints_identical=True, nvidia_smi=ctx["smi"])
    emit("experiment.job", experiment=spec.name, corpus="card", run_after="experiment.streamed",
         **resident, state_identical=True, checkpoints_identical=True, nvidia_smi=ctx["smi"])

    # the pipelined runner once more, now that this process has run the
    # executor three times: is its first run slower only for being first?
    out_pl2 = os.path.join(OUT, "bm25-grid-pipelined-again")
    _, again = _timed(_via_runner(spec, coll, out_pl2, pipelined=True), n, out_pl2)
    _same_scan(out, out_pl2, again, sync, "pipelined again")
    # and where the device time of a pipelined scan goes (one profiled job,
    # after the timed runs: profiling slows the host)
    out_prof = os.path.join(OUT, "bm25-grid-profiled")
    shutil.rmtree(out_prof, ignore_errors=True)
    profile = _scan_profile(_via_job(spec, device_corpus, queries, coll.stats, out_prof),
                            spec.n_docs // (spec.chunk_size * spec.segment_chunks))
    emit("experiment.pipelined_again", experiment=spec.name, run_files_identical=True,
         checkpoints_identical=True, **{k: v for k, v in again.items() if k != "phases"},
         first_scan_s=pipe["scan_s"], profile=profile, nvidia_smi=ctx["smi"])
    del host, queries, device_corpus, job_s, job_d


def _same_scan(a: str, b: str, got: dict, want: dict, what: str) -> None:
    """Run files, checkpoint files and checkpoint bytes written of run ``b``
    equal those of run ``a``."""
    _assert_same_runs(a, b, what)
    if got["ckpt_written_bytes"] != want["ckpt_written_bytes"]:
        raise AssertionError(f"{what}: checkpoint bytes written {got['ckpt_written_bytes']}, "
                             f"{want['ckpt_written_bytes']} expected")
    if _ckpt_files(os.path.join(b, "ckpt")) != _ckpt_files(os.path.join(a, "ckpt")):
        raise AssertionError(f"{what}: the checkpoints differ from {a}'s")


def _assert_same_runs(a: str, b: str, what: str) -> None:
    names = sorted(os.listdir(os.path.join(a, "runs")))
    if names != sorted(os.listdir(os.path.join(b, "runs"))):
        raise AssertionError(f"{what}: run file names differ")
    for name in names:
        with open(os.path.join(a, "runs", name), "rb") as f:
            want = f.read()
        with open(os.path.join(b, "runs", name), "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{what}: run file {name} differs from {a}'s")


# phase paper: the paper's preparation and baseline jobs on the card. The
# anchor job at mirex-8M's pages with 4 links a page; Fig. 2 over 2^20 docs
# at the mirex widths (cut from mirex-8M so that the host builds the numpy
# index in seconds); the amortization curve on mirex-8M
ANCHOR_DOCS, ANCHOR_LINKS, ANCHOR_LINK_LEN, ANCHOR_MAX_LEN = 1 << 23, 1 << 25, 6, 64
FIG2_DOCS, FIG2_QUERIES, FIG2_INDEX_QUERIES = 1 << 20, (50, 500, 1000, 2500, 5000), 200
BENCH_SIZES = (1, 2, 4, 8)
# the index ranks as the scan within this (the reference's tests/test_scoring.py)
INDEX_TOL = 3e-5


def _paper_anchors(ctx, dev="cuda", n_docs=ANCHOR_DOCS, n_links=ANCHOR_LINKS) -> None:
    """The anchor-text job on the card, held to the CPU's bytes."""
    import torch

    from repro_torch.core import anchors
    from repro_torch.data import synthetic

    t0 = time.monotonic()
    dst, toks = synthetic.make_links(n_docs=n_docs, n_links=n_links, vocab=65_536,
                                     max_anchor_len=ANCHOR_LINK_LEN, seed=3, device=dev)
    links_s = time.monotonic() - t0
    d_dst, d_toks = torch.as_tensor(dst, device=dev), torch.as_tensor(toks, device=dev)

    def job():
        return anchors.extract_anchors(d_dst, d_toks, n_docs=n_docs, max_anchor_len=ANCHOR_MAX_LEN)

    job()  # warm-up: PyTorch's own kernels' first use
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    out, lens = job()
    torch.cuda.synchronize(dev)
    job_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    t0 = time.monotonic()
    want_out, want_lens = anchors.extract_anchors(torch.from_numpy(dst), torch.from_numpy(toks),
                                                  n_docs=n_docs, max_anchor_len=ANCHOR_MAX_LEN)
    cpu_s = time.monotonic() - t0
    for name, got, want in (("tokens", out, want_out), ("lengths", lens, want_lens)):
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            raise AssertionError(f"anchor {name} on the card differ from the CPU's")
    emit("paper.anchors", n_docs=n_docs, n_links=n_links, vocab=65_536,
         link_len=ANCHOR_LINK_LEN, max_anchor_len=ANCHOR_MAX_LEN, links_draw_s=links_s,
         job_s=job_s, links_per_s=n_links / job_s, cpu_job_s=cpu_s,
         output_bytes=out.numel() * out.element_size() + lens.numel() * 4,
         peak_above_inputs=peak, pages_with_anchors_share=float((lens > 0).float().mean()),
         anchor_tokens=int(lens.sum()), identical_to_cpu=True, nvidia_smi=ctx["smi"])


def _paper_fig2(ctx, dev="cuda", n_docs=FIG2_DOCS, sizes=FIG2_QUERIES,
                n_index=FIG2_INDEX_QUERIES) -> None:
    """Fig. 2: the scan (the lexical kernel) against the inverted index at
    50 to 5,000 queries; the index's answers must be the scan's."""
    import numpy as np
    import torch

    from _torch_parity import assert_rankings_close
    from repro_torch.configs import get_config
    from repro_torch.core import anchors, invindex, scan
    from repro_torch.core.scoring import get_scorer
    from repro_torch.data import synthetic
    from repro_torch.kernels import lexical_scan, ops
    from repro_torch.tune import TuningConfig

    cfg = get_config("mirex")
    k, chunk = cfg.k, cfg.chunk_size
    corpus = synthetic.make_corpus(n_docs=n_docs, vocab=cfg.vocab, max_len=cfg.max_doc_len,
                                   seed=5, device=dev)
    docs = (torch.as_tensor(corpus.tokens, device=dev),
            torch.as_tensor(corpus.lengths, device=dev))
    stats = anchors.collection_stats(*docs, vocab=cfg.vocab, chunk_size=chunk)
    queries = synthetic.make_queries(corpus, n_queries=max(sizes), seed=6)
    t0 = time.monotonic()
    index = invindex.build_index(corpus.tokens, corpus.lengths, vocab=cfg.vocab)
    build_s = time.monotonic() - t0
    t0 = time.monotonic()
    want_s, want_i = invindex.search(index, queries[:n_index], stats, k=k + DEEPER)
    index_q = (time.monotonic() - t0) / n_index
    scorer = get_scorer("ql_lm")
    points = []
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    for n in sizes:
        q = torch.as_tensor(queries[:n], device=dev)
        times = []
        for rep in range(4):  # a warm-up, then the median of 3
            t0 = time.perf_counter()
            state = scan.search_local(q, docs, scorer, k=k, chunk_size=chunk, stats=stats)
            torch.cuda.synchronize(dev)
            if rep:
                times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        geo = lexical_scan.launch_geometry(1, n, q.shape[1], n_docs, cfg.max_doc_len, k, chunk,
                                           TuningConfig().lex_tile_d)
        points.append({"queries": n, "scan_s": t, "scan_s_per_query": t / n,
                       "query_groups": geo["n_groups"], "group": geo["group"],
                       "index_over_scan": index_q / (t / n)})
    launches = ops.LAUNCHES["lexical_scan_topk"]
    if launches != 4 * len(sizes):
        raise AssertionError(f"{launches} scan launches for {4 * len(sizes)} scans")
    # the index's answers are the scan's (the largest run's first queries)
    assert_rankings_close(state.scores[:n_index].cpu().numpy(), state.ids[:n_index].cpu().numpy(),
                          want_s, want_i, what="scan against index", tol=INDEX_TOL)
    first, last = points[0], points[-1]
    emit("paper.fig2", n_docs=n_docs, vocab=cfg.vocab, doc_len=cfg.max_doc_len, scorer="ql_lm",
         k=k, chunk_size=chunk, index_build_s=build_s, index_nnz=index.nnz,
         index_queries_timed=n_index, index_s_per_query=index_q, points=points,
         launches=launches, scan_equals_index=True,
         c1_per_query_first_over_last=first["scan_s_per_query"] / last["scan_s_per_query"],
         c2_index_over_scan={str(first["queries"]): first["index_over_scan"],
                             str(last["queries"]): last["index_over_scan"]},
         nvidia_smi=ctx["smi"])


def _paper_bench(ctx, dev="cuda", sizes=BENCH_SIZES) -> None:
    """The models-per-pass curve on mirex-8M with the CLI's QL-LM grid; a
    4-model pass must give four single passes' rankings bit for bit. Then
    the CLI's ``--bench`` once at ``smoke`` size."""
    import torch

    from repro_torch.core import scan, scoring
    from repro_torch.experiments import bench
    from repro_torch.kernels import ops
    from repro_torch.launch import experiment as cli

    spec, coll = _mirex_spec(), _mirex_collection(ctx)
    lams = [0.05 + 0.9 * i / max(sizes) for i in range(max(sizes))]
    scorers = [scoring.make_variant("ql_lm", lam=round(x, 4)) for x in lams]
    q = torch.as_tensor(coll.queries, device=dev)
    docs = (torch.as_tensor(coll.corpus.tokens, device=dev),
            torch.as_tensor(coll.corpus.lengths, device=dev))
    stats = type(coll.stats)(*(t.to(dev) for t in coll.stats))
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    payload = bench.amortization_curve(q, docs, scorers, k=spec.k, chunk_size=spec.chunk_size,
                                       stats=stats, sizes=sizes)
    curve_launches = ops.LAUNCHES["lexical_scan_topk"]
    if curve_launches != 4 * len(sizes):  # a warm-up and 3 timed passes a size
        raise AssertionError(f"{curve_launches} launches for {4 * len(sizes)} passes")
    path = bench.write_bench_json(payload, os.path.join(OUT, "BENCH_experiments.json"))
    multi = scan.search_local_multi(q, docs, tuple(scorers[:4]), k=spec.k,
                                    chunk_size=spec.chunk_size, stats=stats)
    for m, s in enumerate(scorers[:4]):
        single = scan.search_local(q, docs, s, k=spec.k, chunk_size=spec.chunk_size, stats=stats)
        if not (torch.equal(multi.ids[m], single.ids)
                and torch.equal(multi.scores[m].view(torch.int32), single.scores.view(torch.int32))):
            raise AssertionError(f"{s.name}: the 4-model pass differs from its single pass")
    del docs
    out = os.path.join(OUT, "cli-bench")
    shutil.rmtree(out, ignore_errors=True)
    cli_json = os.path.join(OUT, "BENCH_experiments_smoke.json")
    ops.reset_launches()
    cli.main(["--experiment", "smoke", "--out", out, "--device", dev, "--no-trace", "--bench",
              "--bench-out", cli_json])
    cli_launches = ops.LAUNCHES["lexical_scan_topk"]
    with open(cli_json) as f:
        cli_payload = json.load(f)
    if cli_payload["sizes"] != [1, 2, 4, 8] or cli_launches < 16:
        raise AssertionError(f"--bench: sizes {cli_payload['sizes']}, {cli_launches} launches")
    emit("paper.bench", experiment=spec.name, n_docs=spec.n_docs, n_queries=spec.n_queries,
         k=spec.k, models=payload["models"], curve=payload["curve"],
         amortization_x=payload["amortization_x"], launches=curve_launches, written=path,
         four_model_pass_equals_single_passes=True,
         cli_smoke={"curve": cli_payload["curve"], "launches": cli_launches},
         nvidia_smi=ctx["smi"])


def phase_paper(ctx, dev="cuda") -> None:
    import subprocess

    _paper_anchors(ctx, dev)
    _paper_fig2(ctx, dev)
    _paper_bench(ctx, dev)
    # the port's quickstart, in a process of its own on the card
    t0 = time.monotonic()
    run = subprocess.run([sys.executable, os.path.join("examples", "torch_quickstart.py")]
                         + ([] if dev == "cuda" else ["--device", dev]),
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    if run.returncode != 0 or "scan == index scores" not in run.stdout:
        raise AssertionError(f"torch_quickstart.py exited {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    emit("paper.quickstart", returncode=run.returncode, wall_s=time.monotonic() - t0,
         last_line=run.stdout.strip().splitlines()[-1], nvidia_smi=ctx["smi"])


def phase_tune(ctx, dev="cuda", chunk_values=(8192, 16_384, 24_576, 32_768)) -> None:
    """The scan job's knob search on mirex-8M, its winner cached and looked
    up by ``run_experiment(tune_lookup=True)``: every trial's state is the
    default's, the lookup hits and writes the default run's files, and a
    lookup under the CPU's backend misses."""
    import torch

    from repro_torch import tune
    from repro_torch.experiments import runner
    from repro_torch.kernels import ops
    from repro_torch.tune import targets

    spec, coll = _mirex_spec(), _mirex_collection(ctx)
    root = os.path.join(OUT, "tune")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cache_file = os.path.join(root, "tune_cache.json")
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    t0 = time.monotonic()
    target = targets.scan_target(spec, coll, chunk_values=chunk_values, prefetch_values=(1, 2, 4),
                                 repeats=1, device=dev, name="mirex-8M")
    # 24,576 rows do not cut 2^23 docs into whole chunks: the space leaves it out
    uncut = [c for c in chunk_values if spec.n_docs % c]
    if not uncut or any(c.chunk_size in uncut for c in target.space.candidates()):
        raise AssertionError("the scan space admits a chunk the plan cannot cut")
    block = targets.tune_target(target, budget=6, seed=0, cache_path=cache_file)
    search_s = time.monotonic() - t0
    search_launches = ops.LAUNCHES["lexical_scan_topk"]
    del target
    torch.cuda.empty_cache()
    if search_launches < 1:
        raise AssertionError("the search launched no scan kernel")

    default_runs = ctx.get("mirex_runs")
    if default_runs is None:  # phase run alone (--only tune): the default run first
        default_runs = os.path.join(root, "default")
        runner.run_experiment(spec, out_dir=default_runs, collection=coll, device=dev)
    out = os.path.join(root, "lookup")
    ops.reset_launches()
    report = runner.run_experiment(spec, out_dir=out, collection=coll, device=dev,
                                   tune_lookup=True, tune_cache=cache_file)
    tuning = report["job"]["tuning"]
    if not tuning["cache_hit"] or tuning["config_hash"] != block["best"]["config_hash"]:
        raise AssertionError(f"--tune lookup: {tuning}, recorded {block['best']}")
    if ops.LAUNCHES["lexical_scan_topk"] != report["job"]["segments_run"]:
        raise AssertionError(f"{ops.LAUNCHES['lexical_scan_topk']} launches for "
                             f"{report['job']['segments_run']} segments")
    _assert_same_runs(default_runs, out, "tune lookup")
    cpu_cfg, cpu_hit = tune.best_config("scan_job", shape=block["shape"],
                                        backend=tune.backend_sig("cpu"), path=cache_file)
    if cpu_hit or cpu_cfg != tune.DEFAULT:
        raise AssertionError("a lookup under the CPU's backend found the card's winner")
    emit("tune", experiment=spec.name, shape=block["shape"], backend=block["backend"],
         budget=6, space_size=block["space_size"], trials=block["trials"],
         default=block["default"], best=block["best"], speedup_x=block["speedup_x"],
         search_s=search_s, search_launches=search_launches, trials_byte_identical=True,
         lookup={"cache_hit": True, "config_hash": tuning["config_hash"],
                 "chunk_size": tuning["chunk_size"], "pack_resolved": tuning["pack_resolved"],
                 "launches": report["job"]["segments_run"], "run_files_identical": True},
         cpu_backend_lookup_hit=False, nvidia_smi=ctx["smi"])


def phase_resume(ctx) -> None:
    from repro_torch.cluster import FaultSchedule, FaultSpec, WorkerCrash
    from repro_torch.experiments import grid as exp_grid
    from repro_torch.experiments import runner
    from repro_torch.kernels import ops

    spec = exp_grid.get_experiment("smoke")
    # on each executor: crash after the first segment's commit, then resume
    # from it; the run files are those of an uninterrupted run
    for pipelined in (False, True):
        tag = "-pipelined" if pipelined else ""
        clean = os.path.join(OUT, f"smoke-clean{tag}")
        crashed = os.path.join(OUT, f"smoke-crashed{tag}")
        for p in (clean, crashed):
            shutil.rmtree(p, ignore_errors=True)
        ops.reset_launches()
        runner.run_experiment(spec, out_dir=clean, device="cuda", pipelined=pipelined)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                runner.run_experiment(spec, out_dir=crashed, device="cuda", fail_at_segment=0,
                                      pipelined=pipelined)
        except WorkerCrash:
            pass
        else:
            raise AssertionError("the injected crash did not fire")
        report = runner.run_experiment(spec, out_dir=crashed, device="cuda", pipelined=pipelined)
        if report["job"]["resumed_from"] != 1 or report["job"]["segments_run"] != 1:
            raise AssertionError(f"resume did not start at segment 1: {report['job']}")
        if report["job"]["pipelined"] != pipelined:
            raise AssertionError(f"asked for pipelined={pipelined}, ran {report['job']['pipelined']}")
        _assert_same_runs(clean, crashed, f"crash and resume{tag}")
        emit("resume", experiment="smoke", pipelined=pipelined, crashed_after_segment=0,
             resumed_from=1, run_files_identical=True,
             launches=ops.LAUNCHES["lexical_scan_topk"], nvidia_smi=ctx["smi"])

    # the reliability layer on two workers, each on a CUDA stream of its own:
    # 4 shards of 2 segments (1,024 docs, one 128-doc chunk a segment)
    spec4 = dataclasses.replace(spec, n_docs=1024, n_shards=4, segment_chunks=1)
    coll = runner.prepare_collection(spec4, seed=0, device="cuda")
    clean4 = os.path.join(OUT, "smoke4-clean")
    shutil.rmtree(clean4, ignore_errors=True)
    runner.run_experiment(spec4, out_dir=clean4, collection=coll, device="cuda")
    runs = {}
    cases = [(f"chaos-seed{seed}", FaultSchedule.random(seed, n_shards=4, n_segments=2),
              {"max_retries": 2, "speculative": True}) for seed in (0, 1)]
    cases.append(("writer-error", FaultSchedule([FaultSpec("writer_error", shard=1, segment=1)]),
                  {"max_retries": 1}))
    for name, sched, kw in cases:
        out = os.path.join(OUT, f"smoke4-{name}")
        shutil.rmtree(out, ignore_errors=True)
        ops.reset_launches()
        rep = runner.run_experiment(spec4, out_dir=out, collection=coll, device="cuda",
                                    faults=sched, max_workers=2, **kw)
        _assert_same_runs(clean4, out, name)
        sched_stats = rep["job"]["scheduler"]
        if sched_stats["n_workers"] != 2:
            raise AssertionError(f"{name}: {sched_stats['n_workers']} workers, 2 expected")
        hard = [f for f in sched.fired if f["kind"] in ("crash", "writer_error")]
        if not hard or sched_stats["retries"] + sched_stats["speculative_launched"] < 1:
            raise AssertionError(f"{name}: no fault fired or none was retried: {sched.fired}")
        if ops.LAUNCHES["lexical_scan_topk"] < rep["job"]["segments_run"]:
            raise AssertionError(f"{name}: {ops.LAUNCHES['lexical_scan_topk']} launches for "
                                 f"{rep['job']['segments_run']} segments")
        runs[name] = {"fired": sched.fired, "scheduler": sched_stats,
                      "segments_run": rep["job"]["segments_run"],
                      "launches": ops.LAUNCHES["lexical_scan_topk"], "run_files_identical": True}
    # a crash on every attempt: the job fails with the shard's original error
    out = os.path.join(OUT, "smoke4-permanent")
    shutil.rmtree(out, ignore_errors=True)
    sched = FaultSchedule([FaultSpec("crash", shard=2, segment=1, phase="pre_commit",
                                     attempts="all")])
    try:
        runner.run_experiment(spec4, out_dir=out, collection=coll, device="cuda", faults=sched,
                              max_workers=2, max_retries=1)
    except WorkerCrash as e:
        if "injected failure before segment 1" not in str(e):
            raise
        permanent = {"error": f"{type(e).__name__}: {e}", "fired": sched.fired}
    else:
        raise AssertionError("a crash on every attempt did not fail the job")
    if sched.count_fired("crash") != 2:
        raise AssertionError(f"permanent crash fired {sched.count_fired('crash')} times, 2 expected")
    emit("resume.reliability", experiment="smoke", n_docs=spec4.n_docs, n_shards=4,
         segments_per_shard=2, max_workers=2, streams=2, runs=runs, permanent=permanent,
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
    coll = _mirex_collection(ctx)
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
    unpacked_bytes = session.resident_corpus_bytes
    del session, service
    torch.cuda.empty_cache()

    # the same corpus resident packed (token_pack "auto": 17-bit planes), the
    # same waves: every answer the unpacked session's, bit for bit
    session = LexicalSession(coll.corpus.tokens, coll.corpus.lengths, cfg.scorer, k=k,
                             chunk_size=chunk, stats=coll.stats, token_pack="auto")
    if session.pack_mode != "bitpack":
        raise AssertionError(f"the packed session resolved to {session.pack_mode!r}")
    service = RetrievalService({"lexical": session}, max_batch=n_wave, registry=Metrics())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.monotonic()
    for b, wave in enumerate(waves):
        rids = [service.submit(q, "lexical") for q in wave]
        results = service.poll()
        results.update(service.drain())
        _answered_once(results, rids)
        for j, r in enumerate(rids):
            want, got = answers[(b, j)], results[r]
            if not (np.array_equal(got.ids, want.ids)
                    and np.array_equal(got.scores.view(np.int32), want.scores.view(np.int32))):
                raise AssertionError(f"packed session: wave {b} query {j} differs from unpacked")
    wall_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    if launches["lexical_scan_topk"] != len(service.metrics) or launches["score_topk"]:
        raise AssertionError(f"{launches} kernel launches for {len(service.metrics)} "
                             "packed lexical dispatches")
    line = _serve_line(service, "lexical", wall_s, {"curve": []})
    emit("serve.lexical_packed", n_docs=session.n_docs, pack_mode=session.pack_mode,
         resident_bytes=session.resident_corpus_bytes, unpacked_resident_bytes=unpacked_bytes,
         token_bytes=session.resident_corpus_bytes - 4 * session.n_docs,
         unpacked_token_bytes=unpacked_bytes - 4 * session.n_docs, waves=4,
         wave_queries=n_wave, launches=launches, answers_bit_equal_to_unpacked=True,
         **{key: line[key] for key in ("dispatches", "queries", "buckets", "block_latency_ms",
                                       "us_per_query", "qps", "wall_s", "wall_qps")},
         nvidia_smi=ctx["smi"])


# phase mesh: search_mesh over mirex-8M's collection on meshes of cuda:0
# repeated (one CUDA stream a shard), then the sharded session over the
# serve-lexical-8M corpus
MESH_SHAPES = (((1,), ("data",)), ((4,), ("data",)), ((2, 2), ("data", "model")))
MESH_WAVES, MESH_WAVE_QUERIES = 4, 256


def _card_mesh(shape, names, dev="cuda"):
    """A mesh whose every entry is the one card: the shards share it."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import Mesh

    arr = np.empty(shape, dtype=object)
    arr.fill(torch.device(dev, 0) if dev == "cuda" else torch.device(dev))
    return Mesh(arr, names)


def _same_state(name, got, want) -> None:
    for g, w, what in ((got.scores, want.scores, "scores"), (got.ids, want.ids, "ids")):
        if g.cpu().numpy().tobytes() != w.cpu().numpy().tobytes():
            raise AssertionError(f"{name}: merged {what} differ from the one-shard job's")


def _waves(service, kind, waves) -> tuple[dict, float]:
    """Every wave through the service; answers keyed (wave, row), wall s."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    answers = {}
    for b, wave in enumerate(waves):
        rids = [service.submit(q, kind) for q in wave]
        results = service.poll()
        results.update(service.drain())
        _answered_once(results, rids)
        answers.update({(b, j): results[r] for j, r in enumerate(rids)})
    return answers, time.monotonic() - t0


def _mesh_sessions(coll, k, chunk, scorer, pack, waves, dev="cuda") -> dict:
    """`LexicalSession` and `ShardedLexicalSession` on a (4,) mesh of the
    card, the same corpus resident (packed or not), the same waves through
    `RetrievalService`: every row byte-identical, one launch a dispatch
    (sharded: one a shard), resident bytes equal within 1 MB."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs import Metrics
    from repro_torch.serve import LexicalSession, RetrievalService, ShardedLexicalSession

    out = {}
    for label in ("single", "sharded"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        if label == "single":
            session = LexicalSession(coll.corpus.tokens, coll.corpus.lengths, scorer, k=k,
                                     chunk_size=chunk, stats=coll.stats, token_pack=pack,
                                     device=dev)
            shards = 1
        else:
            mesh = _card_mesh((4,), ("data",), dev)
            session = ShardedLexicalSession(mesh, coll.corpus.tokens, coll.corpus.lengths,
                                            scorer, k=k, chunk_size=chunk, stats=coll.stats,
                                            token_pack=pack)
            if any(d.type != torch.device(dev).type for d in session._scan.devices):
                raise AssertionError("a shard of the sharded session is not on the card")
            shards = session.plan.n_shards
        held = torch.cuda.memory_allocated() - base
        service = RetrievalService({"lexical": session}, max_batch=MESH_WAVE_QUERIES,
                                   registry=Metrics())
        ops.reset_launches()
        answers, wall_s = _waves(service, "lexical", waves)
        launches = dict(ops.LAUNCHES)
        if launches["lexical_scan_topk"] != shards * len(service.metrics) or launches["score_topk"]:
            raise AssertionError(f"{label}: {launches} launches for {len(service.metrics)} "
                                 f"dispatches over {shards} shards")
        line = _serve_line(service, "lexical", wall_s, {"curve": []})
        out[label] = {"answers": answers, "resident_bytes": session.resident_corpus_bytes,
                      "device_bytes_held": held, "pack_mode": session.pack_mode,
                      "shards": shards, "launches": launches,
                      **{key: line[key] for key in ("dispatches", "queries", "block_latency_ms",
                                                    "us_per_query", "qps", "wall_s")}}
        del session, service
    single, sharded = out["single"], out["sharded"]
    for key, want in single.pop("answers").items():
        got = sharded["answers"][key]
        if not (np.array_equal(got.ids, want.ids)
                and np.array_equal(got.scores.view(np.int32), want.scores.view(np.int32))):
            raise AssertionError(f"sharded session ({pack}): wave {key[0]} row {key[1]} differs")
    del sharded["answers"]
    for key in ("resident_bytes", "device_bytes_held"):
        if abs(sharded[key] - single[key]) > 1 << 20:
            raise AssertionError(f"sharded session ({pack}): {key} {sharded[key]} against "
                                 f"{single[key]}")
    if sharded["pack_mode"] != single["pack_mode"]:
        raise AssertionError(f"pack modes {sharded['pack_mode']} / {single['pack_mode']}")
    return {"token_pack": pack, "rows_byte_identical": True, "single": single,
            "sharded": sharded}


def phase_mesh(ctx, dev="cuda", spec=None) -> None:
    import torch

    from repro_torch import cluster
    from repro_torch.core import anchors
    from repro_torch.core.scoring import CollectionStats
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    spec = spec or _mirex_spec()
    coll = _mirex_collection(ctx)
    n, k, chunk = spec.n_docs, spec.k, spec.chunk_size
    scorers = spec.scorers()
    docs = (torch.as_tensor(coll.corpus.tokens, device=dev),
            torch.as_tensor(coll.corpus.lengths, device=dev))
    queries = torch.as_tensor(coll.queries, device=dev)
    stats = CollectionStats(*(t.to(dev) for t in coll.stats))

    # the one-shard scan job in this call (pipelined, checkpointed, one device)
    out = os.path.join(OUT, "mesh-job")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    job = cluster.run_sharded_scan_job(
        queries, docs, scorers, k=k, chunk_size=chunk, segment_chunks=spec.segment_chunks,
        stats=stats, ckpt_dir=out, devices=[dev], pipelined=True)
    torch.cuda.synchronize()
    job_s = time.monotonic() - t0
    want = job.state

    base = torch.cuda.memory_allocated()
    meshes, launches = [], {}
    for shape, names in MESH_SHAPES:
        mesh = _card_mesh(shape, names, dev)
        fn = cluster.search_mesh(mesh, queries, docs, scorers, k=k, chunk_size=chunk,
                                 stats=stats)
        if any(d.type != torch.device(dev).type for d in fn.devices):
            raise AssertionError(f"mesh {shape}: a shard is not on the card")
        _same_state(f"mesh {shape}, first call", fn(queries, docs, stats), want)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t1 = time.monotonic()
        got = fn(queries, docs, stats)
        torch.cuda.synchronize()
        call_s = time.monotonic() - t1
        launched = dict(ops.LAUNCHES)
        if launched["lexical_scan_topk"] != len(fn.devices) or launched["score_topk"]:
            raise AssertionError(f"mesh {shape}: {launched} launches for {len(fn.devices)} shards")
        _same_state(f"mesh {shape}", got, want)
        launches[str(shape)] = launched["lexical_scan_topk"]
        meshes.append({"shape": list(shape), "axes": list(names), "shards": len(fn.devices),
                       "streams": sum(s is not None for s in fn.streams),
                       "per_shard_docs": fn.per_shard, "call_s": call_s, "docs_per_s": n / call_s,
                       "launches": launched["lexical_scan_topk"], "state_identical": True,
                       "peak_above_base": torch.cuda.max_memory_allocated() - base})
        del got

    # no host sync inside a call (the 2x2 mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(queries, docs, stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same_state("mesh (2, 2) under sync debug mode", got, want)
    del got, fn

    # the statistics job over 4 shards of the card: the unsharded counts exactly
    t1 = time.monotonic()
    sharded_stats = anchors.collection_stats(*docs, spec.vocab, chunk_size=chunk,
                                             mesh=_card_mesh((4,), ("data",), dev))
    torch.cuda.synchronize()
    stats_s = time.monotonic() - t1
    for name, a, b in zip(CollectionStats._fields, sharded_stats, stats):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"sharded collection_stats: {name} differs")
    ctx.setdefault("paths", {})["mesh"] = {"lexical_scan_topk": launches}
    emit("mesh", experiment=spec.name, n_docs=n, n_queries=spec.n_queries, k=k,
         models=[s.name for s in scorers], chunk_size=chunk, job_s=job_s,
         job_docs_per_s=n / job_s, job_segments=job.segments_run, meshes=meshes,
         sync_debug_mode="error", host_syncs=0, stats_shards=4, stats_s=stats_s,
         stats_identical=True, device="cuda:0 in every mesh entry, one CUDA stream a shard",
         nvidia_smi=ctx["smi"])
    del docs, queries, job, want
    torch.cuda.empty_cache()

    # the sharded session over serve-lexical-8M's corpus, unpacked and packed
    waves = [synthetic.make_queries(coll.corpus, n_queries=MESH_WAVE_QUERIES, seed=10 + b)
             for b in range(MESH_WAVES)]
    for pack in ("none", "auto"):
        line = _mesh_sessions(coll, k, chunk, "ql_lm", pack, waves, dev)
        emit("mesh.sharded_session", n_docs=n, mesh=[4], axes=["data"], scorer="ql_lm",
             waves=MESH_WAVES, wave_queries=MESH_WAVE_QUERIES, **line, nvidia_smi=ctx["smi"])
    torch.cuda.empty_cache()


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


def _profile_lm(params, tokens, prefill, cache, step, tok, t) -> dict:
    """Where the device time goes: `torch.profiler` over one prefill and
    over 8 decode steps (after the timed runs; the decode steps write
    positions past the timed ones, from ``t``, a device int32 advanced in
    place). Per window: wall seconds (profiling adds host time), the
    device's busy seconds (one stream, so its activities do not overlap),
    the idle share and the top activities by device time."""
    import torch

    def window(fn):
        prof = _device_profile(fn)
        rows, busy, wall = prof["rows"], prof["device_busy_s"], prof["wall_s"]
        return {"wall_s": wall, "device_busy_s": busy,
                "idle_share": 1.0 - busy / wall if busy else "not measured",
                "flash_s": {name: sum(d for k, d, _ in rows if tag in k) for name, tag in
                            (("flash_attention", "flash_attn"), ("flash_decode", "flash_decode"))},
                "top": [{"kernel": k[:120], "s": d, "calls": c} for k, d, c in rows[:12]]}

    out = {"prefill": window(lambda: prefill(params, tokens))}

    def decode():
        nonlocal tok
        for _ in range(8):
            logits, _ = step(params, cache, tok, t)
            tok = torch.argmax(logits, dim=-1)
            t.add_(1)

    out["decode_8_steps"] = window(decode)
    return out


def _device_t_step(params, cache, step, tok, t0: int, n: int = 8) -> dict:
    """The serve step with ``t`` on the card makes no host sync: ``n`` steps
    run under `torch.cuda.set_sync_debug_mode("error")` from a copy of the
    cache, beside ``n`` steps with a host-int ``t`` from the cache itself
    (positions ``t0`` on, past the timed ones). Same kernels, same inputs:
    logits and greedy tokens must be the host-int steps' bit for bit."""
    import torch

    copy = {name: x.clone() for name, x in cache.items()}
    t_dev = torch.tensor(t0, dtype=torch.int32, device="cuda")
    tok_h = tok_d = tok
    torch.cuda.synchronize()
    for i in range(n):
        want, cache = step(params, cache, tok_h, t0 + i)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, copy = step(params, copy, tok_d, t_dev)
            tok_d = torch.argmax(got, dim=-1)
            t_dev.add_(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        tok_h = torch.argmax(want, dim=-1)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"device-t step {i}: logits differ from the host-int step's")
        if not torch.equal(tok_d, tok_h):
            raise AssertionError(f"device-t step {i}: greedy tokens differ")
    for name in cache:
        if not torch.equal(copy[name], cache[name]):
            raise AssertionError(f"device-t steps wrote another {name} cache")
    del copy
    torch.cuda.empty_cache()
    return {"steps": n, "positions": [t0, t0 + n - 1], "sync_debug_mode": "error",
            "logits_bit_equal": True, "greedy_tokens_equal": True, "cache_equal": True}


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
    # the position lives on the card and advances there, as the decode CLI's
    t = torch.tensor(prompt, dtype=torch.int32, device="cuda")
    step(params, full, tok, t)  # untimed: the timed first step rewrites position t
    step_s, seq0 = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(n_decode):
        t1 = time.monotonic()
        logits, full = step(params, full, tok, t)
        tok = torch.argmax(logits, dim=-1)
        t.add_(1)
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
    device_t = _device_t_step(params, full, step, tok, prompt + n_decode)
    emit("lm.device_t", **device_t, nvidia_smi=ctx["smi"])
    # each flash kernel's device time from the profiler (one prefill, 8
    # decode steps), over the timed runs' wall time
    profile = _profile_lm(params, tokens, prefill, full, step, tok,
                          torch.tensor(prompt + n_decode + 8, dtype=torch.int32, device="cuda"))
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


# phase lm_moe: qwen3-moe-30b-a3b at full width and depth on a 1x1 mesh of
# the card: 4 prompts of 2,048 tokens into a 2,176-slot cache (a multiple of
# decode_block_s 128 past the prompt), then 64 greedy steps; the card-vs-CPU
# check on 2 prompts of 256 tokens at 2 layers
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_BATCH, MOE_PROMPT, MOE_SLOTS, MOE_DECODE, MOE_CHECK_PROMPT = 4, 2048, 2176, 64, 256
# card against CPU: a token's experts may differ only where the CPU's
# probabilities of the experts that differ lie within this many nats of its
# k-th: the float32 router logits come from bfloat16 activations that the
# two devices round at other places (about 2^-8 relative a rounding, a few
# 1e-3 on a logit of O(1) after two layers), so a flip needs a near-tie
ROUTER_MARGIN = 0.05


def _moe_flash_geometry(ctx, dev="cuda") -> None:
    """The flash kernels at the MoE model's geometry (head_dim 64, 8 query
    heads a KV head, no cap, no window) against their plain versions, timed
    beside SDPA, before the weights take the card."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn, flash_decode

    bf16 = torch.bfloat16
    cfg = get_config(MOE_ARCH)
    b, s, h, kv, hd = MOE_BATCH, MOE_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _rows(60, (b, s, h, hd), bf16)
    k, v = _rows(61, (b, s, kv, hd), bf16), _rows(62, (b, s, kv, hd), bf16)
    kern = lambda: flash_attn.flash_attention_cuda(q, k, v, causal=True, window=None, cap=None,
                                                   block_q=128, block_k=128)
    close = _flash_close("attn qwen3-moe", kern(), flash_attn.flash_attention_ref(
        q, k, v, window=None, cap=None), bf16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    torch.testing.assert_close(lib().transpose(1, 2).float(), kern().float(), rtol=3e-2,
                               atol=3e-2, msg="sdpa qwen3-moe")
    flops = 4 * b * h * hd * _window_pairs(s, None)
    n_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    attn = {"ms": cuda_ms(kern, reps=20, warmup=2),
            "plain_ms": cuda_ms(lambda: flash_attn.flash_attention_ref(q, k, v, window=None,
                                                                        cap=None), reps=2),
            "library_ms": cuda_ms(lib, reps=20, warmup=2),
            "bound_ms": 1e3 * max(flops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S),
            "bound_by": "operations" if flops / BF16_OPS_PER_S >= n_bytes / HBM_BYTES_PER_S
            else "bytes", **close, "route": flash_attn.route(bf16, hd),
            "shape": f"B {b}, S {s}, H {h}, KV {kv}, hd {hd}, bf16, causal, no cap, no window"}
    del q, k, v, qt, kt, vt
    t = MOE_PROMPT + MOE_DECODE - 1
    q = _rows(63, (b, h, hd), bf16)
    kc, vc = _rows(64, (b, MOE_SLOTS, kv, hd), bf16), _rows(65, (b, MOE_SLOTS, kv, hd), bf16)
    t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
    kern = lambda: flash_decode.flash_decode_cuda(q, kc, vc, t_dev, window=None, cap=None,
                                                  block_s=512)
    close = _flash_close("decode qwen3-moe", kern(), flash_decode.flash_decode_ref(
        q, kc, vc, t, window=None, cap=None), bf16)
    kt, vt = kc[:, : t + 1].transpose(1, 2), vc[:, : t + 1].transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt, enable_gqa=True)
    torch.testing.assert_close(lib()[:, :, 0].float(), kern().float(), rtol=3e-2, atol=3e-2,
                               msg="sdpa decode qwen3-moe")
    dec_bytes = 2 * (2 * q.numel() + 2 * b * (t + 1) * kv * hd)
    flops = 4 * b * h * hd * (t + 1)
    dec = {"ms": graph_ms(kern, 50),
           "plain_ms": cuda_ms(lambda: flash_decode.flash_decode_ref(q, kc, vc, t, window=None,
                                                                      cap=None), reps=10),
           "library_ms": graph_ms(lib, 50),
           "bound_ms": 1e3 * max(flops / BF16_OPS_PER_S, dec_bytes / HBM_BYTES_PER_S),
           "bound_by": "operations" if flops / BF16_OPS_PER_S >= dec_bytes / HBM_BYTES_PER_S
           else "bytes", **close,
           "shape": f"B {b}, {MOE_SLOTS} slots, t {t} (a device int32), H {h}, KV {kv}, "
           f"hd {hd}, bf16, no cap, no window"}
    del q, kc, vc, kt, vt
    torch.cuda.empty_cache()
    for name, line in (("flash_attention", attn), ("flash_decode", dec)):
        if name in ctx["kernels"]:  # the kernels phase ran
            ctx["kernels"][name]["moe_geometry"] = {key: line[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    emit("lm_moe.flash", arch=MOE_ARCH, flash_attention=attn, flash_decode=dec,
         timing_note="decode ms and library_ms from CUDA graphs of 50 calls; the plain "
         "versions are not yardsticks; SDPA is timed as a yardstick, never used by the port",
         nvidia_smi=ctx["smi"])


def _moe_memory(cfg, free: int) -> dict:
    """Weights, caches and the prefill's dispatch buffers against the free
    device memory; the depth that fits (the config's, unless it is cut)."""
    from repro_torch.models import moe

    d, f, e, v = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.vocab
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layer = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d + d * e + 3 * e * d * f + 2 * d)
    fixed = 2 * (2 * v * d + d)
    cache = 2 * 2 * MOE_BATCH * (MOE_SLOTS + MOE_PROMPT) * kv * hd  # a layer: full + prefill's
    tokens = MOE_BATCH * MOE_PROMPT
    cap = moe.capacity_for(tokens, cfg.top_k, e, cfg.capacity_factor)
    # h and y [E, C, D], g, u and act(g) u [E, C, F] in bfloat16; the
    # residual, norms, q/k/v/o and the combine's terms [T, D]; a layer's
    # float32 draw at init (one expert stack)
    dispatch = 2 * e * cap * (2 * d + 3 * f) + 16 * 2 * tokens * d + 4 * e * d * f
    margin = 2 << 30
    layers = cfg.n_layers
    while layers > 1 and fixed + layers * (layer + cache) + dispatch + margin > free:
        layers -= 1
    return {"free_bytes": free, "weight_bytes": fixed + cfg.n_layers * layer,
            "cache_bytes": cfg.n_layers * 2 * 2 * MOE_BATCH * MOE_SLOTS * kv * hd,
            "dispatch_bytes": dispatch, "margin_bytes": margin, "capacity_prefill": cap,
            "needed_bytes": fixed + cfg.n_layers * (layer + cache) + dispatch + margin,
            "layers": layers, "depth_cut": layers != cfg.n_layers}


def _counting_dispatch(kept: list):
    """`moe._dispatch` wrapped to keep each call's kept-assignment count (a
    device tensor: no host sync)."""
    from repro_torch.models import moe

    real = moe._dispatch

    def counted(*args, **kwargs):
        h, slot, keep = real(*args, **kwargs)
        kept.append(keep.sum())
        return h, slot, keep

    return real, counted


def _moe_contexts(cfg, dev, prefill_tokens: int, decode_tokens: int):
    """Prefill (``seq``) and decode (``train``) contexts on a 1x1 mesh of
    ``dev``, capacity from the tokens each step routes, as the reference's
    smoke tests and CLI build them."""
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.models import transformer as tfm

    mesh = _card_mesh((1, 1), ("data", "model"), dev)
    rules = rules_for_mesh(mesh)
    return (tfm.make_context(cfg, mesh, rules, tokens_per_shard=prefill_tokens, moe_mode="seq"),
            tfm.make_context(cfg, mesh, rules, tokens_per_shard=decode_tokens))


def _moe_run(cfg, params, tokens, dev, feed=None) -> dict:
    """Prefill, then 8 greedy decode steps, with every router call's
    probabilities and choices recorded; the decode steps take ``feed``'s
    tokens when given, else their own argmax."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    b, p = tokens.shape
    routes = []
    real = moe.router_topk

    def recording(logits, k):
        probs, w, ids = real(logits, k)
        routes.append((probs.float().cpu(), ids.cpu()))
        return probs, w, ids

    ctx_p, ctx_d = _moe_contexts(cfg, dev, b * p, b)
    moe.router_topk = recording
    try:
        logits, cache = tfm.make_prefill_step(ctx_p)(params, tokens.to(dev))
        full = tfm.init_cache(cfg, b, p + 8, device=dev)
        full["k"][:, :, :p], full["v"][:, :, :p] = cache["k"], cache["v"]
        del cache
        step = tfm.make_serve_step(ctx_d, batch=b)
        out, fed = [logits.cpu()], []
        for i in range(8):
            fed.append(feed[i] if feed is not None else out[-1].argmax(dim=-1))
            logits, full = step(params, full, fed[-1].to(dev), p + i)
            out.append(logits.cpu())
    finally:
        moe.router_topk = real
    return {"logits": out, "fed": fed, "routes": routes}


def _route_flips(cpu_routes, card_routes, n_layers: int) -> list:
    """Each router call's tokens whose experts differ between the card and
    the CPU; a flip is allowed only where the CPU's log-probabilities of the
    experts that differ lie within ROUTER_MARGIN of its k-th."""
    import torch

    flips = []
    for i, ((pc, ic), (_, ig)) in enumerate(zip(cpu_routes, card_routes)):
        where = "prefill" if i < n_layers else f"decode step {(i - n_layers) // n_layers}"
        differ = (ic.sort(-1).values != ig.sort(-1).values).any(-1).nonzero().flatten()
        worst = 0.0
        for tok in differ.tolist():
            experts = sorted(set(ic[tok].tolist()) ^ set(ig[tok].tolist()))
            kth = torch.log(pc[tok, ic[tok, -1]])
            gap = float((torch.log(pc[tok, experts]) - kth).abs().max())
            if gap > ROUTER_MARGIN:
                raise AssertionError(f"{where}, layer {i % n_layers}, token {tok}: experts "
                                     f"{experts} differ {gap} nats from the k-th (> "
                                     f"{ROUTER_MARGIN})")
            worst = max(worst, gap)
        flips.append({"call": where, "layer": i % n_layers, "tokens": int(ic.shape[0]),
                      "flipped_tokens": int(differ.numel()), "max_gap_nats": worst})
    return flips


def _moe_card_vs_cpu(cfg_full, params, dev="cuda") -> dict:
    """Full width, 2 layers, bfloat16: the MoE entry points on the card and
    on the CPU from the same weights, 2 prompts of 256 tokens, then 8 greedy
    decode steps (all fed the CPU's tokens): logits within LM_TOL, greedy
    tokens equal except at a named logit near-tie, router choices equal
    except at near-ties of the k-th expert (counted)."""
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
    tokens = torch.as_tensor(synthetic.make_lm_batch(batch=2, seq_len=MOE_CHECK_PROMPT,
                                                     vocab=cfg.vocab, seed=1)["tokens"])
    t0 = time.monotonic()
    cpu = _moe_run(cfg, on_cpu, tokens, "cpu")
    cpu_s = time.monotonic() - t0
    before = dict(ops.LAUNCHES)
    card = _moe_run(cfg, two, tokens, dev, feed=cpu["fed"])
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    if launched["flash_attention"] != cfg.n_layers or launched["flash_decode"] != 8 * cfg.n_layers:
        raise AssertionError(f"{launched} launches in a prefill and 8 decode steps of "
                             f"{cfg.n_layers} layers")
    flips = _route_flips(cpu["routes"], card["routes"], cfg.n_layers)
    ties, errs = [], []
    for i, (got, want) in enumerate(zip(card["logits"], cpu["logits"])):
        errs.append(float((got - want).abs().max()))
        if not torch.isfinite(got).all() or errs[-1] > LM_TOL:
            raise AssertionError(f"card vs CPU logits at step {i} differ by {errs[-1]} "
                                 f"(> {LM_TOL}); routing flips {flips}")
        for row in range(2):
            w, g = int(want[row].argmax()), int(got[row].argmax())
            if w != g:
                margin = float(want[row, w] - want[row, g])
                if margin > LM_TOL:
                    raise AssertionError(f"step {i} row {row}: card token {g}, CPU token "
                                         f"{w}, CPU margin {margin} (> {LM_TOL})")
                ties.append({"step": i, "row": row, "card": g, "cpu": w, "cpu_margin": margin})
    return {"layers": cfg.n_layers, "prompts": [2, MOE_CHECK_PROMPT], "decode_steps": 8,
            "tol": LM_TOL, "router_margin_nats": ROUTER_MARGIN,
            "prefill_max_abs_diff": errs[0], "decode_max_abs_diff": errs[1:],
            "logit_scale": float(cpu["logits"][0].abs().max()),
            "greedy_tokens_equal": not ties, "near_ties": ties,
            "router_calls": len(flips),
            "routing_flips": sum(f["flipped_tokens"] for f in flips),
            "routed_tokens": sum(f["tokens"] for f in flips),
            "flips_by_call": [f for f in flips if f["flipped_tokens"]],
            "cpu_s": cpu_s}


def phase_lm_moe(ctx, dev="cuda", cfg=None) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_decode, ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    ctx.pop("collection", None)  # the earlier phases' corpora go first
    torch.cuda.empty_cache()
    _moe_flash_geometry(ctx, dev)
    full_cfg = cfg or get_config(MOE_ARCH)
    free, _ = torch.cuda.mem_get_info(dev)
    plan = _moe_memory(full_cfg, free)
    if plan["depth_cut"]:
        print(f"lm_moe: depth cut from {full_cfg.n_layers} to {plan['layers']} layers to fit "
              f"{free} B of free device memory", flush=True)
    cfg = dataclasses.replace(full_cfg, n_layers=plan["layers"])
    emit("lm_moe.memory", arch=cfg.name, **plan, nvidia_smi=ctx["smi"])
    torch.cuda.reset_peak_memory_stats()
    b, p, slots, n_decode = MOE_BATCH, MOE_PROMPT, MOE_SLOTS, MOE_DECODE
    t0 = time.monotonic()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [params["embed"], params["final_norm"], params["unembed"],
                        *params["layers"].values()])
    expert_bytes = sum(params["layers"][n].numel() * 2 for n in ("w_gate", "w_up", "w_down"))
    tokens = torch.as_tensor(synthetic.make_lm_batch(batch=b, seq_len=p, vocab=cfg.vocab,
                                                     seed=0)["tokens"], device=dev)
    ctx_p, ctx_d = _moe_contexts(cfg, dev, b * p, b)
    prefill = tfm.make_prefill_step(ctx_p)
    # one untimed prefill first (module loads, cuBLAS's first calls), which
    # also counts the assignments capacity keeps
    kept = []
    real, moe._dispatch = _counting_dispatch(kept)
    try:
        prefill(params, tokens)
    finally:
        moe._dispatch = real
    routed = cfg.n_layers * b * p * cfg.top_k
    dropped_share = 1.0 - float(torch.stack(kept).sum()) / routed
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
    full = tfm.init_cache(cfg, b, slots, device=dev)
    full["k"][:, :, :p], full["v"][:, :, :p] = cache["k"], cache["v"]
    del cache
    torch.cuda.empty_cache()
    step = tfm.make_serve_step(ctx_d, batch=b)
    tok = torch.argmax(logits, dim=-1)
    t = torch.tensor(p, dtype=torch.int32, device=dev)
    step(params, full, tok, t)  # untimed: the timed first step rewrites position t
    step_s, seq0 = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(n_decode):
        t1 = time.monotonic()
        logits, full = step(params, full, tok, t)
        tok = torch.argmax(logits, dim=-1)
        t.add_(1)
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
    if flash_decode.take_error(dev):
        raise AssertionError("the decode kernel set its error word (a position outside the cache)")
    peak = torch.cuda.max_memory_allocated()
    ctx.setdefault("paths", {})["lm_moe"] = {
        "flash_attention": prefill_launches["flash_attention"],
        "flash_decode": decode_launches["flash_decode"]}
    steps = np.array(step_s)
    # the least a step could take: every weight but the embedding read once
    # (a step's capacity dispatch runs every expert's products), the cache's
    # positions read once
    cache_read = 2 * 2 * b * (p + n_decode) * cfg.n_kv_heads * cfg.hd * cfg.n_layers
    step_bytes = weight_bytes - params["embed"].numel() * 2 + cache_read
    # a decode step's grouped products alone (one layer's three and the
    # gate-up product, capacity 8, by CUDA events) times the depth: the part
    # that reads every expert's weights
    cap = moe.capacity_for(b, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    h = torch.randn((cfg.n_experts, cap, cfg.d_model), device=dev).to(
        params["layers"]["w_gate"].dtype)
    lp = {n: params["layers"][n][0] for n in ("w_gate", "w_up", "w_down")}
    products_ms = cfg.n_layers * cuda_ms(lambda: torch.bmm(
        torch.bmm(h, lp["w_gate"]) * torch.bmm(h, lp["w_up"]), lp["w_down"]), reps=20, warmup=2)
    del h, lp
    profile = _profile_lm(params, tokens, prefill, full, step, tok,
                          torch.tensor(p + n_decode + 1, dtype=torch.int32, device=dev))
    attn_s = profile["prefill"]["flash_s"]["flash_attention"]
    decode_step_s = profile["decode_8_steps"]["flash_s"]["flash_decode"] / 8
    emit("lm_moe", arch=cfg.name, layers=cfg.n_layers, depth_cut=plan["depth_cut"],
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
         experts=cfg.n_experts, top_k=cfg.top_k, d_ff=cfg.d_ff, vocab=cfg.vocab,
         dtype=cfg.dtype, fsdp_experts=tfm.uses_fsdp_experts(cfg), mesh=[1, 1],
         weight_bytes=weight_bytes, expert_bytes=expert_bytes, init_s=init_s, batch=b,
         prompt=p, cache_slots=slots,
         cache_bytes=sum(x.numel() * x.element_size() for x in full.values()),
         capacity_prefill=moe.capacity_for(b * p, cfg.top_k, cfg.n_experts, cfg.capacity_factor),
         capacity_decode=moe.capacity_for(b, cfg.top_k, cfg.n_experts, cfg.capacity_factor),
         prefill_dropped_share=dropped_share, prefill_routed_pairs=routed,
         prefill_s=prefill_s, prefill_tokens_per_s=b * p / prefill_s,
         prefill_launches=prefill_launches, flash_attention_device_s=attn_s,
         flash_attention_share=attn_s / prefill_s,
         decode_steps=n_decode, decode_launches=decode_launches,
         decode_ms_p50=float(np.quantile(steps, 0.5)) * 1e3,
         decode_ms_p99=float(np.quantile(steps, 0.99)) * 1e3,
         decode_tokens_per_s=b * n_decode / float(steps.sum()),
         expert_bytes_per_step=expert_bytes,
         expert_bound_ms=expert_bytes / HBM_BYTES_PER_S * 1e3,
         step_bytes=step_bytes, step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
         expert_products_ms_per_step=products_ms,
         flash_decode_device_ms_per_step=decode_step_s * 1e3,
         flash_decode_share=decode_step_s / float(steps.mean()),
         seq0_tokens=seq0[:16], logits_finite=finite, max_memory_allocated=peak,
         nvidia_smi=ctx["smi"])
    emit("lm_moe.profile", **profile, nvidia_smi=ctx["smi"])
    del full
    torch.cuda.empty_cache()
    check = _moe_card_vs_cpu(cfg, params, dev)
    emit("lm_moe.card_vs_cpu", **check, nvidia_smi=ctx["smi"])
    del params
    torch.cuda.empty_cache()


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
             "experiment": phase_experiment, "paper": phase_paper, "tune": phase_tune,
             "resume": phase_resume, "serve": phase_serve, "mesh": phase_mesh, "lm": phase_lm,
             "lm_moe": phase_lm_moe}
    for p in PHASES:
        if p in only:
            t0 = time.monotonic()
            table[p](ctx)
            emit("phase_time", name=p, seconds=time.monotonic() - t0)
    for name, entry in ctx["kernels"].items():
        entry["launches"] = ctx["launches"].get(name, 0)
        # each later path's own launches, counted from 0 around that path
        entry["launches_by_path"] = {path: counts[name] for path, counts in
                                     ctx.get("paths", {}).items() if name in counts}
    print(ctx["smi"])
    print(json.dumps({"kernels": list(ctx["kernels"].values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
