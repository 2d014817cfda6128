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
                  replayed from a CUDA graph at two positions; a shard's
                  mergeable partial over each of 4 shards of a split
                  cache, an empty shard giving o = 0 and lse = -inf),
                  within
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
                  executor's spans and its peak device memory. Then
                  ``experiment.packed``: the pipelined run once more with
                  ``token_pack="auto"`` (17-bit planes, packed by the
                  runner on the host): run files and checkpoint bytes
                  identical to the unpacked runs', one launch a segment.
                  Then ``experiment.streamed``: `run_sharded_scan_job` over
                  the same corpus kept on the host (pinned once, before the
                  scan), streamed to the card by `prefetch_segments`, and
                  ``experiment.job``: the same job over the corpus on the
                  card. Both states and checkpoints must be the runner's
                  bit for bit; the streamed run's device memory above the
                  collection must stay within the device-resident job's
                  plus (prefetch_depth + 1) segments plus half a segment.
                  Then ``experiment.profile``: `torch.profiler` over one
                  device-resident job: the device time a segment of the
                  scan kernel, its list merge and everything else.
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
                  oracles; then a batch-size sweep at 8, 64 and 128; then
                  ``serve.dense_pad``: `DenseSession` over 2^24 docs at
                  dims 8, 24 and 40 (rows narrower than the kernel's 128
                  bytes): the session pads its corpus once, and a 64-query
                  block gives the bits of the kernel's own per-call pad
                  (the path before) with nothing corpus-sized allocated,
                  both paths timed in turns; then the
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
                  device time. ``lm.seqshard``: the serve step on a (1, 4)
                  mesh of the card (the cache's sequence over 4 shards,
                  each a view of the phase's 8,704-slot cache; each
                  shard's partial through the decode kernel, merged by
                  log-sum-exp): every layer's sharded attention within
                  ``FLASH_ROW_TOL``'s row-scaled limit of the one-shard
                  kernel's on the same inputs (a one-block control must
                  fail), 2 layers' logits within it beside the one-shard
                  step, then 16 full-depth greedy steps beside it (26
                  layers compound the two paths' bfloat16 roundings past
                  that limit: greedy tokens equal but at named near-ties),
                  26 x 4 launches a step, and 4 sharded steps with ``t`` on
                  the card under ``set_sync_debug_mode("error")``.
                  ``lm.long``: the
                  ``long_500k`` shape, batch 1 over 524,288 slots (halved
                  only if it does not fit, the cut printed) on a (2, 2)
                  mesh of the card (the sequence over every axis), the
                  cache drawn from a seeded generator, every layer's
                  attention checked as above, 4 steps at its end beside the
                  one-shard step, each step's seconds beside its
                  `launch.roofline` bound (counted on meta).
11. ``lm_moe``    MoE serving of qwen3-moe-30b-a3b at full width and 24 of
                  its 48 layers (cut for time), d_model 2,048, 32 / 4 heads of 64, 128 experts
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
                  24 attention launches in the prefill and 24 x 64 in
                  decode; decode p50 / p99 beside the weight-byte bound of a
                  step; the device idle share and each flash kernel's share
                  (`torch.profiler`); peak memory. Then the card against
                  the CPU at full width and 2 layers, 2 prompts of 256
                  tokens, from the same weights: logits within ``LM_TOL``,
                  greedy tokens of 8 steps equal except at a named logit
                  near-tie, and every layer's router choices equal except
                  where the experts that differ lie within
                  ``ROUTER_MARGIN`` of the k-th (counted and printed).
12. ``train``     training through `launch.train` (`make_loss_fn`, AdamW,
                  the loader, checkpoints). First the flash kernel at the
                  training geometry of h2o-danube-1.8b (bf16, head_dim 80,
                  32 / 8 heads, window 4,096, 2 x 8,192) against its plain
                  version, timed beside SDPA and beside the attention
                  backward (``train.flash``). ``train.grads``: full width,
                  2 layers, 1 x 512 tokens, weights seeded on the CPU: the
                  loss within ``LM_TOL`` and every leaf's gradient within
                  ``GRAD_REL`` (relative L2) and ``GRAD_COS`` (cosine) of the
                  CPU's, no leaf without a gradient, and a control with the
                  bare kernel (no autograd function) must fail.
                  ``train.full``: full width and depth (24 layers, 1.83e9
                  parameters, bf16, float32 moments, remat), 4 steps of 2 x
                  8,192 tokens: step seconds, tokens/s, model FLOP/s against
                  the bf16 peak (the count printed), peak memory, the flash
                  launches (forward and remat's recompute), then one
                  profiled step split into forward, backward, the attention
                  backward and the optimizer, with the idle share.
                  ``train.resume`` (2 layers): two straight runs of 8 steps
                  the same bytes; a failure before step 5 resumed from step
                  4's checkpoint gives the straight run's parameters,
                  moments and step; checkpoint bytes, save and restore
                  seconds. ``train.compress``: ``topk`` and ``sign``, 4
                  steps twice each, the same bytes, a residual not zero.
                  ``train.moe``: qwen3-moe-30b-a3b at full width and 2
                  layers, the card's loss and gradients against the CPU's
                  at 2 x 256 tokens (routing flips only at near-ties), then
                  3 steps with the share of routed pairs dropped.
                  ``train.mesh``: full width, 2 layers, 2 x 512 tokens:
                  the loss and every gradient leaf on a (2, 2) mesh of the
                  card (the vocabulary- and data-parallel loss) against the
                  one-shard step, within ``train.grads``' limits; then the
                  driver with ``grad_compress="sign"`` on a (2, 1) mesh for
                  2 steps beside the one-shard driver (losses within
                  ``LM_TOL``).
                  ``train.recsys``: fm, dcn-v2, mind and sasrec at their
                  published widths, 15 steps of 32 at lr 3e-3 (dcn-v2's
                  loss must fall, as in the reference's test), and the
                  reduced configs on the card within 1e-5 of the CPU's
                  losses. ``train.examples``: ``examples/torch_train_lm.py``
                  (train, a failure, the resume, 16 greedy tokens: flash
                  attention and flash decode launched) and
                  ``examples/torch_candidate_retrieval.py`` (``score_topk``
                  launched, rankings those of the CPU's run).
13. ``gnn``       the GNN (``pna``; no kernel of the four lies on its path,
                  and none may launch there). ``gnn.parity``: the reduced
                  config on the card against the CPU in every regime (the
                  full graph; bucketed and scatter on (1,) and (4,) meshes
                  of the card; sampled; batched): float64 logits and every
                  gradient leaf within the CPU tests' 1e-5, float32 logits
                  within 1e-5 of the largest; each twice on the card, the
                  same bytes; 3 training steps twice on cora's graph and on
                  128 molecules, the same bytes; the hand-worked ties (a
                  segment max under a negative gradient, a maximum tied
                  across shards). ``gnn.products``: full ``pna`` (4 layers,
                  d 75) over a ``make_graph`` graph at ogbn-products' size
                  (2,449,408 nodes, 61,859,140 edges, ``d_feat`` 100)
                  under ``torch.no_grad``, bucketed on (1,) and (4,) meshes
                  of the card: seconds (p50 of 3 after a warm-up), edges x
                  layers a second, peak memory (under 45 GB) beside the
                  reckoning, a profiled pass's idle share and top device
                  operations, the (4,) logits within 1e-5 of the largest
                  of the (1,). ``gnn.train``: AdamW steps at the cells'
                  schedule at reddit's sampled minibatches (a graph of
                  232,965 nodes and 114,615,892 edges; the host's share of
                  a step), cora's full graph and 128 molecules: step
                  seconds, rows a second, losses. Then the phase's seconds.
14. ``lower``     the lowering tools, host work on meta tensors (no kernel
                  may launch): `launch.dryrun` over every (arch x shape)
                  cell on the one-H100 mesh and on the 16x16 mesh (all 43
                  must be ok on both), in ``LOWER_WORKERS`` processes. Then
                  this
                  script's own cells counted at the shapes its phases ran
                  (`launch.opcount`), each one's `launch.roofline` bound,
                  bottleneck and counted FLOPs beside the time this call
                  measured, and for train-danube-1.8b and gnn-products-fwd
                  the reckoned peak beside ``max_memory_allocated``. Under
                  ``--only lower`` the bounds stand alone.

Each phase's wall time follows it (``phase_time``), and every line carries
``at_s``, the seconds since the script started. The last three lines
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
          "lm", "lm_moe", "train", "gnn", "lower")

sys.path.insert(0, os.path.join(ROOT, "src"))
# H100 SXM peaks at 700 W, each with its source, in one place
# (`repro_torch.launch.roofline`): the HBM3 rate, the INT32 compare/add rate
# of the CUDA cores, the FP32 rate, the bfloat16 and TF32 dense tensor-core
# rates. Importing it fails when the repository is not beside the script.
from repro_torch.launch.roofline import HBM_BW, PEAKS  # noqa: E402

# the repo's ``dense_scan`` shape (src/repro/configs/shapes.py:89-91) at the
# ``mirex`` config's dense_dim (src/repro/configs/archs/mirex.py)
DENSE_DOCS, DENSE_QUERIES = 1 << 24, 4096
DEEPER = 8  # reference rankings this much deeper show near-ties across the cut
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
# lm.long: gemma2-2b at the long_500k shape (batch 1, 524,288 slots) on a
# (2, 2) mesh of the card, its cache drawn from a seeded generator
LONG_SLOTS, LONG_STEPS, LONG_MESH, LONG_SEED = 524_288, 4, (2, 2), 1
LONG_MARGIN = 4 << 30  # beside the cache: the weights are already resident
# lm.seqshard: 16 steps over the phase's own cache on a (1, 4) mesh
SEQSHARD_SHARDS, SEQSHARD_STEPS = 4, 16


_START = time.monotonic()


def emit(phase: str, **payload) -> None:
    """One JSON line; ``at_s`` (seconds since the script started) dates it,
    so that the gaps between lines give each part of a phase its time."""
    print(json.dumps({"phase": phase, **payload, "at_s": time.monotonic() - _START}), flush=True)


def _bound(cost: dict) -> tuple[float, str, float, float]:
    """``(bound_ms, bound_by, ops, bytes)`` of a kernel module's ``cost()``
    (the least work of a call, PERF.md's Bound column): the larger of its
    operations at their class's peak and its bytes at the HBM rate."""
    ops_s = sum(n / PEAKS[c] for c, n in cost["flops"].items())
    bytes_s = cost["bytes"] / HBM_BW
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes",
            sum(cost["flops"].values()), cost["bytes"])


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
    # the least work of these inputs (`lexical_scan.cost`: every input read
    # once and the outputs written once; one lookup per token and one
    # epilogue + compare per (model, query, doc), counted at the INT32 rate,
    # the epilogue's float operations running at twice it); and the first
    # design's compare-all count beside it (one compare + one add per
    # (query term, token) pair)
    bound_ms, bound_by, ops_count, n_bytes = _bound(lexical_scan.cost(*args, k=k))
    compare_all = 2 * n_q * l_q * n_seg * l_d
    bound_compare_all_ms = 1e3 * compare_all / PEAKS["other"]
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
    # the unpacked row's bound with the packed tokens' bytes
    bound_ms, bound_by, ops_count, n_bytes = _bound(
        lexical_scan.cost(*pargs, k=k, pack_spec=spec))
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
    bound_ms, bound_by, tf32_ops, n_bytes = _bound(score_topk.cost(q, corpus, k=k))
    ops_count = tf32_ops // 3
    bound_fp32_pipe_ms = 1e3 * max(ops_count / PEAKS["f32"], n_bytes / HBM_BW)
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
         ops=ops_count, tf32_ops=tf32_ops, bytes=n_bytes, gb_per_s=n_bytes / ms * 1e-6,
         ms_128_queries=ms_128, ptxas=_ptxas_of("score_topk"), nvidia_smi=ctx["smi"])
    del corpus, q128  # 16 GiB: the experiment phase runs as it ran before this phase grew
    torch.cuda.empty_cache()
    _flash_kernels(ctx)
    _decode_partials(ctx)


# the decode kernel's mergeable partial at gemma2-2b's decode geometry: the
# phase lm cache's 8,704 slots cut into 4 shards of 2,176; positions on
# both sides of the shard edges, t = 0, windows that leave shards empty
PARTIAL_SHARDS, PARTIAL_SLOTS = 4, 8704
PARTIAL_CASES = ((0, None), (2175, None), (2176, 4096), (5000, 4096), (8703, 4096),
                 (8703, None), (4353, 3))


def _decode_partials(ctx) -> None:
    """Each shard's ``(o, lse)`` from the decode kernel (``pos0``, positions
    ``<= t - 1``, a view of the shard's slice) against the plain version:
    o within FLASH_TOL and, in bfloat16, FLASH_ROW_TOL's row-scaled limit;
    lse within 1e-4 / 1e-5; a shard with no allowed position ``o = 0`` and
    ``lse = -inf`` with no NaN; the shards merged by log-sum-exp
    (`attention.lse_combine`) the whole cache's partial within the same
    limits. Then the time of one shard's call at the ``lm.long`` geometry
    beside its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode, ops
    from repro_torch.models import attention

    b, kv, g, hd, cap = 4, 4, 2, 256, 50.0
    s, n = PARTIAL_SLOTS, PARTIAL_SHARDS
    s_loc = s // n
    cases, empty = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        seed = 700 + len(cases)
        q = _rows(seed, (b, kv * g, hd), dtype)
        kc, vc = _rows(seed + 1, (b, s, kv, hd), dtype), _rows(seed + 2, (b, s, kv, hd), dtype)
        for t, window in PARTIAL_CASES:
            t_dev = torch.tensor(t, dtype=torch.int32, device="cuda")
            parts = []
            for i in range(n):
                cols = slice(i * s_loc, (i + 1) * s_loc)
                name = f"decode partial t{t} w{window} shard {i} {dtype}"
                o, lse = ops.flash_decode(q, kc[:, cols], vc[:, cols], t_dev, window=window,
                                          cap=cap, pos0=i * s_loc, cache_len=s,
                                          include_t=False, lse=True)
                want_o, want_lse = flash_decode.flash_decode_ref(
                    q, kc[:, cols], vc[:, cols], t, window=window, cap=cap, pos0=i * s_loc,
                    include_t=False, lse=True)
                if torch.isnan(o).any() or torch.isnan(lse).any():
                    raise AssertionError(f"{name}: NaN")
                lo, hi = flash_decode.allowed_range(t, window, pos0=i * s_loc, s=s_loc,
                                                    include_t=False)
                if hi < lo:
                    empty += 1
                    if o.any() or not torch.isneginf(lse).all():
                        raise AssertionError(f"{name}: an empty shard gives o = 0, lse = -inf")
                    parts.append(attention.kernel_partial(o, lse))
                    continue
                torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5, msg=name)
                cases.append({"case": name, "positions": hi - lo + 1,
                              "lse_max_abs_err": float((lse - want_lse).abs().max()),
                              **_flash_close(name, o, want_o, dtype)})
                parts.append(attention.kernel_partial(o, lse))
            if t > 0:
                name = f"decode partials merged t{t} w{window} {dtype}"
                whole, _ = flash_decode.flash_decode_ref(q, kc, vc, t, window=window, cap=cap,
                                                         include_t=False, lse=True)
                _, l_g, o_g = attention.lse_combine(*(torch.stack(x) for x in zip(*parts)))
                cases.append({"case": name, **_flash_close(name, o_g / l_g[..., None], whole,
                                                           dtype)})
        del q, kc, vc
    if flash_decode.take_error("cuda"):
        raise AssertionError("the decode kernel set its error word on an in-range t")
    # one shard of lm.long's cache (batch 1, 524,288 slots over 4 shards),
    # the global layer at its last position
    s_loc = LONG_SLOTS // n
    q = _rows(790, (1, kv * g, hd), torch.bfloat16)
    kc, vc = _rows(791, (1, s_loc, kv, hd), torch.bfloat16), _rows(792, (1, s_loc, kv, hd), torch.bfloat16)
    t_dev = torch.tensor(LONG_SLOTS - 1, dtype=torch.int32, device="cuda")
    pos0 = LONG_SLOTS - s_loc
    kern = lambda: ops.flash_decode(q, kc, vc, t_dev, cap=cap, pos0=pos0,  # noqa: E731
                                    cache_len=LONG_SLOTS, include_t=False, lse=True)
    ms = graph_ms(kern, 20)
    plain_ms = cuda_ms(lambda: flash_decode.flash_decode_ref(
        q, kc, vc, LONG_SLOTS - 1, cap=cap, pos0=pos0, include_t=False, lse=True), reps=3)
    # the yardstick: SDPA over the shard's positions (no soft cap, no lse)
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True), 20)
    bound_ms, bound_by, _, nbytes = _bound(flash_decode.cost(
        q, kc, vc, LONG_SLOTS - 1, pos0=pos0, cache_len=LONG_SLOTS, include_t=False, lse=True))
    del q, kc, vc, qt, kt, vt
    torch.cuda.empty_cache()
    emit("kernels.decode_partial", cases=len(cases), empty_shards=empty,
         max_abs_err_f32=max(c["max_abs_err"] for c in cases if "float32" in c["case"]),
         max_abs_err_bf16=max(c["max_abs_err"] for c in cases if "bfloat16" in c["case"]),
         lse_max_abs_err=max(c.get("lse_max_abs_err", 0.0) for c in cases),
         row_excess_bf16=max(c["row_excess"] for c in cases if c["row_excess"] is not None),
         long_shard={"shape": f"B 1, a {s_loc}-slot shard from {pos0} of {LONG_SLOTS}, t "
                     f"{LONG_SLOTS - 1}, H {kv * g}, KV {kv}, hd {hd}, bf16, cap {cap}",
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "gb_per_s": nbytes / ms * 1e-6,
                     "timing_note": "ms and library_ms from CUDA graphs of 20 calls; "
                     "library_ms: scaled_dot_product_attention(enable_gqa=True) over the "
                     "shard's positions, no soft cap and no lse, a yardstick never used"},
         detail=cases, nvidia_smi=ctx["smi"])


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


def _flash_kernels(ctx) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, flash_attn, flash_decode, ops

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
    block, _ = flash_decode.split_plan(s, None, b * kv, _build.sm_count("cuda"), 512)
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
        bound_ms, bound_by, flops, n_bytes = _bound(flash_attn.cost(q, k, v, window=window))
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
        bound_ms, bound_by, flops, dec_bytes = _bound(
            flash_decode.cost(q, kc, vc, t, window=window))
        timing[label] = {"ms": ms, "ms_cap_none": ms_nocap, "ms_eager": ms_eager,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "library_ms_eager": library_ms_eager, "bound_ms": bound_ms, "bound_by": bound_by,
                         "gb_per_s": dec_bytes / ms * 1e-6, "gb_per_s_cap_none": dec_bytes / ms_nocap * 1e-6,
                         "library_gb_per_s": dec_bytes / library_ms * 1e-6,
                         **close, "control_row_excess": control, "ops": flops, "bytes": dec_bytes}
        plan = flash_decode.split_plan(slots, window, b * kv, _build.sm_count("cuda"), 512)
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
    # planes at vocab 65,536) through the runner's packing branch, pipelined:
    # the run files and the checkpoint bytes are the unpacked run's
    out_p = os.path.join(OUT, "bm25-grid-packed")
    packed, pk = _timed(_via_runner(spec, coll, out_p, pipelined=True,
                                    tuning=TuningConfig(token_pack="auto")), n, out_p)
    resolved = packed["job"]["tuning"]["pack_resolved"]
    if resolved != "bitpack":
        raise AssertionError(f"token_pack auto resolved to {resolved!r} at vocab {spec.vocab}")
    _assert_same_runs(out, out_p, "packed")
    if pk["ckpt_written_bytes"] != pipe["ckpt_written_bytes"]:
        raise AssertionError(f"checkpoint bytes written: unpacked {pipe['ckpt_written_bytes']}, "
                             f"packed {pk['ckpt_written_bytes']}")
    ctx["launches"]["lexical_scan_topk[packed]"] = pk["launches"]
    emit("experiment.packed", experiment=spec.name, token_pack="auto", pack_resolved=resolved,
         bits=int(spec.vocab).bit_length(), run_files_identical=True, **pk,
         unpacked_scan_s=pipe["scan_s"], unpacked_docs_per_s=pipe["docs_per_s"],
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

    # where the device time of a pipelined scan goes (one profiled job, after
    # the timed runs: profiling slows the host)
    out_prof = os.path.join(OUT, "bm25-grid-profiled")
    shutil.rmtree(out_prof, ignore_errors=True)
    profile = _scan_profile(_via_job(spec, device_corpus, queries, coll.stats, out_prof),
                            spec.n_docs // (spec.chunk_size * spec.segment_chunks))
    emit("experiment.profile", experiment=spec.name, profile=profile, nvidia_smi=ctx["smi"])
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


DENSE_PAD_DIMS, DENSE_PAD_DOCS = (8, 24, 40), 1 << 24


def _serve_dense_pad(ctx, k: int, chunk: int, dev="cuda") -> None:
    """`DenseSession` at widths that are no multiple of the kernel's 128-byte
    row: the session pads its corpus once, so a 64-query block gives the
    bits of the kernel's own per-call pad (the path before) and allocates
    nothing the size of the corpus; both paths timed in turns."""
    import numpy as np
    import torch

    from repro_torch.core import scan
    from repro_torch.core.scoring import get_scorer
    from repro_torch.kernels import ops
    from repro_torch.serve import DenseSession

    lines = {}
    for dim in DENSE_PAD_DIMS:
        vecs = _rows(50 + dim, (DENSE_PAD_DOCS, dim), torch.float32)
        q = _rows(60 + dim, (64, dim), torch.float32).cpu().numpy()
        session = DenseSession(vecs, "dense_cosine", k=k, chunk_size=chunk, device=dev)
        cosine = get_scorer("dense_cosine")
        mapped = cosine.row_map(vecs)  # the session before: mapped once, not padded

        def before():
            qt = cosine.row_map(torch.as_tensor(q, device=dev))
            return scan.search_local(qt, mapped, get_scorer("dense_dot"), k=k, chunk_size=chunk)

        want = before()
        got = session.search(q)
        if not (torch.equal(got.scores, want.scores.cpu())
                and torch.equal(got.ids, want.ids.cpu())):
            raise AssertionError(f"serve.dense_pad dim {dim}: bits differ from the wrapper's pad")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        session.search(q)
        torch.cuda.synchronize()
        above = torch.cuda.max_memory_allocated() - base
        launches = ops.LAUNCHES["score_topk"]
        corpus_bytes = vecs.numel() * 4
        if above >= corpus_bytes or launches != 1:
            raise AssertionError(f"serve.dense_pad dim {dim}: {above} B above the session "
                                 f"during a block (corpus {corpus_bytes} B), {launches} launches")
        times = {"session": [], "wrapper_pad": []}
        for name in ("session", "wrapper_pad", "wrapper_pad", "session") * 3:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            session.search(q) if name == "session" else before().scores.cpu()
            times[name].append(time.monotonic() - t0)
        lines[f"dim_{dim}"] = {
            "resident_dim": int(session._vectors.shape[1]), "corpus_bytes": corpus_bytes,
            "block_bytes_above_session": above, "same_bits": True,
            "block_s_p50": float(np.median(times["session"])),
            "wrapper_pad_block_s_p50": float(np.median(times["wrapper_pad"]))}
        del session, vecs, mapped
        torch.cuda.empty_cache()
    emit("serve.dense_pad", n_docs=DENSE_PAD_DOCS, queries=64, scorer="dense_cosine", k=k,
         **lines, nvidia_smi=ctx["smi"])


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
    line = _serve_line(service, "dense", wall_s, sweep)
    _measured(ctx, "serve-dense-16M block", block_s=line["block_latency_ms"]["p50"] * 1e-3,
              block_queries=max(line["buckets"]))
    emit("serve.dense", n_docs=session.n_docs, dim=session.dim, dtype="float32",
         resident_bytes=corpus.numel() * 4, scorer="dense_dot", k=k, chunk_size=chunk,
         launches=launches, sampled_max_abs_err=err, **line, nvidia_smi=ctx["smi"])
    del corpus, session, service, results
    torch.cuda.empty_cache()
    _serve_dense_pad(ctx, k, chunk)

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


def _logits_agree(name, got, want, row_limit: bool = True) -> dict:
    """Logits of a sharded step against the one-shard step's, finite. With
    ``row_limit``: every row within FLASH_ROW_TOL's row-scaled limit, and
    greedy tokens equal except where the one-shard step's two candidates
    lie within that row's limit of each other. Without (a full-depth
    model, whose 26 layers compound the two attention paths' bfloat16
    roundings past that limit: PERF.md §6): greedy tokens equal except
    where the two candidates lie within twice the row's largest logit
    difference of each other. Each near-tie is named."""
    import torch

    rtol, tau = FLASH_ROW_TOL
    excess = _row_excess(got, want)
    if not bool(torch.isfinite(got).all()) or (row_limit and excess > 1):
        raise AssertionError(f"{name}: logits {excess} times the row-scaled limit")
    ties = []
    for row in range(want.shape[0]):
        w, g = int(want[row].argmax()), int(got[row].argmax())
        if w != g:
            margin = float(want[row, w] - want[row, g])
            limit = float(rtol * want[row, w].abs() + tau * want[row].square().mean().sqrt()
                          if row_limit else 2 * (got[row] - want[row]).abs().max())
            if margin > limit:
                raise AssertionError(f"{name} row {row}: token {g} against {w}, margin {margin} "
                                     f"(> {limit})")
            ties.append({"row": row, "sharded": g, "one_shard": w, "margin": margin,
                         "limit": limit})
    return {"row_excess": excess, "max_abs_diff": float((got - want).abs().max()),
            "near_ties": ties}


def _seqshard_attention(cfg, params, cache, tok, t: int, mesh) -> dict:
    """One sharded step at ``t`` whose every layer's attention (the merged
    shards' partials with the new token folded in, rounded to the model's
    dtype as the step uses it) is held to the one-shard kernel's output on
    the same inputs (the layer's cache with the new token written at
    ``t``): within FLASH_ROW_TOL's row-scaled limit; a control, the
    one-shard kernel's with one 512-position block of the band dropped,
    must fail it (where the band holds more than 512 positions). The
    one-shard launches here are the check's own."""
    import torch

    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.kernels import flash_decode, ops
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm

    dt = getattr(torch, cfg.dtype)
    real = attention.decode_attend_seqsharded
    excess, control = [], []

    def checking(*args, **kwargs):
        attend = real(*args, **kwargs)

        def checked(q, kn, vn, k_cache, v_cache, t_, window_active):
            o = attend(q, kn, vn, k_cache, v_cache, t_, window_active)
            kc, vc = k_cache.clone(), v_cache.clone()
            kc[:, t], vc[:, t] = kn.to(kc.dtype), vn.to(vc.dtype)
            window = kwargs["window"] if window_active else None
            want = ops.flash_decode(q, kc, vc, t, window=window, cap=kwargs["cap"])
            excess.append(_row_excess(o.to(dt), want))
            band = min(window or t + 1, t + 1)  # the positions the token attends to
            if band > 512:
                control.append(_row_excess(flash_decode.flash_decode_ref(
                    q, kc, vc, t, window=band - 512, cap=kwargs["cap"]), want))
            return o

        return checked

    attention.decode_attend_seqsharded = checking
    try:
        step = tfm.make_serve_step(tfm.make_context(cfg, mesh, rules_for_mesh(mesh)),
                                   batch=tok.shape[0])
    finally:
        attention.decode_attend_seqsharded = real
    step(params, cache, tok, t)  # writes slot t, as any step at t does
    if max(excess) > 1 or min(control, default=2) <= 1:
        raise AssertionError(f"sharded attention at t={t}: {max(excess)} times the row-scaled "
                             f"limit; the control {min(control, default=None)} times")
    return {"t": t, "layers": len(excess), "row_excess_max": max(excess),
            "row_excess_by_layer": excess, "control_row_excess_min": min(control, default=None)}


def _sharded_beside_one(cfg, params, cache, tok, t0: int, steps: int, mesh,
                        row_limit: bool, name: str) -> dict:
    """``steps`` greedy steps from ``t0`` of the serve step over ``mesh``
    (the cache's sequence sharded), each beside the one-shard step at the
    same ``t`` and token: the sharded step first (it reads positions < t
    and writes slot t), then the one-shard step (which rewrites slot t with
    its own K/V), so both read the same cache; logits by
    :func:`_logits_agree`; the sharded steps' launches counted from 0."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    sharded = tfm.make_serve_step(tfm.make_context(cfg, mesh, rules_for_mesh(mesh)),
                                  batch=tok.shape[0])
    one = tfm.make_serve_step(cfg, batch=tok.shape[0])
    sharded(params, cache, tok, t0)  # untimed: the first step rewrites slot t0
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    checks, s_s, o_s = [], [], []
    for i in range(steps):
        t = t0 + i
        torch.cuda.synchronize()
        ops.reset_launches()
        t1 = time.monotonic()
        got, cache = sharded(params, cache, tok, t)
        torch.cuda.synchronize()
        s_s.append(time.monotonic() - t1)
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        t1 = time.monotonic()
        want, cache = one(params, cache, tok, t)
        torch.cuda.synchronize()
        o_s.append(time.monotonic() - t1)
        checks.append(_logits_agree(f"{name} t{t}", got.float(), want.float(), row_limit))
        tok = torch.argmax(want, dim=-1)
    n_shards = mesh.size
    if launches["flash_decode"] != steps * cfg.n_layers * n_shards or launches["flash_attention"]:
        raise AssertionError(f"{name}: {launches} launches in {steps} steps of {cfg.n_layers} "
                             f"layers over {n_shards} shards")
    return {"step": sharded, "tok": tok, "launches": launches, "step_s": s_s,
            "one_shard_step_s": o_s, "positions": [t0, t0 + steps - 1],
            "row_excess": [c["row_excess"] for c in checks],
            "logits_max_abs_diff": max(c["max_abs_diff"] for c in checks),
            "near_ties": [c["near_ties"] for c in checks if c["near_ties"]]}


def _lm_seqshard(ctx, cfg, params, cache, tok, t0: int, steps: int = SEQSHARD_STEPS) -> dict:
    """``lm.seqshard``: the serve step over a (1, 4) mesh of the card (the
    cache's sequence over ``model``: four shards of the phase's cache, each
    a view). First every layer's sharded attention at ``t0`` against the
    one-shard kernel on the same inputs (:func:`_seqshard_attention`); then
    2 layers' logits within FLASH_ROW_TOL of the one-shard step's for 4
    steps; then ``steps`` full-depth steps beside the one-shard step
    (:func:`_sharded_beside_one`: greedy tokens); then 4 sharded steps with
    ``t`` on the card under `torch.cuda.set_sync_debug_mode("error")`
    (`_device_t_step`)."""
    import numpy as np

    from repro_torch.kernels import flash_decode
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(1, SEQSHARD_SHARDS)
    attn = _seqshard_attention(cfg, params, cache, tok, t0, mesh)
    two = dataclasses.replace(cfg, n_layers=2)
    shallow = _sharded_beside_one(
        two, {**params, "layers": {n: w[:2] for n, w in params["layers"].items()}},
        {n: x[:2].clone() for n, x in cache.items()}, tok, t0, 4, mesh, True,
        "lm.seqshard 2 layers")
    run = _sharded_beside_one(cfg, params, cache, tok, t0, steps, mesh, False, "lm.seqshard")
    device_t = _device_t_step(params, cache, run["step"], run["tok"], t0 + steps, n=4)
    if flash_decode.take_error("cuda"):
        raise AssertionError("the decode kernel set its error word")
    ctx.setdefault("paths", {})["lm.seqshard"] = {"flash_decode": run["launches"]["flash_decode"]}
    return {"mesh": [1, SEQSHARD_SHARDS], "shards": SEQSHARD_SHARDS, "steps": steps,
            "positions": run["positions"], "launches": run["launches"],
            "attention_by_layer": attn,
            "two_layers": {k: shallow[k] for k in ("row_excess", "logits_max_abs_diff",
                                                   "near_ties")},
            "row_excess": run["row_excess"], "logits_max_abs_diff": run["logits_max_abs_diff"],
            "near_ties": run["near_ties"], "greedy_tokens_equal": not run["near_ties"],
            "sharded_ms_p50": float(np.median(run["step_s"])) * 1e3,
            "one_shard_ms_p50": float(np.median(run["one_shard_step_s"])) * 1e3,
            "device_t": device_t}


def _long_bound(cfg, slots: int, t: int) -> dict:
    """The ``lm.long`` step counted on meta tensors (`launch.opcount`, a
    (2, 2) mesh of meta devices, all on one card: nothing divided), its
    `launch.roofline` bound."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import Mesh, rules_for_mesh
    from repro_torch.launch import cells, opcount, roofline
    from repro_torch.models import transformer as tfm

    mesh = Mesh(np.full(LONG_MESH, torch.device("meta"), dtype=object), ("data", "model"))
    step = tfm.make_serve_step(tfm.make_context(cfg, mesh, rules_for_mesh(mesh)), batch=1)
    with opcount.OpCounter(1) as counter:
        step(cells.abstract(tfm.param_shapes(cfg)),
             cells.abstract(tfm.cache_shapes(cfg, 1, slots)),
             torch.empty((1,), dtype=torch.int32, device="meta"), t)
    hlo = counter.result()
    return {**roofline.bound(hlo), "counted_flops": hlo["flops"],
            "counted_bytes": hlo["bytes_accessed"], "kernels": hlo["kernels"],
            "collective_counts": hlo["collective_counts"], "counted_at_t": t}


def _lm_long(ctx, cfg, params) -> dict:
    """``lm.long``: gemma2-2b at the ``long_500k`` shape, batch 1 over
    ``LONG_SLOTS`` slots on a (2, 2) mesh of the card (batch 1: the sequence
    over every axis, four shards), the cache drawn from a seeded generator
    (no prefill), halved until it fits beside the weights (each cut
    printed). Every layer's sharded attention against the one-shard kernel
    (:func:`_seqshard_attention`), then ``LONG_STEPS`` greedy steps at the
    cache's end beside the one-shard step (:func:`_sharded_beside_one`),
    step seconds beside the step's roofline bound."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_decode
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tfm

    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    per_slot = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
    slots, cuts = LONG_SLOTS, []
    while slots * per_slot + LONG_MARGIN > free:
        cuts.append(f"{slots} slots need {slots * per_slot} B beside {free} B free")
        slots //= 2
    for c in cuts:
        print(f"lm.long: cut: {c}", flush=True)
    t0 = time.monotonic()
    cache = tfm.init_cache(cfg, 1, slots, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(LONG_SEED)
    for name in ("k", "v"):
        for layer in range(cfg.n_layers):
            cache[name][layer].normal_(generator=g)
    torch.cuda.synchronize()
    fill_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    mesh = make_test_mesh(*LONG_MESH)
    tok = torch.ones(1, dtype=torch.int64, device="cuda")
    first = slots - LONG_STEPS - 1
    attn = _seqshard_attention(cfg, params, cache, tok, first, mesh)
    run = _sharded_beside_one(cfg, params, cache, tok, first + 1, LONG_STEPS, mesh, False,
                              "lm.long")
    if flash_decode.take_error("cuda"):
        raise AssertionError("the decode kernel set its error word")
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(x.numel() * x.element_size() for x in cache.values())
    del cache
    torch.cuda.empty_cache()
    bound = _long_bound(cfg, slots, first + 1 + LONG_STEPS // 2)
    p50 = float(np.median(run["step_s"]))
    ctx.setdefault("paths", {})["lm.long"] = {"flash_decode": run["launches"]["flash_decode"]}
    return {"mesh": list(LONG_MESH), "batch": 1, "slots": slots, "cuts": cuts,
            "cache_bytes": cache_bytes, "fill_s": fill_s, "steps": LONG_STEPS,
            "positions": run["positions"], "launches": run["launches"],
            "step_s": run["step_s"], "step_s_p50": p50,
            "one_shard_step_s": run["one_shard_step_s"], "bound": bound,
            "measured_over_bound": p50 / bound["bound_s"], "attention_by_layer": attn,
            "row_excess": run["row_excess"], "logits_max_abs_diff": run["logits_max_abs_diff"],
            "near_ties": run["near_ties"], "max_memory_allocated": peak}


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
    _measured(ctx, "lm-gemma2-2b prefill", step_s=prefill_s)
    _measured(ctx, "lm-gemma2-2b decode step", step_s=float(np.quantile(step_s, 0.5)))
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
    t0 = time.monotonic()
    seqshard = _lm_seqshard(ctx, cfg, params, full, tok, prompt + n_decode + 16)
    emit("lm.seqshard", **seqshard, seconds=time.monotonic() - t0, nvidia_smi=ctx["smi"])
    del full
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    long = _lm_long(ctx, cfg, params)
    emit("lm.long", **long, seconds=time.monotonic() - t0, nvidia_smi=ctx["smi"])
    check = _on_card_and_cpu_agree(cfg, params)
    emit("lm.card_vs_cpu", **check, nvidia_smi=ctx["smi"])


# phase lm_moe: qwen3-moe-30b-a3b at full width on a 1x1 mesh of the card,
# 24 of its 48 layers (cut for time: it pays for lm.seqshard, lm.long and
# train.mesh): 4 prompts of 2,048 tokens into a 2,176-slot cache (a
# multiple of decode_block_s 128 past the prompt), then 64 greedy steps;
# the card-vs-CPU check on 2 prompts of 256 tokens at 2 layers
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_BATCH, MOE_PROMPT, MOE_SLOTS, MOE_DECODE, MOE_CHECK_PROMPT = 4, 2048, 2176, 64, 256
MOE_LAYERS = 24


def _moe_serving_config():
    """The published config at ``MOE_LAYERS`` layers (full width)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
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
    bound_ms, bound_by, flops, n_bytes = _bound(flash_attn.cost(q, k, v))
    attn = {"ms": cuda_ms(kern, reps=20, warmup=2),
            "plain_ms": cuda_ms(lambda: flash_attn.flash_attention_ref(q, k, v, window=None,
                                                                        cap=None), reps=2),
            "library_ms": cuda_ms(lib, reps=20, warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by, **close,
            "route": flash_attn.route(bf16, hd),
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
    dec_bound_ms, dec_bound_by, _, _ = _bound(flash_decode.cost(q, kc, vc, t))
    dec = {"ms": graph_ms(kern, 50),
           "plain_ms": cuda_ms(lambda: flash_decode.flash_decode_ref(q, kc, vc, t, window=None,
                                                                      cap=None), reps=10),
           "library_ms": graph_ms(lib, 50),
           "bound_ms": dec_bound_ms, "bound_by": dec_bound_by, **close,
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
    full_cfg = cfg or _moe_serving_config()
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
    if not plan["depth_cut"]:
        _measured(ctx, "lm-qwen3-moe decode step", step_s=float(np.quantile(steps, 0.5)))
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
         expert_bound_ms=expert_bytes / HBM_BW * 1e3,
         step_bytes=step_bytes, step_bound_ms=step_bytes / HBM_BW * 1e3,
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


TRAIN_ARCH = "h2o-danube-1.8b"
# train.grads: full width, 2 layers, 1 x 512 tokens; train.full: full depth,
# 2 x 8,192 (the window of 4,096 bites past 4,096), 4 steps; train.resume:
# 2 layers, 8 steps, a failure before step 5, a checkpoint every 4 steps
GRAD_BATCH, GRAD_SEQ = 1, 512
FULL_BATCH, FULL_SEQ, FULL_STEPS, FULL_LR = 2, 8192, 4, 1e-3
RESUME_BATCH, RESUME_SEQ, RESUME_STEPS, RESUME_FAIL, RESUME_EVERY = 2, 1024, 8, 5, 4
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 256
# train.mesh: full width, 2 of 24 layers (cut for time), 2 x 512 tokens on a
# (2, 2) mesh of the card; the sign-compressed driver on a (2, 1) mesh
MESH_LAYERS, MESH_BATCH, MESH_SHAPE, MESH_DRIVER = 2, 2, (2, 2), (2, 1)
RECSYS_ARCHS = ("fm", "dcn-v2", "mind", "sasrec")
RECSYS_STEPS, RECSYS_BATCH, RECSYS_LR = 15, 32, 3e-3
# card against CPU, bfloat16, 2 layers: each gradient leaf's relative L2
# error and its cosine. Both sides run the same ops in bfloat16 (every
# product rounds to bfloat16, 2^-8 relative, at other places on cuBLAS and
# oneDNN; the flash kernel against the plain version), compounded through
# two layers forward and back: a few 1e-3 relative on a leaf, so 0.05 and a
# cosine of 0.998 leave room for that and none for a missing or misplaced
# term (a leaf without gradient, the control, has error 1 and cosine 0).
# The MoE's routed leaves add the routing flips at near-ties (ROUTER_MARGIN):
# a flipped token moves its gradient to another expert. They are the router,
# the experts, and ffn_norm, whose gradient reaches it through them alone
# (qwen3-moe has no dense FFN); its other leaves are held to GRAD_REL /
# GRAD_COS
GRAD_REL, GRAD_COS = 0.05, 0.998
MOE_GRAD_REL, MOE_GRAD_COS = 0.1, 0.995
MOE_ROUTED = ("router", "ffn_norm", "w_gate", "w_up", "w_down")
# the LM example (float32, TF32 off) on the card against the CPU from its
# trained weights: every product is float32 on both devices, in another
# summation order (about 1e-7 relative a sum, some 1e-5 compounded through
# six layers forward and back), so the loss within 1e-4 (some 1e-5
# relative), each gradient leaf within 1e-3 relative L2 and a cosine of
# 0.99999, and the decode logits within FLASH_TOL's float32 limits
EXAMPLE_LOSS_TOL, EXAMPLE_GRAD_REL, EXAMPLE_GRAD_COS = 1e-4, 1e-3, 0.99999
# the reduced recsys configs, float32 with TF32 off, card against CPU
RECSYS_TOL = 1e-5


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev).clone()


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _bits(t):
    """A tensor's bytes as integers of its width (equal bits, NaN or not)."""
    import torch

    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.detach().contiguous().view(width)


def _differing_leaves(a: dict, b: dict) -> list:
    """The leaves (params, both moments, step, residual) whose bits differ."""
    import torch

    from repro_torch.checkpoint.checkpoint import _flatten

    ta = _flatten({"params": a["params"], "opt": a["opt"], "ef": a["ef"]})
    tb = dict(_flatten({"params": b["params"], "opt": b["opt"], "ef": b["ef"]}))
    return [k for k, t in ta if not torch.equal(_bits(t), _bits(tb[k]))]


def _grads_of(cfg, params, batch, dev, ctx_fn=None):
    """Loss and every leaf's gradient of the LM loss at ``params`` on ``dev``."""
    import torch

    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tfm

    ctx = ctx_fn(dev) if ctx_fn else tfm.ModelContext(cfg=cfg)
    (loss, metrics), grads = train_cli.value_and_grad(
        tfm.make_loss_fn(ctx, chunk=min(256, batch["tokens"].shape[1])), params,
        {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
    return float(loss), grads


def _compare_grads(card, cpu, rel_lim, cos_lim, routed_limits=None) -> dict:
    """Each leaf's relative L2 error and cosine, card against CPU; a leaf with
    no gradient or an all-zero one fails. ``routed_limits`` (rel, cos) hold
    the MoE's routed leaves (`MOE_ROUTED`) instead."""
    import torch

    rows, bad = {}, []
    cpu_leaves = dict(_named_leaves(cpu))
    for name, g in _named_leaves(card):
        if g is None or not bool((g != 0).any()):
            bad.append(f"{name}: no gradient on the card")
            continue
        # float64: a float32 norm over 4e8 elements drifts by more than
        # the differences it measures
        g, w = g.cpu().double(), cpu_leaves[name].double()
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        cos = float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))
        del g, w
        rel_max, cos_min = (routed_limits if routed_limits and name.rsplit("/", 1)[-1]
                            in MOE_ROUTED else (rel_lim, cos_lim))
        rows[name] = {"rel_l2": rel, "cos": cos}
        if not (rel <= rel_max and cos >= cos_min):
            bad.append(f"{name}: relative L2 {rel} (limit {rel_max}), cosine {cos} "
                       f"(limit {cos_min})")
    return {"leaves": rows, "failures": bad}


def _train_grads(ctx, cfg_full, dev="cuda") -> None:
    """Full width, 2 layers, bfloat16: the loss and every leaf's gradient on
    the card against the CPU's, from the same weights (seeded on the CPU);
    then the control: the same step with the bare kernel (no autograd
    function) must fail the check."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    batch = synthetic.make_lm_batch(batch=GRAD_BATCH, seq_len=GRAD_SEQ, vocab=cfg.vocab,
                                    seed=0)
    t0 = time.monotonic()
    cpu_loss, cpu_grads = _grads_of(cfg, _tree_to(params, "cpu"), batch, "cpu")
    cpu_s = time.monotonic() - t0
    ops.reset_launches()
    card_loss, card_grads = _grads_of(cfg, _tree_to(params, dev), batch, dev)
    launches = dict(ops.LAUNCHES)
    check = _compare_grads(card_grads, cpu_grads, GRAD_REL, GRAD_COS)
    loss_diff = abs(card_loss - cpu_loss)
    if loss_diff > LM_TOL or check["failures"]:
        raise AssertionError(f"card vs CPU: loss {card_loss} / {cpu_loss}; "
                             f"{check['failures']}")
    if launches["flash_attention"] != 2 * cfg.n_layers:  # the forward and remat's recompute
        raise AssertionError(f"{launches} launches for {cfg.n_layers} layers under remat")
    real = ops.flash_attention_train
    ops.flash_attention_train = lambda q, k, v, bwd_block=None, **kw: ops.flash_attention(
        q, k, v, **kw)
    try:
        _, bare = _grads_of(cfg, _tree_to(params, dev), batch, dev)
    finally:
        ops.flash_attention_train = real
    control = _compare_grads(bare, cpu_grads, GRAD_REL, GRAD_COS)
    if not control["failures"]:
        raise AssertionError("the bare-kernel control passes the gradient check")
    del card_grads, cpu_grads, bare
    emit("train.grads", arch=cfg.name, layers=cfg.n_layers, tokens=[GRAD_BATCH, GRAD_SEQ],
         dtype=cfg.dtype, head_dim=cfg.hd, loss_card=card_loss, loss_cpu=cpu_loss,
         loss_abs_diff=loss_diff, loss_tol=LM_TOL, rel_l2_limit=GRAD_REL, cos_limit=GRAD_COS,
         leaves=check["leaves"], launches=launches, cpu_s=cpu_s,
         control_failures=control["failures"], nvidia_smi=ctx["smi"])


def _train_flash_geometry(ctx, cfg, dev="cuda") -> None:
    """The flash kernel at the training cell's geometry (bf16, head_dim 80
    on the mma.sync route, 32 query heads over 8 KV heads, window 4,096,
    B 2 x S 8,192) against its plain version, timed beside SDPA (a boolean
    window mask) and beside the attention backward of the training path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    bf16 = torch.bfloat16
    b, s, h, kv, hd, w = FULL_BATCH, FULL_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.sliding_window
    q = _rows(70, (b, s, h, hd), bf16)
    k, v = _rows(71, (b, s, kv, hd), bf16), _rows(72, (b, s, kv, hd), bf16)
    kern = lambda: flash_attn.flash_attention_cuda(q, k, v, causal=True, window=w, cap=None,
                                                   block_q=128, block_k=128)
    close = _flash_close("attn danube", kern(), flash_attn.flash_attention_ref(
        q, k, v, window=w, cap=None), bf16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < w)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    torch.testing.assert_close(lib().transpose(1, 2).float(), kern().float(), rtol=3e-2,
                               atol=3e-2, msg="sdpa danube")
    do = _rows(73, (b, s, h, hd), bf16)
    bwd = lambda: flash_attn.flash_attention_bwd(q, k, v, do, window=w, cap=None,
                                                 block=cfg.q_block)
    bound_ms, bound_by, flops, _ = _bound(flash_attn.cost(q, k, v, window=w))
    line = {"ms": cuda_ms(kern, reps=10, warmup=2),
            "plain_ms": cuda_ms(lambda: flash_attn.flash_attention_ref(q, k, v, window=w,
                                                                       cap=None), reps=1),
            "library_ms": cuda_ms(lib, reps=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, **close,
            "route": flash_attn.route(bf16, hd),
            "backward_ms": cuda_ms(bwd, reps=2, warmup=1),
            "backward_bound_ms": 1e3 * 2.5 * flops / PEAKS["bf16"],
            "shape": f"B {b}, S {s}, H {h}, KV {kv}, hd {hd}, bf16, causal, window {w}, "
                     "no cap"}
    del q, k, v, qt, kt, vt, do, mask
    torch.cuda.empty_cache()
    if "flash_attention" in ctx["kernels"]:
        ctx["kernels"]["flash_attention"]["training_geometry"] = {key: line[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "backward_ms")}
    emit("train.flash", arch=cfg.name, flash_attention=line,
         timing_note="SDPA with a boolean causal-window mask is a yardstick, never used by "
         "the port; backward_ms is flash_attention_bwd (torch ops, one 512-row query block "
         "at a time), its bound the 2.5x forward products at the bf16 peak",
         nvidia_smi=ctx["smi"])


def _model_flops(cfg, b: int, s: int) -> dict:
    """A step's model operations: 6 N tokens over the matmul parameters (all
    but the embedding table), plus attention's 12 B H hd pairs a layer
    (forward 4, backward 8); remat adds one more forward of both."""
    from repro_torch.kernels import flash_attn

    n_matmul = cfg.param_count() - cfg.vocab * cfg.d_model
    pairs = flash_attn.window_pairs(s, cfg.sliding_window)
    attn = 4 * b * cfg.n_heads * cfg.hd * pairs * cfg.n_layers
    tokens = b * s
    return {"matmul_params": n_matmul, "tokens": tokens, "attention_pairs": pairs,
            "model_flops": 6 * n_matmul * tokens + 3 * attn,
            "with_remat_flops": 8 * n_matmul * tokens + 4 * attn,
            "count": "6 N T + 12 B H hd pairs L (model); 8 N T + 16 B H hd pairs L with "
                     "remat's recompute"}


def _profiled_step(cfg, out, dev) -> dict:
    """One more training step of ``out``'s state through the driver's
    `build_lm` and `make_train_step`, under `torch.profiler` (device busy
    and idle time), split by CUDA events around the loss (the forward),
    `adamw_update` (the optimizer) and each attention backward call; the
    backward is what lies between the loss and the optimizer."""
    import torch

    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.kernels import flash_attn
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw

    mesh = _card_mesh((1, 1), ("data", "model"), dev)
    loss_fn, make_batch, _ = train_cli.build_lm(cfg, mesh, rules_for_mesh(mesh),
                                                batch=FULL_BATCH, seq=FULL_SEQ, seed=0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in make_batch(FULL_STEPS).items()}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    bwd_pairs = []
    real_bwd, real_update = flash_attn.flash_attention_bwd, train_cli.adamw_update

    def between(i, fn):
        def timed(*a, **k):
            events[i].record()
            r = fn(*a, **k)
            events[i + 1].record()
            return r
        return timed

    def timed_bwd(*a, **k):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e[0].record()
        r = real_bwd(*a, **k)
        e[1].record()
        bwd_pairs.append(e)
        return r

    step = train_cli.make_train_step(between(0, loss_fn), adamw.cosine_schedule(
        FULL_LR, warmup=1, total=FULL_STEPS))
    flash_attn.flash_attention_bwd, train_cli.adamw_update = timed_bwd, between(2, real_update)
    try:
        prof = _device_profile(lambda: step(out["params"], out["opt"], None, batch))
    finally:
        flash_attn.flash_attention_bwd, train_cli.adamw_update = real_bwd, real_update
    torch.cuda.synchronize()
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
    attn_bwd = sum(a.elapsed_time(b) for a, b in bwd_pairs)
    rows, busy, wall = prof["rows"], prof["device_busy_s"], prof["wall_s"]
    return {"forward_ms": ms[0], "backward_ms": ms[1], "optimizer_ms": ms[2],
            "attention_backward_ms": attn_bwd, "attention_backward_calls": len(bwd_pairs),
            "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if busy else "not measured",
            "top": [{"kernel": k[:120], "s": d, "calls": c} for k, d, c in rows[:12]]}


def _train_full(ctx, cfg, dev="cuda") -> None:
    """h2o-danube-1.8b at full width and depth, bfloat16 parameters, float32
    moments, remat "nothing": 4 steps of 2 x 8,192 tokens through
    `launch.train.train` (the first is warm-up), then one profiled step."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    out = train_cli.train(cfg, steps=FULL_STEPS, batch=FULL_BATCH, seq=FULL_SEQ, lr=FULL_LR,
                          device=dev)
    run_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ctx.setdefault("paths", {})["train"] = {"flash_attention": launches["flash_attention"]}
    losses = [h["loss"] for h in out["history"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    if launches["flash_attention"] != 2 * cfg.n_layers * FULL_STEPS:
        raise AssertionError(f"{launches} for {FULL_STEPS} steps of {cfg.n_layers} layers "
                             "(forward and remat's recompute)")
    step_s = [h["dt"] for h in out["history"]]
    steps = np.array(step_s[1:])  # the first step is warm-up
    p50 = float(np.quantile(steps, 0.5))
    flops = _model_flops(cfg, FULL_BATCH, FULL_SEQ)
    state_bytes = sum(t.numel() * t.element_size() for _, t in _named_leaves(
        {"p": out["params"], "m": out["opt"].m, "v": out["opt"].v}))
    profile = _profiled_step(cfg, out, dev)
    del out
    torch.cuda.empty_cache()
    _measured(ctx, "train-danube-1.8b step", step_s=p50, max_memory_allocated=peak)
    emit("train.full", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, d_ff=cfg.d_ff,
         vocab=cfg.vocab, window=cfg.sliding_window, dtype=cfg.dtype,
         opt_dtype=cfg.opt_dtype, remat=cfg.remat, remat_policy=cfg.remat_policy,
         params=cfg.param_count(), batch=FULL_BATCH, seq=FULL_SEQ, steps=FULL_STEPS,
         lr=FULL_LR, losses=losses, step_s=step_s,
         step_s_p50=p50, step_s_max=float(steps.max()), run_s=run_s,
         tokens_per_s=FULL_BATCH * FULL_SEQ / p50, **flops,
         model_flops_per_s=flops["model_flops"] / p50,
         mfu_bf16=flops["model_flops"] / p50 / PEAKS["bf16"],
         with_remat_share=flops["with_remat_flops"] / p50 / PEAKS["bf16"],
         flash_attention_launches=launches["flash_attention"],
         flash_attention_launches_per_step=launches["flash_attention"] // FULL_STEPS,
         state_bytes=state_bytes, max_memory_allocated=peak, profile=profile,
         nvidia_smi=ctx["smi"])


def _train_resume(ctx, cfg_full, dev="cuda") -> None:
    """Full width, 2 layers: two straight runs of 8 steps give the same bytes;
    a run that fails before step 5 and resumes from step 4's checkpoint
    gives the straight run's bytes (parameters, both moments, step)."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train as train_cli

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    kw = dict(steps=RESUME_STEPS, batch=RESUME_BATCH, seq=RESUME_SEQ, device=dev,
              ckpt_every=RESUME_EVERY)
    d = os.path.join(OUT, "train_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    straight = train_cli.train(cfg, **kw)
    again = train_cli.train(cfg, **kw)
    differ = _differing_leaves(straight, again)
    if differ:
        raise AssertionError(f"two straight runs differ in {differ[:5]}")
    del again
    try:
        train_cli.train(cfg, ckpt_dir=d, fail_at_step=RESUME_FAIL, **kw)
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    latest = ckpt.latest_step(d)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    resumed = train_cli.train(cfg, ckpt_dir=d, **kw)
    resume_run_s = time.monotonic() - t0
    differ = _differing_leaves(straight, resumed)
    if differ or latest != RESUME_EVERY or resumed["history"][0]["step"] != RESUME_EVERY:
        raise AssertionError(f"resume from step {latest}: leaves differ {differ[:5]}")
    if [h["loss"] for h in resumed["history"]] != [h["loss"] for h in
                                                   straight["history"][RESUME_EVERY:]]:
        raise AssertionError("the resumed run's losses are not the straight run's")
    tree = {"params": resumed["params"], "opt": resumed["opt"], "ef": resumed["ef"]}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ckpt.save(d, 99, tree)
    save_s = time.monotonic() - t0
    t0 = time.monotonic()
    back = ckpt.restore(d, 99, tree, device=dev)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    if _differing_leaves(resumed, back):
        raise AssertionError("a saved and restored state differs")
    n_bytes = sum(os.path.getsize(os.path.join(d, "step_00000099", f))
                  for f in os.listdir(os.path.join(d, "step_00000099")))
    del straight, resumed, back, tree
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("train.resume", arch=cfg.name, layers=cfg.n_layers, tokens=[RESUME_BATCH, RESUME_SEQ],
         steps=RESUME_STEPS, fail_at_step=RESUME_FAIL, resumed_from=latest,
         straight_runs_equal=True, resume_equal=True, checkpoint_bytes=n_bytes,
         save_s=save_s, restore_s=restore_s, resume_run_s=resume_run_s,
         nvidia_smi=ctx["smi"])


def _train_compress(ctx, cfg_full, dev="cuda") -> None:
    """``--grad-compress topk`` and ``sign``, 4 steps at 2 layers, twice
    each: finite losses, a residual that is not zero, the same bytes."""
    import numpy as np
    import torch

    from repro_torch.launch import train as train_cli

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    kw = dict(steps=4, batch=RESUME_BATCH, seq=RESUME_SEQ, device=dev)
    lines = {}
    for kind in ("topk", "sign"):
        t0 = time.monotonic()
        a = train_cli.train(cfg, grad_compress=kind, **kw)
        run_s = time.monotonic() - t0
        b = train_cli.train(cfg, grad_compress=kind, **kw)
        losses = [h["loss"] for h in a["history"]]
        resid = sum(float(r.abs().sum()) for _, r in _named_leaves(a["ef"].residual))
        differ = _differing_leaves(a, b)
        if differ or not np.isfinite(losses).all() or not resid > 0:
            raise AssertionError(f"{kind}: differ {differ[:5]}, losses {losses}, "
                                 f"residual {resid}")
        lines[kind] = {"losses": losses, "residual_l1": resid, "run_s": run_s,
                       "residual_bytes": sum(r.numel() * 4 for _, r in
                                             _named_leaves(a["ef"].residual)),
                       "two_runs_equal": True}
        del a, b
        torch.cuda.empty_cache()
    emit("train.compress", arch=cfg.name, layers=cfg.n_layers, steps=4,
         tokens=[RESUME_BATCH, RESUME_SEQ], **lines, nvidia_smi=ctx["smi"])


def _train_mesh(ctx, cfg_full, dev="cuda") -> None:
    """``train.mesh``: full width, ``MESH_LAYERS`` layers, bfloat16. The
    loss and every leaf's gradient on a (2, 2) mesh of the card (the loss
    over 2 ``dp`` shards' rows and 2 ``tp`` shards' blocks of the
    vocabulary) against the one-shard step on the same batch and weights,
    within ``train.grads``' limits; then the driver with
    ``grad_compress="sign"`` on a (2, 1) mesh (the loader's 2 ``dp``
    shards) for 2 steps beside the one-shard driver: losses within
    ``LM_TOL``, a residual that is not zero."""
    import numpy as np
    import torch

    from repro_torch.data import synthetic
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(cfg_full, n_layers=MESH_LAYERS)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = synthetic.make_lm_batch(batch=MESH_BATCH, seq_len=GRAD_SEQ, vocab=cfg.vocab, seed=0)
    one_loss, one_grads = _grads_of(cfg, params, batch, dev)
    one_grads = _tree_to(one_grads, "cpu")
    mesh = make_test_mesh(*MESH_SHAPE, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.monotonic()
    loss, grads = _grads_of(cfg, params, batch, dev,
                            ctx_fn=lambda d: tfm.make_context(cfg, mesh, rules_for_mesh(mesh)))
    torch.cuda.synchronize()
    mesh_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    check = _compare_grads(grads, one_grads, GRAD_REL, GRAD_COS)
    if abs(loss - one_loss) > LM_TOL or check["failures"]:
        raise AssertionError(f"(2, 2) mesh vs one shard: loss {loss} / {one_loss}; "
                             f"{check['failures']}")
    if launches["flash_attention"] != 2 * cfg.n_layers:  # the forward and remat's recompute
        raise AssertionError(f"{launches} launches for {cfg.n_layers} layers under remat")
    del params, grads, one_grads
    torch.cuda.empty_cache()
    kw = dict(steps=2, batch=MESH_BATCH, seq=RESUME_SEQ, grad_compress="sign", device=dev)
    ops.reset_launches()
    t0 = time.monotonic()
    run = train_cli.train(cfg, mesh=make_test_mesh(*MESH_DRIVER, device=dev), **kw)
    driver_s = time.monotonic() - t0
    driver_launches = dict(ops.LAUNCHES)
    ref = train_cli.train(cfg, **kw)
    losses, ref_losses = ([h["loss"] for h in r["history"]] for r in (run, ref))
    resid = sum(float(r.abs().sum()) for _, r in _named_leaves(run["ef"].residual))
    if not np.isfinite(losses).all() or not resid > 0 or \
            max(abs(a - b) for a, b in zip(losses, ref_losses)) > LM_TOL:
        raise AssertionError(f"sign driver on {MESH_DRIVER}: losses {losses} against one "
                             f"shard's {ref_losses}, residual {resid}")
    del run, ref
    torch.cuda.empty_cache()
    ctx.setdefault("paths", {})["train.mesh"] = {
        "flash_attention": launches["flash_attention"] + driver_launches["flash_attention"]}
    emit("train.mesh", arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
         mesh=list(MESH_SHAPE), tokens=[MESH_BATCH, GRAD_SEQ], loss_mesh=loss,
         loss_one_shard=one_loss, loss_abs_diff=abs(loss - one_loss), loss_tol=LM_TOL,
         rel_l2_limit=GRAD_REL, cos_limit=GRAD_COS, leaves=check["leaves"], launches=launches,
         mesh_grad_s=mesh_s, driver={"mesh": list(MESH_DRIVER), "grad_compress": "sign",
                                     "steps": 2, "tokens": [MESH_BATCH, RESUME_SEQ],
                                     "losses": losses, "one_shard_losses": ref_losses,
                                     "residual_l1": resid, "run_s": driver_s,
                                     "launches": driver_launches},
         nvidia_smi=ctx["smi"])


def _moe_train_ctx(cfg, tokens):
    def build(dev):
        from repro_torch.distributed.sharding import rules_for_mesh
        from repro_torch.models import transformer as tfm

        mesh = _card_mesh((1, 1), ("data", "model"), dev)
        return tfm.make_context(cfg, mesh, rules_for_mesh(mesh), tokens_per_shard=tokens)

    return build


def _train_moe(ctx, dev="cuda", cfg=None) -> None:
    """qwen3-moe-30b-a3b at full width, 2 layers, bfloat16: the card's loss
    and gradients against the CPU's at 2 x 256 tokens (routing flips only at
    near-ties), then 3 training steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.launch import train as train_cli
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(cfg or get_config(MOE_ARCH), n_layers=2)
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    batch = synthetic.make_lm_batch(batch=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ,
                                    vocab=cfg.vocab, seed=0)
    routes = {"cpu": [], "card": []}
    real = moe.router_topk
    results = {}
    try:
        for where, dev_ in (("cpu", "cpu"), ("card", dev)):
            def recording(logits, k, where=where):
                probs, w, ids = real(logits, k)
                routes[where].append((probs.detach().float().cpu(), ids.cpu()))
                return probs, w, ids

            moe.router_topk = recording
            t0 = time.monotonic()
            results[where] = _grads_of(cfg, _tree_to(params, dev_), batch, dev_,
                                       _moe_train_ctx(cfg, tokens))
            results[where + "_s"] = time.monotonic() - t0
    finally:
        moe.router_topk = real
    # the forward's router calls (remat's recompute repeats them)
    n_fwd = cfg.n_layers
    flips = _route_flips(routes["cpu"][:n_fwd], routes["card"][:n_fwd], n_fwd)
    check = _compare_grads(results["card"][1], results["cpu"][1], GRAD_REL, GRAD_COS,
                           routed_limits=(MOE_GRAD_REL, MOE_GRAD_COS))
    loss_diff = abs(results["card"][0] - results["cpu"][0])
    if loss_diff > LM_TOL or check["failures"]:
        raise AssertionError(f"MoE card vs CPU: loss diff {loss_diff}; {check['failures']}; "
                             f"flips {flips}")
    del results["card"], results["cpu"], params
    kept = []
    real_dispatch, moe._dispatch = _counting_dispatch(kept)
    try:
        out = train_cli.train(cfg, steps=3, batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
                              device=dev)
    finally:
        moe._dispatch = real_dispatch
    routed = len(kept) * tokens * cfg.top_k
    dropped = 1.0 - float(torch.stack(kept).sum()) / routed
    losses = [h["loss"] for h in out["history"]]
    step_s = [h["dt"] for h in out["history"]]
    del out
    torch.cuda.empty_cache()
    emit("train.moe", arch=cfg.name, layers=cfg.n_layers, tokens=[MOE_TRAIN_BATCH,
                                                                 MOE_TRAIN_SEQ],
         capacity=moe.capacity_for(tokens, cfg.top_k, cfg.n_experts, cfg.capacity_factor),
         loss_abs_diff=loss_diff, rel_l2_limit=GRAD_REL, cos_limit=GRAD_COS,
         routed_leaves=MOE_ROUTED, routed_rel_l2_limit=MOE_GRAD_REL,
         routed_cos_limit=MOE_GRAD_COS,
         leaves=check["leaves"], router_margin_nats=ROUTER_MARGIN,
         routing_flips=sum(f["flipped_tokens"] for f in flips),
         routed_tokens=sum(f["tokens"] for f in flips),
         flips_by_call=[f for f in flips if f["flipped_tokens"]],
         cpu_s=results["cpu_s"], card_s=results["card_s"], losses=losses,
         step_s=step_s, dropped_share=dropped, routed_pairs=routed,
         nvidia_smi=ctx["smi"])


def _recsys_run(cfg, dev, params=None) -> dict:
    """15 steps of the driver's recsys step (`launch.train`'s
    ``build_recsys`` and ``make_train_step``) from ``params`` (seeded on
    ``dev`` when None)."""
    import torch

    from repro_torch.data.loader import ShardedBatchLoader
    from repro_torch.launch import train as train_cli
    from repro_torch.models import recsys
    from repro_torch.optim import adamw

    mesh = _card_mesh((1, 1), ("data", "model"), dev)
    loss_fn, make_batch, init = train_cli.build_recsys(cfg, mesh, None, batch=RECSYS_BATCH,
                                                       seed=0)
    if params is None:
        params = init(torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw.adamw_init(params)
    step = train_cli.make_train_step(loss_fn, adamw.cosine_schedule(
        RECSYS_LR, warmup=max(RECSYS_STEPS // 10, 1), total=RECSYS_STEPS))
    loader = ShardedBatchLoader(mesh, ("data",), make_batch)
    losses, dts = [], []
    try:
        for i in range(RECSYS_STEPS):
            b = loader.get(i)
            t0 = time.monotonic()
            params, opt, _, metrics = step(params, opt, None, b)
            losses.append(float(metrics["loss"]))
            dts.append(time.monotonic() - t0)
    finally:
        loader.close()
    n = sum(t.numel() for _, t in _named_leaves(params))
    return {"losses": losses, "step_s": dts, "params": n, "state": params}


def _train_recsys(ctx, dev="cuda", config=None) -> None:
    """The four recsys archs at their full published widths, 15 steps of 32
    at lr 3e-3 (the reference test's setting) on the card; then the reduced
    configs on the card and the CPU from the same weights, losses within
    RECSYS_TOL."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import recsys

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the float32 recsys steps would not hold to the CPU's")
    lines = {}
    for arch in RECSYS_ARCHS:
        cfg = (config or get_config)(arch)
        torch.cuda.reset_peak_memory_stats()
        full = _recsys_run(cfg, dev)
        peak = torch.cuda.max_memory_allocated()
        del full["state"]
        torch.cuda.empty_cache()
        if not np.isfinite(full["losses"]).all():
            raise AssertionError(f"{arch}: non-finite losses {full['losses']}")
        if arch == "dcn-v2" and not full["losses"][-1] < full["losses"][0]:
            raise AssertionError(f"dcn-v2's loss does not fall: {full['losses']}")
        p50 = float(np.quantile(full["step_s"][1:], 0.5))
        small = reduced_config(arch)
        seed = recsys.init_params(small, torch.Generator().manual_seed(0))
        cpu = _recsys_run(small, "cpu", _tree_to(seed, "cpu"))
        card = _recsys_run(small, dev, _tree_to(seed, dev))
        diff = float(np.abs(np.array(card["losses"]) - np.array(cpu["losses"])).max())
        if diff > RECSYS_TOL:
            raise AssertionError(f"{arch} reduced: card vs CPU losses differ by {diff}")
        lines[arch] = {"params": full["params"], "losses": full["losses"],
                       "loss_falls": full["losses"][-1] < full["losses"][0],
                       "step_s_p50": p50, "rows_per_s": RECSYS_BATCH / p50,
                       "max_memory_allocated": peak, "reduced_card_vs_cpu": diff}
    emit("train.recsys", steps=RECSYS_STEPS, batch=RECSYS_BATCH, lr=RECSYS_LR,
         tol=RECSYS_TOL, **lines, nvidia_smi=ctx["smi"])


def _kept_calls(fn, kept: dict, last: bool = False):
    """``fn`` wrapped to keep a copy of the arguments of its first call
    (``last``: its latest) at each geometry: the shapes and dtypes of its
    tensors and its keyword arguments."""
    import torch

    def kept_fn(*args, **kwargs):
        key = (tuple((tuple(a.shape), str(a.dtype)) for a in args[:3]),
               tuple(sorted(kwargs.items())))
        if last or key not in kept:
            kept[key] = ([a.detach().clone() if isinstance(a, torch.Tensor) else a
                          for a in args], kwargs)
        return fn(*args, **kwargs)

    return kept_fn


def _example_lm_card_vs_cpu(lm: dict, params, dev="cuda") -> dict:
    """The LM example's trained weights on the card and on the CPU: the
    flash kernels at the example's own calls (float32, hd 64, 8 query heads
    over 4 KV heads, cap 50, windows 128 and none; a 64-slot decode cache)
    against their plain versions on the same inputs (FLASH_TOL); one
    training step's loss and every gradient leaf; the 16 decode steps'
    logits, both devices fed the card's greedy tokens."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attn, flash_decode, ops

    cfg = lm["cfg_100m"]()
    on_cpu = _tree_to(params, "cpu")
    batch = synthetic.make_lm_batch(batch=8, seq_len=256, vocab=cfg.vocab, seed=0, chunk=0)
    attn_calls, decode_calls = {}, {}
    real = ops.flash_attention, ops.flash_decode
    ops.flash_attention = _kept_calls(real[0], attn_calls)
    ops.flash_decode = _kept_calls(real[1], decode_calls, last=True)
    try:
        card_loss, card_grads = _grads_of(cfg, params, batch, dev)
        card_tokens, card_logits = lm["decode"](cfg, params, dev)
    finally:
        ops.flash_attention, ops.flash_decode = real
    kernels = []
    for (shapes, kw), (args, kwargs) in attn_calls.items():
        name = f"example attn {shapes[0][0]} {dict(kw)}"
        want = flash_attn.flash_attention_ref(
            *args, **{k: kwargs[k] for k in ("causal", "window", "cap") if k in kwargs})
        kernels.append({"case": name, **_flash_close(name, real[0](*args, **kwargs), want,
                                                     args[0].dtype)})
    for (shapes, kw), (args, kwargs) in decode_calls.items():
        name = f"example decode {shapes[1][0]} t {int(args[3])} {dict(kw)}"
        want = flash_decode.flash_decode_ref(
            *args, **{k: kwargs[k] for k in ("window", "cap") if k in kwargs})
        kernels.append({"case": name, **_flash_close(name, real[1](*args, **kwargs), want,
                                                     args[0].dtype)})
    if len(attn_calls) < 2 or len(decode_calls) < 2:
        raise AssertionError(f"the example's local and global layers: {len(attn_calls)} "
                             f"attention and {len(decode_calls)} decode geometries")
    cpu_loss, cpu_grads = _grads_of(cfg, on_cpu, batch, "cpu")
    grads = _compare_grads(card_grads, cpu_grads, EXAMPLE_GRAD_REL, EXAMPLE_GRAD_COS)
    loss_diff = abs(card_loss - cpu_loss)
    if loss_diff > EXAMPLE_LOSS_TOL or grads["failures"]:
        raise AssertionError(f"example card vs CPU: loss {card_loss} / {cpu_loss}; "
                             f"{grads['failures']}")
    _, cpu_logits = lm["decode"](cfg, on_cpu, "cpu", feed=card_tokens)
    rtol, atol = FLASH_TOL["float32"]
    logit_diffs = []
    for i, (got, want) in enumerate(zip(card_logits, cpu_logits)):
        torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=atol,
                                   msg=f"example decode step {i}")
        logit_diffs.append(float((got.cpu() - want).abs().max()))
    return {"kernels": kernels, "loss_card": card_loss, "loss_cpu": cpu_loss,
            "loss_abs_diff": loss_diff, "loss_tol": EXAMPLE_LOSS_TOL,
            "grad_rel_l2_max": max(r["rel_l2"] for r in grads["leaves"].values()),
            "grad_cos_min": min(r["cos"] for r in grads["leaves"].values()),
            "grad_limits": [EXAMPLE_GRAD_REL, EXAMPLE_GRAD_COS],
            "decode_logits_max_abs_diff": max(logit_diffs), "decode_tol": [rtol, atol],
            "greedy_tokens": card_tokens}


def _train_examples(ctx, dev="cuda") -> None:
    """``examples/torch_train_lm.py`` (40 steps with a failure injected at
    25 and the resume, then 16 greedy tokens) and
    ``examples/torch_candidate_retrieval.py`` (MIND's 8-dim vectors, which
    the kernel's wrapper pads) on the card, in this process, their launches
    counted; then the LM example's kernels, loss, gradients and decode held
    to the plain versions and the CPU (`_example_lm_card_vs_cpu`), and the
    retrieval's rankings against the CPU's run under the dense near-tie
    rule."""
    import runpy

    from _torch_parity import assert_rankings_close
    from repro_torch.kernels import ops

    ex = os.path.join(ROOT, "examples")
    d = os.path.join(OUT, "example_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    lm = runpy.run_path(os.path.join(ex, "torch_train_lm.py"))
    ops.reset_launches()
    t0 = time.monotonic()
    summary = lm["main"](["--steps", "40", "--ckpt-every", "10", "--fail-at-step", "25",
                          "--ckpt-dir", d, "--device", dev])
    lm_s = time.monotonic() - t0
    lm_launches = dict(ops.LAUNCHES)
    shutil.rmtree(d, ignore_errors=True)
    params = summary.pop("params")
    if summary["resumed_from"] != 20 or not lm_launches["flash_decode"] \
            or not lm_launches["flash_attention"]:
        raise AssertionError(f"torch_train_lm: {summary}, launches {lm_launches}")
    t0 = time.monotonic()
    lm_check = _example_lm_card_vs_cpu(lm, params, dev)
    lm_check_s = time.monotonic() - t0
    del params
    cr = runpy.run_path(os.path.join(ex, "torch_candidate_retrieval.py"))
    ops.reset_launches()
    t0 = time.monotonic()
    card = cr["main"](["--device", dev])
    cr_s = time.monotonic() - t0
    cr_launches = dict(ops.LAUNCHES)
    cpu = cr["main"](["--device", "cpu"])
    if not cr_launches["score_topk"]:
        raise AssertionError(f"torch_candidate_retrieval launched {cr_launches}")
    assert_rankings_close(card["first_interest"]["scores"], card["first_interest"]["ids"],
                          cpu["first_interest"]["scores"], cpu["first_interest"]["ids"],
                          what="first interest")
    for u, (g, w) in enumerate(zip(card["merged"], cpu["merged"])):
        assert_rankings_close(g["scores"], g["ids"], w["scores"], w["ids"], what=f"user {u}")
    ctx.setdefault("paths", {})["train_examples"] = {
        "flash_attention": lm_launches["flash_attention"],
        "flash_decode": lm_launches["flash_decode"], "score_topk": cr_launches["score_topk"]}
    emit("train.examples", train_lm=summary, train_lm_s=lm_s, train_lm_launches=lm_launches,
         train_lm_card_vs_cpu=lm_check, train_lm_check_s=lm_check_s, retrieval_s=cr_s,
         retrieval_launches=cr_launches, retrieval_serve_s=card["serve_s"],
         retrieval_dim=card["dim"], retrieval_rankings_equal_cpu=True, nvidia_smi=ctx["smi"])


def phase_train(ctx, dev="cuda", cfg=None) -> None:
    import torch

    from repro_torch.configs import get_config

    ctx.pop("collection", None)
    torch.cuda.empty_cache()
    cfg = cfg or get_config(TRAIN_ARCH)
    _train_flash_geometry(ctx, cfg, dev)
    _train_grads(ctx, cfg, dev)
    _train_full(ctx, cfg, dev)
    _train_resume(ctx, cfg, dev)
    _train_compress(ctx, cfg, dev)
    _train_mesh(ctx, cfg, dev)
    _train_moe(ctx, dev)
    _train_recsys(ctx, dev)
    _train_examples(ctx, dev)


# ---------------------------------------------------------------------------
# phase gnn: PNA (`repro_torch.models.gnn`; its segment reduces are torch ops,
# as the reference's are jax.ops outside any Pallas kernel)
# ---------------------------------------------------------------------------

# card against CPU at the reduced config: float64 logits and every gradient
# leaf within the CPU tests' TOL, elementwise. float32 logits (and the (4,)
# bucketed forward against the (1,) one at ogbn-products' size) within
# GNN_F32_TOL of the largest logit: the same messages are summed in the same
# order, but products run on other libraries or row counts, and four layers
# of the seeded init's ~60x growth amplify one rounding, so an element near
# zero misses any elementwise limit (tests/test_torch_gnn.py: the reference's
# own jitted and eager forwards differ by 8.6e-7 of the largest logit, and
# by 2.6e-4 elementwise, at 48 nodes)
GNN_TOL = {"rtol": 1e-5, "atol": 1e-5}
GNN_F32_TOL = 1e-5
GNN_PEAK_LIMIT = 45e9
GNN_FWD_REPS = 3
GNN_TRAIN_STEPS = {"minibatch_lg": 10, "full_graph_sm": 20, "molecule": 20}


def _gnn_inputs(dev, dtype, n_nodes=64, n_edges=512, d_feat=9):
    """Reduced-size inputs of every regime, seeded: a `make_graph` graph
    (its labels), a 2-hop tree of 16 seeds with fanout (5, 3) (random
    features: no group of repeated neighbours, whose zero variance gives the
    reference's own NaN gradient, held on the CPU by
    tests/test_torch_gnn.py), 4 molecules of 10 nodes."""
    import numpy as np
    import torch

    from repro_torch.data import synthetic

    g = synthetic.make_graph(n_nodes=n_nodes, n_edges=n_edges, d_feat=d_feat, seed=4)
    rng = np.random.default_rng(1)
    sb = {"seed_x": rng.standard_normal((16, d_feat)),
          "hop1_x": rng.standard_normal((16, 5, d_feat)),
          "hop2_x": rng.standard_normal((16, 5, 3, d_feat)),
          "labels": rng.integers(0, 1 << 10, 16)}
    mol = {"x": rng.standard_normal((4, 10, d_feat)), "src": rng.integers(0, 10, (4, 20)),
           "dst": rng.integers(0, 10, (4, 20))}

    def t(a):
        a = torch.as_tensor(np.asarray(a))
        return (a.to(dtype) if a.is_floating_point() else a).to(dev)

    return g, {k: t(v) for k, v in sb.items()}, {k: t(v) for k, v in mol.items()}, t


def _gnn_regimes(cfg, dev, dtype):
    """``{name: (logits_fn(params), labels)}`` for every regime on ``dev``:
    the full graph; bucketed and scatter on (1,) and (4,) meshes of
    ``dev``; sampled; batched."""
    from repro_torch.data import graph_prep
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.models import gnn

    g, sb, mol, t = _gnn_inputs(dev, dtype)
    n = g["x"].shape[0]
    y = t(g["y"] % cfg.n_classes)
    out = {"full": (lambda p: gnn.forward_full_graph(p, t(g["x"]), t(g["src"]), t(g["dst"]),
                                                     cfg), y),
           "sampled": (lambda p: gnn.forward_sampled(p, sb["seed_x"], sb["hop1_x"],
                                                     sb["hop2_x"], cfg),
                       sb["labels"] % cfg.n_classes),
           "batched": (lambda p: gnn.forward_batched_graphs(p, mol["x"], mol["src"],
                                                            mol["dst"], cfg), y[:4])}
    for shards in (1, 4):
        mesh = _card_mesh((shards,), ("data",), dev)
        bs, bd, _ = graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=n, n_shards=shards)
        for mode, (s, d) in (("bucketed", (bs, bd)), ("scatter", (g["src"], g["dst"]))):
            fwd = gnn.make_sharded_full_graph(mesh, rules_for_mesh(mesh), cfg, mode=mode)
            out[f"{mode}_{shards}"] = ((lambda f, s, d: lambda p: f(p, t(g["x"]), t(s), t(d)))(
                fwd, s, d), y)
    return out


def _gnn_logits_grads(cfg, params, dev, dtype) -> dict:
    """Each regime's logits and every leaf's gradient of its loss on ``dev``
    (``params`` drawn on the CPU, cast to ``dtype``), back on the CPU."""
    from repro_torch.launch import train as train_cli
    from repro_torch.models import gnn

    res = {}
    for name, (fn, labels) in _gnn_regimes(cfg, dev, dtype).items():
        p = _tree_to({k: v for k, v in params.items()}, dev)
        p = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dtype)) for k, v in p.items()}
        kept = {}

        def loss_fn(q, _):
            kept["logits"] = fn(q)
            loss = gnn.xent_loss(kept["logits"], labels)
            return loss, {"loss": loss}

        _, grads = train_cli.value_and_grad(loss_fn, p, None)
        res[name] = [("logits", kept["logits"].detach().cpu())] + [
            (k, v.cpu()) for k, v in _named_leaves(grads)]
    return res


def _gnn_ties(dev) -> dict:
    """The hand-worked ties on ``dev``: a segment max tied three ways under
    a negative gradient (a third each, where torch's own segment_reduce
    backward gives each the whole), and the cross-shard max split first
    among shards, then among edges (tests/test_torch_gnn.py)."""
    import torch

    from repro_torch.models import gnn, segment

    x = torch.tensor([[1.0], [1.0], [1.0], [0.0]], device=dev, requires_grad=True)
    seg = segment.segments(torch.tensor([0, 0, 0, 1], device=dev), 2)
    out = seg.reduce(seg.take(x), "max")
    grad, = torch.autograd.grad(out, x, grad_outputs=torch.tensor([[-0.5], [2.0]], device=dev))
    want = [-0.5 / 3] * 3 + [2.0]
    if not torch.allclose(grad.ravel().cpu(), torch.tensor(want), rtol=0, atol=1e-7):
        raise AssertionError(f"segment max ties: {grad.ravel().tolist()} != {want}")
    m0 = torch.tensor([[3.0], [3.0], [1.0]], device=dev, requires_grad=True)
    m1 = torch.tensor([[3.0], [1.0], [1.0]], device=dev, requires_grad=True)
    aggs = [gnn.partial_aggregates(m, torch.tensor(d, device=dev), 2)
            for m, d in ((m0, [0, 0, 1]), (m1, [0, 1, 1]))]
    merged = gnn.merge_aggregates(aggs)
    (merged[0]["max"][0].sum() + merged[1]["max"][1].sum()).backward()
    got = [m0.grad.ravel().tolist(), m1.grad.ravel().tolist()]
    if got != [[0.25, 0.25, 0.0], [0.0, 0.25, 0.25]]:
        raise AssertionError(f"cross-shard ties: {got}")
    return {"segment_max_tie_grads": grad.ravel().tolist(), "cross_shard_tie_grads": got}


def _gnn_steps(cfg, params, kind, batch, mesh, steps: int, dev) -> tuple:
    """``steps`` AdamW steps at the cells' schedule through
    `launch.train.make_train_step` over `build_gnn`'s loss -> (params,
    losses)."""
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw

    step = train_cli.make_train_step(
        train_cli.build_gnn(cfg, kind, mesh, rules_for_mesh(mesh)), train_cli.GNN_LR)
    params = _tree_to(params, dev)
    opt = adamw.adamw_init(params)
    losses = []
    for _ in range(steps):
        params, opt, _, metrics = step(params, opt, None, batch)
        losses.append(float(metrics["loss"]))
    return params, losses


def _gnn_parity(ctx, dev="cuda") -> None:
    """Reduced `pna` on the card against the CPU in every regime, twice on
    the card (the same bytes), 3 training steps twice on cora's graph and
    on 128 molecules (the same bytes), and the hand-worked ties."""
    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.data import graph_prep
    from repro_torch.models import gnn

    t0 = time.monotonic()
    cfg = reduced_config("pna")
    params = gnn.init_params(cfg, 9, torch.Generator().manual_seed(0))
    worst = {}
    for dtype in (torch.float64, torch.float32):
        card = _gnn_logits_grads(cfg, params, dev, dtype)
        cpu = _gnn_logits_grads(cfg, params, "cpu", dtype)
        again = _gnn_logits_grads(cfg, params, dev, dtype)
        for name in cpu:
            if dtype == torch.float64:
                for (leaf, got), (_, want) in zip(card[name], cpu[name]):
                    torch.testing.assert_close(got, want, **GNN_TOL,
                                               msg=lambda m: f"gnn {name} {leaf}: {m}")
                    key = f"float64_{name}"
                    worst[key] = max(worst.get(key, 0.0), float((got - want).abs().max()))
            else:
                got, want = card[name][0][1], cpu[name][0][1]
                err = float((got - want).abs().max()) / float(want.abs().max())
                worst[f"float32_{name}_logits_over_largest"] = err
                if err > GNN_F32_TOL:
                    raise AssertionError(f"gnn {name} float32 logits: {err} of the largest")
            for (leaf, a), (_, b) in zip(card[name], again[name]):
                if not torch.equal(_bits(a), _bits(b)):
                    raise AssertionError(f"gnn {name} {leaf}: two runs on the card differ")
    # training bytes at sizes past the small-gather paths: cora's graph
    # (bucketed to 45,056 edges) and 128 molecules of 64 edges
    from repro_torch.configs import shapes_for
    from repro_torch.data import synthetic

    cora = shapes_for("pna")["full_graph_sm"].dims
    g = synthetic.make_graph(n_nodes=cora["n_nodes"], n_edges=cora["n_edges"], d_feat=9, seed=5)
    bs, bd, _ = graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=cora["n_nodes"],
                                        n_shards=1, bucket_size=cora["n_edges_padded"])
    rng = np.random.default_rng(3)
    batches = {
        "full_graph": {"x": g["x"], "src": bs, "dst": bd, "labels": g["y"] % cfg.n_classes},
        "batched_graphs": {"x": rng.standard_normal((128, 30, 9)).astype(np.float32),
                           "src": rng.integers(0, 30, (128, 64)),
                           "dst": rng.integers(0, 30, (128, 64)),
                           "labels": rng.integers(0, cfg.n_classes, 128)}}
    mesh = _card_mesh((1,), ("data",), dev)
    train_losses = {}
    for kind, b in batches.items():
        b = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
        runs = [_gnn_steps(cfg, params, kind, b, mesh, 3, dev) for _ in range(2)]
        differ = [k for (k, a), (_, c) in zip(_named_leaves(runs[0][0]),
                                               _named_leaves(runs[1][0]))
                  if not torch.equal(_bits(a), _bits(c))]
        if differ or runs[0][1] != runs[1][1]:
            raise AssertionError(f"gnn training ({kind}): two runs differ in {differ}")
        train_losses[kind] = runs[0][1]
    ties = _gnn_ties(dev)
    emit("gnn.parity", config="reduced pna", regimes=sorted(worst), tol_float64=GNN_TOL,
         tol_float32_logits_of_largest=GNN_F32_TOL, max_diff=worst, two_runs_same_bytes=True,
         train_3_steps_same_bytes=True, train_losses=train_losses, **ties,
         seconds=time.monotonic() - t0, nvidia_smi=ctx["smi"])


def _gnn_memory_plan(n_nodes: int, n_edges: int, d: int, d_feat: int, cfg) -> dict:
    """The products forward's memory, reckoned before it runs (float32)."""
    from repro_torch.models import gnn

    edge_row = d * 4
    feats = (1 + gnn.n_agg_feats(cfg)) * d * 4
    return {
        "one_edge_tensor_bytes": n_edges * edge_row,
        "naive_layer_bytes": 5 * n_edges * edge_row,  # h[src], h[dst], 2 products, m, ...
        "naive_feats_bytes": n_nodes * feats,
        "inputs_bytes": n_nodes * d_feat * 4 + 2 * n_edges * 4,
        "node_tensors_bytes": 6 * n_nodes * edge_row,  # h, the products, 4 aggregates
        "block_bytes": 3 * gnn.EDGE_BLOCK * edge_row + gnn.EDGE_BLOCK * (8 + 8),
        "block_feats_bytes": 2 * gnn.EDGE_BLOCK * feats,  # a block's destinations, upper bound
        "segments_bytes": n_edges * 8 + n_nodes * 8,
    }


def _gnn_forward(fwd, params, x, src, dst, reps: int) -> tuple:
    """A warm-up forward under `torch.no_grad`, then ``reps`` timed ones ->
    (logits, seconds of each)."""
    import torch

    with torch.no_grad():
        out = fwd(params, x, src, dst)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fwd(params, x, src, dst)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
    return out, times


def _gnn_products(ctx, dev="cuda", dims=None, reps=GNN_FWD_REPS) -> None:
    """Full `pna` (4 layers, d 75) over a `make_graph` graph at ogbn-products'
    size, under `torch.no_grad`: bucketed on a (1,) and a (4,) mesh of the
    card, seconds (p50 of ``reps`` after a warm-up), edges x layers a
    second, peak memory beside the reckoning, one profiled pass."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, shapes_for
    from repro_torch.data import graph_prep, synthetic
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.models import gnn

    t0 = time.monotonic()
    d = dims or shapes_for("pna")["ogb_products"].dims
    cfg = dataclasses.replace(get_config("pna"), n_classes=d["n_classes"])
    n, e = d["n_nodes"], d["n_edges"]
    g = synthetic.make_graph(n_nodes=n, n_edges=e, d_feat=d["d_feat"],
                             n_classes=d["n_classes"], seed=5, device=dev)
    make_s = time.monotonic() - t0
    plan = _gnn_memory_plan(n, e, cfg.d_hidden, d["d_feat"], cfg)
    params = gnn.init_params(cfg, d["d_feat"], torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    x = torch.as_tensor(g["x"]).to(dev)
    lines, outs = {}, {}
    for shards in (1, 4):
        tb = time.monotonic()
        bs, bd, bucket = graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=n, n_shards=shards)
        bucket_s = time.monotonic() - tb
        src, dst = torch.as_tensor(bs).to(dev), torch.as_tensor(bd).to(dev)
        mesh = _card_mesh((shards,), ("data",), dev)
        fwd = gnn.make_sharded_full_graph(mesh, rules_for_mesh(mesh), cfg)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, times = _gnn_forward(fwd, params, x, src, dst, reps)
        p50 = float(np.quantile(times, 0.5))
        peak = torch.cuda.max_memory_allocated()
        if not torch.isfinite(out).all():
            raise AssertionError(f"products forward on ({shards},): non-finite logits")
        if peak > GNN_PEAK_LIMIT:
            raise AssertionError(f"products forward on ({shards},): peak {peak} B over "
                                 f"{GNN_PEAK_LIMIT:.0f}")
        prof = _device_profile(lambda: _gnn_forward(fwd, params, x, src, dst, 0))
        busy, wall = prof["device_busy_s"], prof["wall_s"]
        outs[shards] = out
        lines[f"mesh_{shards}"] = {
            "bucket_size": bucket, "bucket_edges_s": bucket_s, "forward_s_p50": p50,
            "forward_s": times, "edge_layers_per_s": e * cfg.n_layers / p50,
            "max_memory_allocated": peak, "memory_above_inputs": peak - base,
            "profile": {"wall_s": wall, "device_busy_s": busy,
                        "idle_share": 1.0 - busy / wall if busy else "not measured",
                        "top": [{"op": k[:120], "s": s, "calls": c}
                                for k, s, c in prof["rows"][:10]]}}
        del src, dst
    scale = float(outs[1].abs().max())
    shard_err = float((outs[4] - outs[1]).abs().max()) / scale
    if shard_err > GNN_F32_TOL:
        raise AssertionError(f"products: (4,) vs (1,) max diff {shard_err} of the largest "
                             f"logit, over {GNN_F32_TOL}")
    same_class = float((outs[4].argmax(-1) == outs[1].argmax(-1)).float().mean())
    del outs, x, params
    torch.cuda.empty_cache()
    if dims is None:
        _measured(ctx, "gnn-products-fwd", step_s=lines["mesh_1"]["forward_s_p50"],
                  max_memory_allocated=lines["mesh_1"]["max_memory_allocated"],
                  edges=lines["mesh_1"]["bucket_size"])
    emit("gnn.products", config="pna", layers=cfg.n_layers, d_hidden=cfg.d_hidden,
         nodes=n, edges=e, d_feat=d["d_feat"], classes=d["n_classes"],
         edge_block=gnn.EDGE_BLOCK, make_graph_s=make_s, memory_plan=plan,
         peak_limit=GNN_PEAK_LIMIT, **lines,
         mesh4_vs_mesh1={"max_diff_over_max_logit": shard_err, "limit": GNN_F32_TOL,
                         "largest_logit": scale, "same_argmax_share": same_class,
                         "forward_s_ratio": lines["mesh_4"]["forward_s_p50"]
                         / lines["mesh_1"]["forward_s_p50"]},
         seconds=time.monotonic() - t0, nvidia_smi=ctx["smi"])


def _gnn_train(ctx, dev="cuda", dims=None, steps=None) -> None:
    """AdamW steps of full-width `pna` at the three trainable shapes of
    `configs/shapes.py`: reddit's sampled minibatches (the host's share of
    a step beside the card's), cora's full graph (bucketed on a (1,) mesh,
    as the reference's cells train it), 128 molecules."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, shapes_for
    from repro_torch.data import graph_prep, sampler, synthetic
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch import train as train_cli
    from repro_torch.models import gnn
    from repro_torch.optim import adamw

    t_phase = time.monotonic()
    shapes = dims or {k: v.dims for k, v in shapes_for("pna").items()}
    steps = steps or GNN_TRAIN_STEPS
    lines = {}

    def run(name, kind, make_batch, rows, d, mesh=None):
        cfg = dataclasses.replace(get_config("pna"), n_classes=d["n_classes"])
        params = gnn.init_params(cfg, d["d_feat"], torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
        mesh = mesh or _card_mesh((1,), ("data",), dev)
        step = train_cli.make_train_step(
            train_cli.build_gnn(cfg, kind, mesh, rules_for_mesh(mesh)), train_cli.GNN_LR)
        opt = adamw.adamw_init(params)
        torch.cuda.reset_peak_memory_stats()
        host, copy, card, losses = [], [], [], []
        for i in range(steps[name] + 1):  # step 0 is warm-up
            t0 = time.monotonic()
            b = make_batch(i)
            t1 = time.monotonic()
            b = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
            torch.cuda.synchronize()
            t2 = time.monotonic()
            params, opt, _, metrics = step(params, opt, None, b)
            losses.append(float(metrics["loss"]))
            t3 = time.monotonic()
            host.append(t1 - t0)
            copy.append(t2 - t1)
            card.append(t3 - t2)
        if not np.isfinite(losses).all():
            raise AssertionError(f"gnn.train {name}: non-finite losses {losses}")
        total = np.array(host[1:]) + np.array(copy[1:]) + np.array(card[1:])
        p50 = float(np.quantile(total, 0.5))
        lines[name] = {"kind": kind, "steps": steps[name], "rows": rows, "losses": losses,
                       "step_s_p50": p50, "step_s": total.tolist(), "rows_per_s": rows / p50,
                       "host_s_p50": float(np.quantile(host[1:], 0.5)),
                       "copy_s_p50": float(np.quantile(copy[1:], 0.5)),
                       "card_s_p50": float(np.quantile(card[1:], 0.5)),
                       "host_share": float(np.median((np.array(host[1:]) + np.array(copy[1:]))
                                                     / total)),
                       "max_memory_allocated": torch.cuda.max_memory_allocated()}

    d = shapes["minibatch_lg"]
    t0 = time.monotonic()
    g = synthetic.make_graph(n_nodes=d["n_nodes"], n_edges=d["n_edges"], d_feat=d["d_feat"],
                             n_classes=d["n_classes"], seed=5, device=dev)
    csr = sampler.build_csr(g["src"], g["dst"], g["x"], g["y"])
    del g
    prep_s = time.monotonic() - t0
    run("minibatch_lg", "minibatch", lambda i: sampler.sample_batch(
        csr, batch_nodes=d["batch_nodes"], fanout=d["fanout"], seed=0, step=i),
        d["batch_nodes"], d)
    lines["minibatch_lg"].update(graph_nodes=d["n_nodes"], graph_edges=d["n_edges"],
                                 fanout=d["fanout"], graph_prep_s=prep_s,
                                 hop2_x_bytes=d["batch_nodes"] * d["fanout"][0]
                                 * d["fanout"][1] * d["d_feat"] * 4)
    del csr

    d = shapes["full_graph_sm"]
    g = synthetic.make_graph(n_nodes=d["n_nodes"], n_edges=d["n_edges"], d_feat=d["d_feat"],
                             n_classes=d["n_classes"], seed=5)
    bs, bd, _ = graph_prep.bucket_edges(g["src"], g["dst"], n_nodes=d["n_nodes"], n_shards=1,
                                        bucket_size=d["n_edges_padded"])
    cora = {"x": g["x"], "src": bs, "dst": bd, "labels": g["y"]}
    run("full_graph_sm", "full_graph", lambda i: cora, d["n_nodes"], d)

    d = shapes["molecule"]

    def molecules(i):
        rng = np.random.default_rng((5, i))
        b, n, e = d["batch"], d["n_nodes"], d["n_edges"]
        return {"x": rng.standard_normal((b, n, d["d_feat"])).astype(np.float32),
                "src": rng.integers(0, n, (b, e)).astype(np.int32),
                "dst": rng.integers(0, n, (b, e)).astype(np.int32),
                "labels": rng.integers(0, d["n_classes"], b).astype(np.int32)}

    run("molecule", "batched_graphs", molecules, d["batch"], d)
    torch.cuda.empty_cache()
    emit("gnn.train", config="pna", lr="cosine 3e-4, warm-up 100, total 10,000", **lines,
         seconds=time.monotonic() - t_phase, nvidia_smi=ctx["smi"])


def phase_gnn(ctx, dev="cuda") -> None:
    import torch

    from repro_torch.kernels import ops

    ctx.pop("collection", None)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ops.reset_launches()
    _gnn_parity(ctx, dev)
    _gnn_products(ctx, dev)
    _gnn_train(ctx, dev)
    launches = dict(ops.LAUNCHES)
    # no kernel of the four lies on the GNN's path (the reference has none there)
    ctx.setdefault("paths", {})["gnn"] = launches
    if any(launches.values()):
        raise AssertionError(f"the GNN path launched {launches}")
    emit("gnn", launches=launches, seconds=time.monotonic() - t0, nvidia_smi=ctx["smi"])


# ---------------------------------------------------------------------------
# phase lower: the lowering tools (`launch.cells`, `dryrun`, `opcount`,
# `roofline`) on meta tensors — host work, no kernel may launch
# ---------------------------------------------------------------------------

LOWER_MESHES = ("1", "16x16")
LOWER_CELLS = 43  # configs.all_cells(include_mirex=True), each ok on each mesh
# the dry-run's processes: the host's cores, at most 8 (one H100's machine)
LOWER_WORKERS = min(8, os.cpu_count() or 1)
# the reckoned peak against max_memory_allocated: within this share, or the
# gap is named
LOWER_PEAK_TOL = 0.25


def _measured(ctx, cell: str, **values) -> None:
    """A phase's measured figures for one of the chip script's cells, which
    phase ``lower`` sets beside its roofline bound."""
    ctx.setdefault("measured", {})[cell] = values


def _lower_cells(ctx) -> dict:
    """The chip script's own cells at the shapes its phases run, each
    ``(step, args, note)`` on meta tensors, built by the entry points those
    phases call."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, shapes_for
    from repro_torch.core import scoring
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch import cells
    from repro_torch.launch import train as train_cli
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    mesh = cells.meta_mesh("1")
    rules = rules_for_mesh(mesh)
    out = {}
    # train.full: launch.train's step, 2 x 8,192 tokens, float32 moments
    cfg = get_config(TRAIN_ARCH)
    loss_fn, _, _ = train_cli.build_lm(cfg, mesh, rules, batch=FULL_BATCH, seq=FULL_SEQ, seed=0)
    step = train_cli.make_train_step(
        loss_fn, adamw.cosine_schedule(FULL_LR, warmup=1, total=FULL_STEPS))
    shapes = tfm.param_shapes(cfg)
    batch = {"tokens": meta((FULL_BATCH, FULL_SEQ), i32), "labels": meta((FULL_BATCH, FULL_SEQ), i32)}
    out["train-danube-1.8b step"] = (step, (
        cells.abstract(shapes),
        cells.abstract(adamw.adamw_state_shapes(shapes, getattr(torch, cfg.opt_dtype))),
        meta(()), batch), f"{FULL_BATCH} x {FULL_SEQ} tokens, 24 layers, remat")
    # lm: gemma2-2b prefill of 4 x 8,192, a decode step over 8,704 slots
    cfg = get_config("gemma2-2b")
    params = cells.abstract(tfm.param_shapes(cfg))
    out["lm-gemma2-2b prefill"] = (tfm.make_prefill_step(cfg), (
        params, meta((LM_BATCH, LM_PROMPT), i32)), f"{LM_BATCH} x {LM_PROMPT} tokens")
    out["lm-gemma2-2b decode step"] = (tfm.make_serve_step(cfg, batch=LM_BATCH), (
        params, cells.abstract(tfm.cache_shapes(cfg, LM_BATCH, LM_SLOTS)), meta((LM_BATCH,), i32),
        LM_PROMPT + LM_DECODE // 2), f"{LM_SLOTS} slots, counted at t = "
        f"{LM_PROMPT + LM_DECODE // 2}, the middle of the run's {LM_PROMPT}.."
        f"{LM_PROMPT + LM_DECODE - 1}")
    # lm_moe: qwen3-moe's decode step, 4 tokens, 2,176 slots, a 1x1 mesh
    cfg = _moe_serving_config()
    moe_ctx = tfm.make_context(cfg, mesh, rules, tokens_per_shard=MOE_BATCH)
    out["lm-qwen3-moe decode step"] = (tfm.make_serve_step(moe_ctx, batch=MOE_BATCH), (
        cells.abstract(tfm.param_shapes(cfg)),
        cells.abstract(tfm.cache_shapes(cfg, MOE_BATCH, MOE_SLOTS)), meta((MOE_BATCH,), i32),
        MOE_PROMPT + MOE_DECODE // 2), f"{MOE_SLOTS} slots, counted at t = "
        f"{MOE_PROMPT + MOE_DECODE // 2}, the middle of the run's {MOE_PROMPT}.."
        f"{MOE_PROMPT + MOE_DECODE - 1}")
    # gnn.products: pna's forward on a (1,) mesh, the run's bucketed edges
    dims = shapes_for("pna")["ogb_products"].dims
    cfg = dataclasses.replace(get_config("pna"), n_classes=dims["n_classes"])
    mesh1 = cells.Mesh([torch.device("meta")], ("data",))
    fwd = gnn.make_sharded_full_graph(mesh1, rules_for_mesh(mesh1), cfg)
    edges = ctx.get("measured", {}).get("gnn-products-fwd", {}).get("edges", dims["n_edges"])

    def forward(p, x, src, dst):
        with torch.no_grad():
            return fwd(p, x, src, dst)

    out["gnn-products-fwd"] = (forward, (
        cells.abstract(gnn.param_shapes(cfg, dims["d_feat"])),
        meta((dims["n_nodes"], dims["d_feat"])), meta((edges,), i32), meta((edges,), i32)),
        f"{dims['n_nodes']} nodes, {edges} edges, torch.no_grad; meta sorts every slab and "
        "keeps every edge")
    # serve.dense: one 64-query block of DenseSession's dense_dot scan
    k, chunk = get_config("mirex").k, get_config("mirex").chunk_size
    out["serve-dense-16M block"] = (
        lambda q, d: ops.score_topk(q, d, k=k, block_d=chunk),
        (meta((64, 256)), meta((DENSE_DOCS, 256))), "64 queries x 2^24 x 256 float32, k 1000")
    # experiment: one mirex-8M segment's scan kernel (bm25-grid, 5 models)
    spec = _mirex_spec()
    rows = spec.chunk_size * spec.segment_chunks
    vocab = spec.vocab
    stats = scoring.CollectionStats(meta((vocab,), i32), meta((vocab,), i32), meta((), i32),
                                    meta((), i32), meta(()))

    def segment(q, d, dl):
        modes, w, ab = scoring.lexical_epilogues(_bm25_grid(), q, stats)
        return ops.lexical_scan_topk(q, w, ab, d, dl, modes=modes, k=spec.k, block_d=16_384,
                                     tile_d=16)

    out["mirex-8M segment"] = (segment, (
        meta((spec.n_queries, get_config("mirex").max_q_len), i32),
        meta((rows, spec.max_doc_len), i32), meta((rows,), i32)),
        f"{rows} docs x {spec.max_doc_len}, {spec.n_queries} queries, 5 models, k {spec.k}")
    return out


def _lower_bounds(ctx) -> dict:
    """Each of the chip script's cells counted on meta: its roofline bound
    beside what this call measured (``not measured`` when its phase did
    not run)."""
    from repro_torch.launch import opcount, roofline

    measured = ctx.get("measured", {})
    kernel_ms = {"serve-dense-16M block": ("score_topk", "ms"),
                 "mirex-8M segment": ("lexical_scan_topk", "ms")}
    lines = {}
    for name, (fn, args, note) in _lower_cells(ctx).items():
        t0 = time.monotonic()
        with opcount.OpCounter(1) as counter:
            counter.track(args)
            fn(*args)
        hlo = counter.result()
        b = roofline.bound(hlo)
        got = measured.get(name, {})
        line = {**b, "counted_flops": hlo["flops"], "flops_by_class": hlo["flops_by_class"],
                "counted_bytes": hlo["bytes_accessed"], "reckoned_peak_bytes": hlo["peak_bytes"],
                "kernels": hlo["kernels"], "count_s": time.monotonic() - t0, "note": note,
                "measured_s": got.get("step_s", got.get("block_s", "not measured"))}
        if name in kernel_ms:
            entry = ctx["kernels"].get(kernel_ms[name][0], {})
            line["kernel_measured_s"] = (entry["ms"] * 1e-3 if "ms" in entry
                                         else "not measured")
        if isinstance(line["measured_s"], float):
            line["measured_over_bound"] = line["measured_s"] / b["bound_s"]
        if "max_memory_allocated" in got:
            peak = got["max_memory_allocated"]
            line["max_memory_allocated"] = peak
            line["reckoned_over_measured_peak"] = hlo["peak_bytes"] / peak
            if abs(hlo["peak_bytes"] / peak - 1) > LOWER_PEAK_TOL:
                raise AssertionError(f"{name}: reckoned peak {hlo['peak_bytes']} B, measured "
                                     f"{peak} B, more than {LOWER_PEAK_TOL:.0%} apart")
        lines[name] = line
    return lines


def phase_lower(ctx, workers: int = LOWER_WORKERS) -> None:
    """The dry-run over every cell on the one-H100 mesh and the 16x16 mesh
    (``workers`` processes, all on meta), then the chip script's own cells
    counted at their shapes, each bound beside this call's measurement. No
    kernel may launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    t0 = time.monotonic()
    before = dict(ops.LAUNCHES)
    summary = {}
    recs = dryrun.sweep(LOWER_MESHES, force=True, quiet=True, workers=workers)
    for r in recs:
        if not r["ok"]:
            raise AssertionError(f"{r['mesh']} {r['arch']} x {r['shape']}: {r['error']}")
        if any(r["launches"].values()):
            raise AssertionError(f"{r['arch']} x {r['shape']} launched {r['launches']}")
        m = summary.setdefault(r["mesh"], {"cells": 0, "ok": 0, "slowest_s": 0.0})
        m["cells"] += 1
        m["ok"] += 1
        m["slowest_s"] = max(m["slowest_s"], sum(r["timing_s"].values()))
    for mesh_name in LOWER_MESHES:
        if summary.get(mesh_name, {}).get("ok") != LOWER_CELLS:
            raise AssertionError(f"the {mesh_name} mesh's dry-run: {summary.get(mesh_name)}, "
                                 f"{LOWER_CELLS} cells expected")
    sweep_s = time.monotonic() - t0
    bounds = _lower_bounds(ctx)
    if ops.LAUNCHES != before:
        raise AssertionError(f"phase lower launched kernels: {before} -> {dict(ops.LAUNCHES)}")
    emit("lower", meshes=summary, sweep_s=sweep_s, workers=workers, bounds=bounds,
         launches={k: ops.LAUNCHES[k] - before[k] for k in before},
         seconds=time.monotonic() - t0, nvidia_smi=ctx["smi"])


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
    sys.path.insert(1, os.path.join(ROOT, "tests"))  # the CPU tests' parity rule
    import repro_torch  # noqa: F401 — fails here when the repository is absent

    os.makedirs(OUT, exist_ok=True)
    from repro_torch.obs import gpu_name_and_power_limit

    ctx = {"kernels": {}, "launches": {}, "smi": gpu_name_and_power_limit()}
    table = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
             "experiment": phase_experiment, "paper": phase_paper, "tune": phase_tune,
             "resume": phase_resume, "serve": phase_serve, "mesh": phase_mesh, "lm": phase_lm,
             "lm_moe": phase_lm_moe, "train": phase_train, "gnn": phase_gnn,
             "lower": phase_lower}
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
