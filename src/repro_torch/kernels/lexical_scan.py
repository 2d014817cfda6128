"""The multi-model lexical scan: its plain PyTorch version and its CUDA launch.

Both compute what the JAX package's Pallas kernel `lexical_scan_topk_pallas`
(`repro.kernels.lexical_scan`) computes: for every query the int32
frequency of each query term in every document's raw token row, each
model's epilogue (`scoring.apply_epilogue`) on that shared tf, and each
(model, query)'s top ``k`` documents by (score desc, id asc), with
``(-inf, -1)`` in empty slots and zero-length rows never ranked.

* :func:`lexical_scan_topk_ref` is the plain version, the reference's fold
  written in tensor ops: per ``block_d`` rows, ``term_frequencies`` (tiled
  over ``L_d`` by ``tile_d``), ``apply_epilogue``, a stable descending sort
  for the block's top k, and ``bitonic_merge_desc`` into the running state.
  It runs wherever its tensors live.
* :func:`lexical_scan_topk_cuda` launches the hand-written kernel
  (``csrc/lexical_scan.cu``) on CUDA tensors. It takes the same arguments;
  ``block_d`` is the doc range one CTA scans and ``tile_d`` (rounded up to a
  whole warp) the rows it stages per step. Neither changes a bit of the
  result.

The public entry point is `repro_torch.kernels.ops.lexical_scan_topk`, which
picks between the two by the tensors' device and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pipeline import next_pow2
from repro_torch.core.scoring import (
    EpilogueMode,
    LexicalEpilogue,
    apply_epilogue,
    safe_queries,
    term_frequencies,
)
from repro_torch.core.topk import sort_key
from repro_torch.kernels import _build
from repro_torch.kernels.score_topk import _pad_desc, bitonic_merge_desc

_MODE_KIND = {"ql": 0, "bm25": 1, "tfidf": 2}
# one CTA's shared memory on sm_90 (227 KB)
SMEM_LIMIT = 232448
MAX_K = 8192  # k_pad * 8 B * 2 lists per model must leave room in one CTA


def mode_codes(modes: tuple[EpilogueMode, ...]) -> list[int]:
    """Each mode as the kernel's int code: kind | prior << 2 | rsqrt << 3."""
    codes = []
    for m in modes:
        if m.mode not in _MODE_KIND:
            raise ValueError(f"unknown epilogue mode {m.mode!r}")
        if m.length_norm not in ("none", "rsqrt"):
            raise ValueError(f"unknown length norm {m.length_norm!r}")
        codes.append(
            _MODE_KIND[m.mode] | (int(m.length_prior) << 2)
            | (int(m.length_norm == "rsqrt") << 3)
        )
    return codes


def _check_args(q_tokens, weights, ab, d_tokens, d_len, modes, k, block_d, tile_d):
    n_q, l_q = q_tokens.shape
    n_d = d_tokens.shape[0]
    n_models = weights.shape[0]
    if len(modes) != n_models:
        raise ValueError(f"{len(modes)} modes for {n_models} weight tables")
    if tuple(weights.shape) != (n_models, n_q, l_q):
        raise ValueError(f"weights {tuple(weights.shape)} != {(n_models, n_q, l_q)}")
    if tuple(ab.shape) != (n_models, 2):
        raise ValueError(f"ab {tuple(ab.shape)} != {(n_models, 2)}")
    if tuple(d_len.shape) != (n_d,):
        raise ValueError(f"d_len {tuple(d_len.shape)} != {(n_d,)}")
    if k < 1 or block_d < 1 or tile_d < 1:
        raise ValueError(f"k, block_d, tile_d must be >= 1, got {k}, {block_d}, {tile_d}")
    if n_d % block_d:
        raise ValueError(f"{n_d} docs not divisible by block_d {block_d}")


def lexical_scan_topk_ref(
    q_tokens: torch.Tensor,  # [n_q, L_q] int32, PAD_TOKEN-padded
    weights: torch.Tensor,  # [n_models, n_q, L_q] f32
    ab: torch.Tensor,  # [n_models, 2] f32
    d_tokens: torch.Tensor,  # [n_d, L_d] int32, PAD_TOKEN-padded
    d_len: torch.Tensor,  # [n_d] int32
    *,
    modes: tuple[EpilogueMode, ...],
    k: int,
    block_d: int = 512,
    tile_d: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version -> ``(scores, ids) [n_models, n_q, k]``, ids local to
    ``d_tokens`` (0-based), ``(-inf, -1)`` in empty slots."""
    _check_args(q_tokens, weights, ab, d_tokens, d_len, modes, k, block_d, tile_d)
    n_q = q_tokens.shape[0]
    n_d = d_tokens.shape[0]
    n_models = weights.shape[0]
    dev = d_tokens.device
    k_pad = next_pow2(k)
    cand_k = min(k, block_d)
    state_s = torch.full((n_models, n_q, k), float("-inf"), device=dev)
    state_i = torch.full((n_models, n_q, k), -1, dtype=torch.int32, device=dev)
    eps = [LexicalEpilogue(weights[m], ab[m, 0], ab[m, 1]) for m in range(n_models)]
    for start in range(0, n_d, block_d):
        tf = term_frequencies(q_tokens, d_tokens[start : start + block_d], tile_d=tile_d)
        dlen = d_len[start : start + block_d]
        s = torch.stack([apply_epilogue(mode, ep, tf, dlen) for mode, ep in zip(modes, eps)])
        _, pos = torch.sort(sort_key(s), dim=-1, descending=True, stable=True)
        pos = pos[..., :cand_k]
        cand_s = torch.gather(s, -1, pos)
        cand_i = (pos + start).to(torch.int32)
        # zero-length rows score -inf: blank their ids to the empty-slot sentinel
        cand_i = torch.where(cand_s == float("-inf"), -1, cand_i)
        cand_s, cand_i = _pad_desc(cand_s, cand_i, k_pad)
        st_s, st_i = _pad_desc(state_s, state_i, k_pad)
        top_s, top_i = bitonic_merge_desc(st_s, st_i, cand_s, cand_i)
        state_s, state_i = top_s[..., :k], top_i[..., :k]
    return state_s.contiguous(), state_i.contiguous()


def _smem_bytes(n_models: int, k_pad: int, cap: int, tile_docs: int, l_d: int, l_q: int) -> int:
    words = (
        2 * n_models * k_pad + 2 * n_models * cap  # state + candidate lists
        + tile_docs * l_d + tile_docs * l_q + tile_docs  # tile, tf, lengths
        + l_q + n_models * l_q + 6 * n_models  # query, weights, scalars
    )
    return 4 * words


def launch_geometry(n_models, n_q, l_q, n_d, l_d, k, block_d, tile_d) -> dict:
    """The kernel's launch shape for these sizes, or ValueError when it
    cannot take them."""
    if k > MAX_K:
        raise ValueError(f"the lexical scan kernel keeps at most k={MAX_K}, got {k}")
    k_pad = next_pow2(k)
    tile_docs = -(-tile_d // 32) * 32
    cap = next_pow2(max(k_pad, 2 * tile_docs))
    n_splits = -(-n_d // block_d)
    if n_splits > 65535:
        raise ValueError(f"{n_splits} doc splits exceed the grid; raise block_d")
    group = n_models
    while group > 0 and _smem_bytes(group, k_pad, cap, tile_docs, l_d, l_q) > SMEM_LIMIT:
        group -= 1
    if group == 0:
        raise ValueError(
            f"one model at k={k}, L_d={l_d}, tile_d={tile_d} does not fit a CTA's "
            "shared memory"
        )
    return {
        "k_pad": k_pad, "tile_docs": tile_docs, "cap": cap, "n_splits": n_splits,
        "group": group, "smem": _smem_bytes(group, k_pad, cap, tile_docs, l_d, l_q),
        "merge_smem": 4 * 4 * k_pad,
    }


def _lib() -> ctypes.CDLL:
    lib = _build.load("lexical_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lexical_scan_partial_launch.argtypes = [p] * 8 + [i] * 12 + [p]
        lib.lexical_scan_partial_launch.restype = i
        lib.lexical_merge_partials_launch.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.lexical_merge_partials_launch.restype = i
        lib.lexical_scan_error_string.argtypes = [i]
        lib.lexical_scan_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lexical_scan_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def lexical_scan_topk_cuda(
    q_tokens, weights, ab, d_tokens, d_len, *, modes, k: int, block_d: int, tile_d: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (checked by the caller) ->
    ``(scores, ids) [n_models, n_q, k]``. Raises on any build or launch error."""
    _check_args(q_tokens, weights, ab, d_tokens, d_len, modes, k, block_d, tile_d)
    n_q, l_q = q_tokens.shape
    n_d, l_d = d_tokens.shape
    n_models = weights.shape[0]
    dev = d_tokens.device
    geo = launch_geometry(n_models, n_q, l_q, n_d, l_d, k, block_d, tile_d)
    lib = _lib()
    q_safe = safe_queries(q_tokens).contiguous()
    codes = torch.tensor(mode_codes(modes), dtype=torch.int32, device=dev)
    out_s = torch.empty((n_models, n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_models, n_q, k), dtype=torch.int32, device=dev)
    group = geo["group"]
    part_s = torch.empty((group, n_q, geo["n_splits"], k), dtype=torch.float32, device=dev)
    part_i = torch.empty((group, n_q, geo["n_splits"], k), dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for g0 in range(0, n_models, group):
        g = min(group, n_models - g0)
        rc = lib.lexical_scan_partial_launch(
            q_safe.data_ptr(), weights[g0 : g0 + g].data_ptr(), ab[g0 : g0 + g].data_ptr(),
            codes[g0 : g0 + g].data_ptr(), d_tokens.data_ptr(), d_len.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), n_q, l_q, g, n_d, l_d, k,
            geo["k_pad"], geo["cap"], block_d, geo["tile_docs"], geo["n_splits"],
            _smem_bytes(g, geo["k_pad"], geo["cap"], geo["tile_docs"], l_d, l_q), stream,
        )
        _raise_on(lib, rc, "lexical_scan_partial launch")
        rc = lib.lexical_merge_partials_launch(
            part_s.data_ptr(), part_i.data_ptr(), out_s[g0 : g0 + g].data_ptr(),
            out_i[g0 : g0 + g].data_ptr(), n_q, g, geo["n_splits"], k, geo["k_pad"],
            geo["merge_smem"], stream,
        )
        _raise_on(lib, rc, "lexical_merge_partials launch")
    return out_s, out_i
