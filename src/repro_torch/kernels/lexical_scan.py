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
  a CTA stages each tile of ``tile_d`` rows (rounded up to a whole warp)
  once for every (model, query) of the call, looks each token up once in a
  table of the query terms, scores each matched term once a row for all
  the slots of a model that hold it with the same weight, and keeps its own
  running lists under a threshold the CTAs prove together; a second kernel
  merges them.
  ``block_d`` is how many rows a CTA scans between flushes of all its
  candidate buffers. Neither changes a bit of the result.

Both take a packed token matrix (``pack_spec``, a `packing.PackSpec`:
``uint8``/``uint16`` rows or int32 bit-planes, as the reference's
``lexical_scan_topk_pallas`` does): the plain version unpacks each block of
``block_d`` rows; the kernel stages the packed bytes and decodes each token
where the count reads it. Results are the unpacked call's, bit for bit.

The public entry point is `repro_torch.kernels.ops.lexical_scan_topk`, which
picks between the two by the tensors' device and counts launches.

Every launch of the kernel adds its counts (`COUNTERS`: flush passes by
cause, list flushes, candidates flushed, one thread's cycles in flushes and
in the whole tile loop, the term scores computed and the reads of them, and
that thread's cycles in the epilogue, summed over the CTAs) into one array
a device, or into the array a call passes (a served block's own);
:func:`read_counters` returns the device's and zeroes them.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.packing import PackSpec, unpack_tokens
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
from repro_torch.kernels.score_topk import (
    _c_args,
    _pad_desc,
    bitonic_merge_desc,
    list_states,
    merge_smem_bytes,
)

_MODE_KIND = {"ql": 0, "bm25": 1, "tfidf": 2}
# one CTA's shared memory on sm_90 (227 KB)
SMEM_LIMIT = 232448
MAX_K = 8192  # the states live in device memory; k only sets their length
# the kernel's token layouts: int32 rows, then each packed mode
_PACK_CODE = {None: 0, "u8": 1, "u16": 2, "bitpack": 3}


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


def _check_args(q_tokens, weights, ab, d_tokens, d_len, modes, k, block_d, tile_d,
                pack_spec: PackSpec | None = None):
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
    want = torch.int32 if pack_spec is None else pack_spec.torch_dtype()
    if d_tokens.dtype != want:
        raise TypeError(f"d_tokens has dtype {d_tokens.dtype}, expected {want}"
                        + ("" if pack_spec is None else f" (pack mode {pack_spec.mode})"))
    if pack_spec is not None and d_tokens.shape[1] != pack_spec.packed_width:
        raise ValueError(
            f"packed width {d_tokens.shape[1]} != spec {pack_spec.packed_width}"
        )


def lexical_scan_topk_ref(
    q_tokens: torch.Tensor,  # [n_q, L_q] int32, PAD_TOKEN-padded
    weights: torch.Tensor,  # [n_models, n_q, L_q] f32
    ab: torch.Tensor,  # [n_models, 2] f32
    d_tokens: torch.Tensor,  # [n_d, L_d] int32, PAD_TOKEN-padded — or packed [n_d, W]
    d_len: torch.Tensor,  # [n_d] int32
    *,
    modes: tuple[EpilogueMode, ...],
    k: int,
    block_d: int = 512,
    tile_d: int = 16,
    pack_spec: PackSpec | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version -> ``(scores, ids) [n_models, n_q, k]``, ids local to
    ``d_tokens`` (0-based), ``(-inf, -1)`` in empty slots. With
    ``pack_spec`` each block of ``block_d`` packed rows is unpacked to a
    ``tile_d``-aligned width first, as the reference's kernel does, so
    memory stays O(block)."""
    _check_args(q_tokens, weights, ab, d_tokens, d_len, modes, k, block_d, tile_d, pack_spec)
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
        block = d_tokens[start : start + block_d]
        if pack_spec is not None:
            length = pack_spec.length
            block = unpack_tokens(block, pack_spec, pad_to=length + (-length) % tile_d)
        tf = term_frequencies(q_tokens, block, tile_d=tile_d)
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


def cost(q_tokens, weights, ab, d_tokens, d_len, *, k: int,
         pack_spec: PackSpec | None = None) -> dict:
    """The least work of one call (PERF.md's Bound column): every input read
    once and both outputs written once; one lookup a token and one epilogue
    and compare a (model, query, doc), integer operations (``other``)."""
    n_models, n_q = weights.shape[0], q_tokens.shape[0]
    n_d = d_tokens.shape[0]
    l_d = d_tokens.shape[1] if pack_spec is None else pack_spec.length
    n_bytes = sum(t.numel() * t.element_size() for t in (q_tokens, weights, ab, d_tokens, d_len))
    return {"flops": {"other": n_d * l_d + n_models * n_q * n_d},
            "bytes": n_bytes + 2 * n_models * n_q * k * 4}


def outputs_meta(q_tokens, weights, *, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The call's ``(scores, ids)`` on the ``meta`` device: shapes, no data."""
    shape = (weights.shape[0], q_tokens.shape[0], k)
    return (torch.empty(shape, dtype=torch.float32, device="meta"),
            torch.empty(shape, dtype=torch.int32, device="meta"))


WARPS = 16  # the kernel's CTA: 512 threads
MAP_BYTES = 65536 // 8  # the query terms' bitmap
TALLY_BYTES = 8 * (4 * WARPS + 6)  # a CTA's counts (the kernel's kTally)


def _buf_bytes(tile_docs: int, row_bytes: int) -> int:
    """One staging buffer: a tile's bytes + 15 of alignment slack, in whole
    16-byte units."""
    return (tile_docs * row_bytes + 30) & ~15


def row_bytes(l_d: int, pack_spec: PackSpec | None = None) -> int:
    """Bytes of one stored token row of width ``l_d`` (the packed width
    when packed)."""
    return l_d * (4 if pack_spec is None else pack_spec.packed_dtype().itemsize)


def _smem_bytes(n_models: int, n_q: int, l_q: int, tile_docs: int, row_b: int, cap: int,
                l_tok: int) -> int:
    slots, lists = n_q * l_q, n_models * n_q
    qwords = -(-n_q // 32)
    matched = min(slots, l_tok)  # the most distinct terms a row can match
    words = (
        2 * _hash_size(slots) + slots + WARPS * slots  # term table, slot terms, counts
        + 2 * WARPS * matched + WARPS  # each warp's matched terms, their scores, their number
        + 2 * slots  # each term's first slot and its number of slots
        + n_models * qwords  # the lists with a weight other than its term's first slot's
        + n_models * slots + 3 * n_models  # weights, alpha/beta/mode
        + 4 * lists + 2  # thresholds (score, id), buffer counts, list lengths, 2 flags
    )
    # + the staging ring, each list's r-th and k-th keys (8-byte aligned),
    # the counters' tally, each warp's flush scratch
    return (2 * _buf_bytes(tile_docs, row_b) + MAP_BYTES + 4 * words + 8 + 16 * lists
            + TALLY_BYTES + WARPS * next_pow2(cap) * 12)


def _hash_size(slots: int) -> int:
    return max(32, next_pow2(2 * slots))


def launch_geometry(n_models, n_q, l_q, n_d, l_d, k, block_d, tile_d, n_sms: int = 132,
                    pack_spec: PackSpec | None = None) -> dict:
    """The kernel's launch shape for these sizes, or ValueError when it
    cannot take them. ``l_d`` is the stored row's width: the packed width
    when ``pack_spec`` is given, whose dtype sizes the staging ring.

    One CTA per SM (``n_splits`` of them), taking the tiles in turn; a tile
    is ``tile_d`` rows rounded up to a whole warp. Queries go in as few groups
    as fit a CTA's shared memory (one, for 128 queries of 4 terms); a CTA
    holds every (model, query) list of its group. ``block_d`` is how many
    rows a CTA scans between flushes of all its buffers.
    """
    if k > MAX_K:
        raise ValueError(f"the lexical scan kernel keeps at most k={MAX_K}, got {k}")
    tile_docs = -(-tile_d // 32) * 32
    if n_d + tile_docs * n_sms >= 2**31:  # ids and tile starts stay int32
        raise ValueError(f"{n_d} docs exceed the kernel's int32 doc ids")
    cap = 4 * tile_docs  # a buffer is flushed when one more tile could overflow it
    l_tok = l_d if pack_spec is None else pack_spec.length
    row_b = row_bytes(l_d, pack_spec)
    n_splits = min(n_sms, -(-n_d // tile_docs))
    n_groups = 1
    group = n_q
    while _smem_bytes(n_models, group, l_q, tile_docs, row_b, cap, l_tok) > SMEM_LIMIT:
        if group == 1:
            raise ValueError(
                f"one query at L_q={l_q}, L_d={l_d}, tile_d={tile_d} with {n_models} models "
                "does not fit a CTA's shared memory"
            )
        n_groups += 1
        group = -(-n_q // n_groups)
    return {
        "k_pad": next_pow2(k), "tile_docs": tile_docs, "cap": cap, "n_splits": n_splits, "group": group, "n_groups": n_groups, "flush_rows": block_d,
        "log2h": _hash_size(group * l_q).bit_length() - 1,
        "smem": _smem_bytes(n_models, group, l_q, tile_docs, row_b, cap, l_tok),
        "row_bytes": row_b,
        "merge_smem": merge_smem_bytes(next_pow2(k), n_splits),
    }


# the C entry point's parameters, in order: p a pointer, i an int
LAUNCH_ARGS = "p" * 6 + "p" * 7 + "pp" + "i" * 18 + "pp"

# the kernel's counters, in the order of its `counters` array (kCounters):
# flush passes because an offer raised `need`, on the schedule (tile 1 and
# every 4th tile), because `block_d` rows were reached (a pass with several
# causes counts under the rows, else under `need`), and the final pass (one
# a CTA); list flushes; candidates flushed; and each CTA's thread 0's clock64
# cycles inside flush passes and over the whole tile loop; the term scores
# computed with tf > 0 (one a row, model and matched term, and one a matched
# slot of a list that scores its slots itself), their (row, list, slot)
# uses, and thread 0's cycles from the end of a row's count to the end of
# its offers
COUNTERS = ("passes_need", "passes_scheduled", "passes_rows", "passes_final",
            "list_flushes", "candidates", "flush_cycles", "loop_cycles",
            "term_scores", "term_uses", "epilogue_cycles")
_counters: dict[torch.device, torch.Tensor] = {}
_counters_lock = threading.Lock()


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _counter_array(dev: torch.device) -> torch.Tensor:
    """The device's counters (uint64 on the card, held as int64), made zero
    on first use; the launch adds to them on any stream."""
    key = _device_key(dev)
    arr = _counters.get(key)
    if arr is None:
        with _counters_lock:
            arr = _counters.get(key)
            if arr is None:
                arr = torch.zeros(len(COUNTERS), dtype=torch.int64, device=key)
                torch.cuda.synchronize(key)  # zero before a launch on another stream
                _counters[key] = arr
    return arr


def read_counters(device) -> dict[str, int]:
    """The kernel's counts on ``device`` since the last read, by
    `COUNTERS` name, and zeroes them; all 0 where it never ran. The read
    copies on the current stream: the launches queued there are in it,
    those of other streams only once they have finished."""
    arr = _counters.get(_device_key(device))
    if arr is None:
        return dict.fromkeys(COUNTERS, 0)
    values = arr.tolist()
    arr.zero_()
    return dict(zip(COUNTERS, values))


def _lib() -> ctypes.CDLL:
    lib = _build.load("lexical_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lexical_scan_launch.argtypes = _c_args(LAUNCH_ARGS)
        lib.lexical_scan_launch.restype = i
        lib.lexical_scan_error_string.argtypes = [i]
        lib.lexical_scan_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lexical_scan_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def lexical_scan_topk_cuda(
    q_tokens, weights, ab, d_tokens, d_len, *, modes, k: int, block_d: int, tile_d: int,
    pack_spec: PackSpec | None = None, counters: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (checked by the caller) ->
    ``(scores, ids) [n_models, n_q, k]``. With ``pack_spec`` the kernel
    stages the packed rows' bytes and decodes each token as it counts it.
    The kernel adds its counts into ``counters`` (int64, one a `COUNTERS`
    name, on the tensors' device), else into the device's own array.
    Raises on any build or launch error."""
    _check_args(q_tokens, weights, ab, d_tokens, d_len, modes, k, block_d, tile_d, pack_spec)
    n_q, l_q = q_tokens.shape
    n_d, l_d = d_tokens.shape
    n_models = weights.shape[0]
    dev = d_tokens.device
    geo = launch_geometry(n_models, n_q, l_q, n_d, l_d, k, block_d, tile_d,
                          torch.cuda.get_device_properties(dev).multi_processor_count,
                          pack_spec=pack_spec)
    # the unpacked row length, the layout, its bit-planes and PAD sentinel
    l_tok = l_d if pack_spec is None else pack_spec.length
    pack = _PACK_CODE[None if pack_spec is None else pack_spec.mode]
    bits = 0 if pack_spec is None else pack_spec.bits
    sentinel = 0 if pack_spec is None else pack_spec.vocab
    lib = _lib()
    q_safe = safe_queries(q_tokens).contiguous()
    # from pinned memory without waiting: a blocking copy would make the
    # host wait here for the device's queue, every call
    codes = torch.tensor(mode_codes(modes), dtype=torch.int32).pin_memory().to(
        dev, non_blocking=True)
    out_s = torch.empty((n_models, n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_models, n_q, k), dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if counters is None:
        counters = _counter_array(dev)
    elif (counters.dtype != torch.int64 or tuple(counters.shape) != (len(COUNTERS),)
          or counters.device != dev or not counters.is_contiguous()):
        raise ValueError(f"counters: a contiguous int64 [{len(COUNTERS)}] on {dev} expected, "
                         f"got {counters.dtype} {tuple(counters.shape)} on {counters.device}")
    for q0 in range(0, n_q, geo["group"]):
        g = min(geo["group"], n_q - q0)
        q_g = q_safe[q0 : q0 + g].contiguous()
        w_g = weights[:, q0 : q0 + g].contiguous()
        state = list_states(n_models * g, geo["k_pad"], geo["n_splits"], n_models * g,
                            geo["n_splits"], geo["cap"], dev)
        # one group writes its queries' rows of every model in place, else a copy
        whole = g == n_q
        o_s = out_s if whole else torch.empty((n_models, g, k), dtype=torch.float32, device=dev)
        o_i = out_i if whole else torch.empty((n_models, g, k), dtype=torch.int32, device=dev)
        rc = lib.lexical_scan_launch(
            q_g.data_ptr(), w_g.data_ptr(), ab.data_ptr(), codes.data_ptr(),
            d_tokens.data_ptr(), d_len.data_ptr(), *(t.data_ptr() for t in state),
            o_s.data_ptr(), o_i.data_ptr(), g, l_q, n_models, n_d, l_tok, geo["row_bytes"],
            pack, bits, sentinel, k, geo["k_pad"], geo["cap"], geo["n_splits"],
            geo["tile_docs"], geo["flush_rows"], geo["log2h"],
            _smem_bytes(n_models, g, l_q, geo["tile_docs"], geo["row_bytes"], geo["cap"], l_tok),
            geo["merge_smem"], counters.data_ptr(), stream,
        )
        _raise_on(lib, rc, "lexical_scan launch")
        if not whole:
            out_s[:, q0 : q0 + g] = o_s
            out_i[:, q0 : q0 + g] = o_i
    return out_s, out_i
