"""The dense score + top-k: its plain PyTorch version and its CUDA launch.

Both compute what the JAX package's Pallas kernel `score_topk_pallas`
(`repro.kernels.score_topk`) computes: for every query row the float32
inner product with every document row, and each query's top ``k``
documents by (score desc, id asc), with ``(-inf, -1)`` in empty slots when
``k`` exceeds the corpus. Rows are float32 or bfloat16 (widened to float32,
in which the product of two bfloat16 values is exact).

* :func:`score_topk_ref` is the plain version, the reference's fold written
  in tensor ops: per ``block_d`` rows, ``q.float() @ d_blk.float().T``, the
  block's top k by a stable descending sort, and :func:`bitonic_merge_desc`
  into the running state. It runs wherever its tensors live.
* :func:`score_topk_cuda` launches the hand-written kernel
  (``csrc/score_topk.cu``) on CUDA tensors. It sums each score in another
  order than the matrix product, so the two agree to the reference's 1e-5
  (and to the bit on integer-valued inputs). ``block_d`` only sets the
  granularity of the kernel's doc splits: it changes no bit of the result.

The module also holds the k-bounded bitonic merge of two (score, id) lists
(:func:`bitonic_merge_desc`, :func:`_pad_desc`), which `topk.merge_lex`,
the plain lexical scan and the plain dense scan fold with. The public entry
point is `repro_torch.kernels.ops.score_topk`, which picks between the two
versions by the tensors' device and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pipeline import next_pow2
from repro_torch.core.topk import sort_key
from repro_torch.kernels import _build

THREADS = 256  # one CTA of the kernel
SMEM_LIMIT = 232448  # one CTA's shared memory on sm_90 (227 KB)
MAX_K = 8192  # one query's candidates and the merge's state (k_pad * 16 B) fit a CTA
QUERIES_PER_THREAD = 8  # the kernel's kQ
ROWS_PER_THREAD = 2  # the kernel's kRows
STAGE_BYTES = 128  # the kernel's kStageBytes: bytes of each row staged per step
MAX_GROUP = 64  # queries per CTA: at most 8 slots of 8
DTYPES = (torch.float32, torch.bfloat16)


def bitonic_merge_desc(
    a_s: torch.Tensor, a_i: torch.Tensor, b_s: torch.Tensor, b_i: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two ``[..., m]`` (score, id) lists sorted by (score desc, id
    asc); keep the top m under that same lexicographic order.

    ``a ++ reverse(b)`` is bitonic, so one bitonic merge network —
    ``log2(2m)`` compare-exchange stages — yields the 2m values sorted; the
    first m are the merged top-m. ``m`` must be a power of two (pad with
    ``-inf``/``-1`` first). Ties break toward the smaller id.
    """
    m = a_s.shape[-1]
    if m & (m - 1):
        raise ValueError(f"bitonic merge needs power-of-two width, got {m}")
    lead = a_s.shape[:-1]
    s = torch.cat([a_s, b_s.flip(-1)], dim=-1)
    i = torch.cat([a_i, b_i.flip(-1)], dim=-1)
    length = 2 * m
    stride = m
    while stride >= 1:
        sr = s.reshape(*lead, length // (2 * stride), 2, stride)
        ir = i.reshape(*lead, length // (2 * stride), 2, stride)
        lo_s, hi_s = sr[..., 0, :], sr[..., 1, :]
        lo_i, hi_i = ir[..., 0, :], ir[..., 1, :]
        # descending by score, ascending by id on ties: max to lower position
        keep = (lo_s > hi_s) | ((lo_s == hi_s) & (lo_i <= hi_i))
        max_s = torch.where(keep, lo_s, hi_s)
        min_s = torch.where(keep, hi_s, lo_s)
        max_i = torch.where(keep, lo_i, hi_i)
        min_i = torch.where(keep, hi_i, lo_i)
        s = torch.stack([max_s, min_s], dim=-2).reshape(*lead, length)
        i = torch.stack([max_i, min_i], dim=-2).reshape(*lead, length)
        stride //= 2
    return s[..., :m], i[..., :m]


def _pad_desc(s: torch.Tensor, i: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-pad descending-sorted lists with (-inf, -1) sentinels."""
    pad = width - s.shape[-1]
    if pad == 0:
        return s, i
    shape = (*s.shape[:-1], pad)
    return (
        torch.cat([s, s.new_full(shape, float("-inf"))], dim=-1),
        torch.cat([i, i.new_full(shape, -1)], dim=-1),
    )


def _check_args(q: torch.Tensor, d: torch.Tensor, k: int, block_d: int) -> None:
    if q.dim() != 2 or d.dim() != 2 or q.shape[1] != d.shape[1]:
        raise ValueError(
            f"score_topk: q [n_q, dim] and d [n_d, dim] expected, got "
            f"{tuple(q.shape)} and {tuple(d.shape)}"
        )
    if q.dtype != d.dtype or q.dtype not in DTYPES:
        raise TypeError(f"score_topk: q and d must share a dtype in {DTYPES}, "
                        f"got {q.dtype} and {d.dtype}")
    if k < 1 or block_d < 1:
        raise ValueError(f"k and block_d must be >= 1, got {k}, {block_d}")
    if d.shape[0] % block_d:
        raise ValueError(f"{d.shape[0]} docs not divisible by block_d {block_d}")


def score_topk_ref(
    q: torch.Tensor,  # [n_q, dim] float32 | bfloat16
    d: torch.Tensor,  # [n_d, dim], q's dtype
    *,
    k: int,
    block_d: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version -> ``(scores, ids) [n_q, k]``, ids local to ``d``
    (0-based), ``(-inf, -1)`` in empty slots."""
    _check_args(q, d, k, block_d)
    n_q = q.shape[0]
    dev = d.device
    k_pad = next_pow2(k)
    cand_k = min(k, block_d)
    qf = q.to(torch.float32)
    state_s = torch.full((n_q, k), float("-inf"), device=dev)
    state_i = torch.full((n_q, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, d.shape[0], block_d):
        s = qf @ d[start : start + block_d].to(torch.float32).T
        _, pos = torch.sort(sort_key(s), dim=-1, descending=True, stable=True)
        pos = pos[:, :cand_k]
        cand_s, cand_i = _pad_desc(torch.gather(s, -1, pos), (pos + start).to(torch.int32), k_pad)
        st_s, st_i = _pad_desc(state_s, state_i, k_pad)
        top_s, top_i = bitonic_merge_desc(st_s, st_i, cand_s, cand_i)
        state_s, state_i = top_s[:, :k], top_i[:, :k]
    return state_s.contiguous(), state_i.contiguous()


def _tiling(group: int) -> tuple[int, int]:
    """``(slots, tile_docs)`` for a group: each thread scores its rows
    against ``QUERIES_PER_THREAD`` queries, so the group's queries go in
    ``slots`` (a power of two) and a slot's ``256 / slots`` threads take
    ``ROWS_PER_THREAD`` rows each."""
    slots = next_pow2(-(-group // QUERIES_PER_THREAD))
    return slots, THREADS // slots * ROWS_PER_THREAD


def _smem_bytes(group: int, k_pad: int, cap: int, dim: int) -> int:
    slots, tile_docs = _tiling(group)
    return (2 * tile_docs * (STAGE_BYTES + 16) + 4 * slots * QUERIES_PER_THREAD * dim
            + 8 * group * cap + 8 * k_pad + 12 * group)


def launch_geometry(n_q: int, dim: int, n_d: int, k: int, block_d: int, elem_size: int,
                    n_sms: int = 132) -> dict:
    """The kernel's launch shape for these sizes, or ValueError when it
    cannot take them.

    Queries go in groups of as many as fit a CTA's shared memory (at most
    ``MAX_GROUP``; above one slot, whole slots of ``QUERIES_PER_THREAD``),
    spread evenly. Doc splits are whole multiples of
    ``block_d``, as few as keep every SM busy in one wave of CTAs: each
    split pays a warm-up (its first k rows all enter the candidate buffers)
    and a list in the final merge, so longer splits cost less (measured on
    the H100, `PERF.md` §6).
    """
    if n_q < 1 or n_d < 1:
        raise ValueError(f"score_topk kernel needs queries and docs, got {n_q}, {n_d}")
    if k > MAX_K:
        raise ValueError(f"the score_topk kernel keeps at most k={MAX_K}, got {k}")
    if (dim * elem_size) % STAGE_BYTES:
        raise ValueError(
            f"the score_topk kernel stages rows {STAGE_BYTES} bytes at a time: dim {dim} x "
            f"{elem_size} B is not a multiple of {STAGE_BYTES}"
        )
    if n_d % block_d:
        raise ValueError(f"{n_d} docs not divisible by block_d {block_d}")
    if 2 * n_d >= 2**31:
        raise ValueError(f"{n_d} docs exceed the kernel's int32 doc ids")
    k_pad = next_pow2(k)

    def cap_of(group):
        return next_pow2(max(k_pad, 2 * _tiling(group)[1]))

    group = min(n_q, MAX_GROUP)
    while group > 0 and _smem_bytes(group, k_pad, cap_of(group), dim) > SMEM_LIMIT:
        group -= 1
    if group == 0:
        raise ValueError(f"one query at k={k}, dim={dim} does not fit a CTA's shared memory")
    if group > QUERIES_PER_THREAD:  # whole slots: a part-filled slot wastes its FMAs
        group -= group % QUERIES_PER_THREAD
    n_groups = -(-n_q // group)
    group = -(-n_q // n_groups)  # the same number of groups, evened out
    slots, tile_docs = _tiling(group)
    n_blocks = n_d // block_d
    per_split = -(-n_blocks // max(1, n_sms // n_groups))
    n_splits = -(-n_blocks // per_split)  # n_groups * n_splits <= max(n_sms, n_groups)
    return {
        "k_pad": k_pad, "cap": cap_of(group), "group": group, "slots": slots,
        "tile_docs": tile_docs, "n_groups": n_groups, "split_rows": per_split * block_d,
        "n_splits": n_splits, "smem": _smem_bytes(group, k_pad, cap_of(group), dim),
        "merge_smem": 4 * 4 * k_pad,
    }


def _lib() -> ctypes.CDLL:
    lib = _build.load("score_topk")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.score_topk_partial_launch.argtypes = [p] * 4 + [i] * 12 + [p]
        lib.score_topk_partial_launch.restype = i
        lib.score_topk_merge_launch.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.score_topk_merge_launch.restype = i
        lib.score_topk_error_string.argtypes = [i]
        lib.score_topk_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.score_topk_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def score_topk_cuda(q: torch.Tensor, d: torch.Tensor, *, k: int,
                    block_d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on contiguous CUDA tensors (checked by the
    caller) -> ``(scores, ids) [n_q, k]``. Raises on any build or launch
    error, and on sizes the kernel cannot take."""
    _check_args(q, d, k, block_d)
    n_q, dim = q.shape
    n_d = d.shape[0]
    dev = d.device
    for name, t in (("q", q), ("d", d)):
        if t.data_ptr() % 16:
            raise ValueError(f"score_topk kernel: {name} must start 16-byte aligned")
    geo = launch_geometry(n_q, dim, n_d, k, block_d, d.element_size(),
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _lib()
    # each query's running state per split: its top k_pad, in the first k of
    # which the split's result is left
    part_s = torch.empty((n_q, geo["n_splits"], geo["k_pad"]), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_q, geo["n_splits"], geo["k_pad"]), dtype=torch.int32, device=dev)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = lib.score_topk_partial_launch(
        q.data_ptr(), d.data_ptr(), part_s.data_ptr(), part_i.data_ptr(), n_q, dim, n_d, k,
        geo["k_pad"], geo["cap"], geo["group"], geo["slots"], geo["split_rows"],
        geo["n_splits"], int(d.dtype == torch.bfloat16), geo["smem"], stream,
    )
    _raise_on(lib, rc, "score_topk_partial launch")
    rc = lib.score_topk_merge_launch(
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), n_q,
        geo["n_splits"], k, geo["k_pad"], geo["merge_smem"], stream,
    )
    _raise_on(lib, rc, "score_topk_merge launch")
    return out_s, out_i
