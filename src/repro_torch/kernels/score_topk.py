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
  (``csrc/score_topk.cu``) on CUDA tensors: scores on the tensor cores (three
  TF32 products of a hi/lo split for float32 rows, :func:`tf32_split`; one
  bfloat16 product for bfloat16 rows), one pass over the corpus for up to
  128 queries, each CTA's running lists filtered by a threshold the CTAs
  prove together (:func:`pack_key`) and merged by a second kernel
  (:func:`list_states`). It sums each score in another order than the
  matrix product, so the two agree to the reference's 1e-5, and to the bit
  wherever every product and partial sum is exact (integer-valued inputs).
  ``block_d`` only sets the granularity of the kernel's doc splits, and a
  query's result is the same in any block of queries: neither changes a
  bit of it.

The module also holds the k-bounded bitonic merge of two (score, id) lists
(:func:`bitonic_merge_desc`, :func:`_pad_desc`), which `topk.merge_lex`,
the plain lexical scan and the plain dense scan fold with. The public entry
point is `repro_torch.kernels.ops.score_topk`, which picks between the two
versions by the tensors' device and counts launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.pipeline import next_pow2
from repro_torch.core.topk import sort_key
from repro_torch.kernels import _build

THREADS = 256  # one CTA of the kernel
WARPS = THREADS // 32
SMEM_LIMIT = 232448  # one CTA's shared memory on sm_90 (227 KB)
MAX_K = 8192  # the states live in device memory; k only sets their length
STAGE_BYTES = 128  # the kernel's kStageBytes: bytes of each row staged per step
MAX_STAGES = 8  # the deepest ring the kernel waits on
MAX_GROUP = 128  # queries one CTA holds: one pass over the corpus per 128
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


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of float32 values for its TF32 products: ``hi`` is
    ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
    PTX ``cvt.rna.tf32.f32``), ``lo`` is ``x - hi`` (exact in float32)
    rounded the same way. ``hi + lo`` is ``x`` to about 2^-21 relative; a
    value that fits TF32 (an integer up to 2^11, any bfloat16 value) has
    ``lo == 0``. Finite inputs only."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def split_tf32_dot(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``q @ d.T`` as the kernel's three TF32 products per element: the
    cross products ``lo_d hi_q + hi_d lo_q`` summed apart from ``hi_d hi_q``
    (the kernel's two accumulators), then added; each product is exact in
    float32 and each sum float32 (in PyTorch's order, not the tensor
    cores')."""
    qh, ql = tf32_split(q)
    dh, dl = tf32_split(d)
    return (ql @ dh.T + qh @ dl.T) + qh @ dh.T


def pack_key(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The kernels' 64-bit threshold key of (score, id), as int64 whose
    order is the ranking order: score desc after ``+ 0.0`` (so -0.0 equals
    +0.0), then id asc, signed (so an empty list's threshold (-inf, -1) is
    ahead of every real (-inf, id)). The device key is this value + 2^63 as
    an unsigned integer (`topk_merge.cuh` ``pack_key``)."""
    u = (scores.to(torch.float32) + 0.0).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    lo = (0x7FFFFFFF - ids.to(torch.int64)) & 0xFFFFFFFF
    return (u - 0x80000000) * (1 << 32) + lo


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


def cost(q: torch.Tensor, d: torch.Tensor, *, k: int) -> dict:
    """The least work of one call (PERF.md's Bound column): the queries and
    the corpus read once, ``(scores, ids)`` written once; the products at
    float32-level accuracy, three TF32 products a multiply-add for float32
    (``tf32``: the kernel's hi/lo split), one for bfloat16 (``bf16``)."""
    n_q, dim = q.shape
    ops_count = 2 * n_q * d.shape[0] * dim
    flops = ({"tf32": 3 * ops_count} if q.dtype == torch.float32 else {"bf16": ops_count})
    return {"flops": flops,
            "bytes": (q.numel() + d.numel()) * q.element_size() + n_q * k * 8}


def outputs_meta(q: torch.Tensor, *, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The call's ``(scores, ids)`` on the ``meta`` device: shapes, no data."""
    return (torch.empty((q.shape[0], k), dtype=torch.float32, device="meta"),
            torch.empty((q.shape[0], k), dtype=torch.int32, device="meta"))


def _smem_bytes(n_qp: int, row_bytes: int, tile_docs: int, stages: int, cap: int) -> int:
    """The ring, the queries (rows padded by 16 bytes), each query's local
    threshold, buffer count, list length and r-th and k-th keys, and each
    warp's flush scratch (a key and a score per buffered candidate)."""
    return (stages * tile_docs * (STAGE_BYTES + 16) + n_qp * (row_bytes + 16) + 32 * n_qp + 8
            + WARPS * next_pow2(cap) * 12)


def launch_geometry(n_q: int, dim: int, n_d: int, k: int, block_d: int, elem_size: int,
                    n_sms: int = 132) -> dict:
    """The kernel's launch shape for these sizes, or ValueError when it
    cannot take them.

    Queries go in as few groups as possible, at most ``MAX_GROUP`` each
    (one group, so one pass over the corpus, for every block of up to 128),
    evened out; a group is padded to ``n_qp``, a power of two >= 8, which
    sets the warps' layout: ``NW = min(32, n_qp)`` queries by 32 rows a
    warp, so ``tile_docs = 32 * 8 * NW / n_qp`` rows a tile. Doc splits are
    whole multiples of ``block_d``, as few as keep every SM busy in one wave
    of CTAs (one CTA per SM: longer splits mean fewer buffers to flush).
    The ring takes as many stages (2 to ``MAX_STAGES``) as fit the shared
    memory: the more 128-byte chunks in flight, the nearer the corpus streams
    to the card's memory rate.
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
    if n_d >= 2**31 - 4096:  # ids and a tile past the last row stay int32
        raise ValueError(f"{n_d} docs exceed the kernel's int32 doc ids")
    n_groups = -(-n_q // MAX_GROUP)
    group = -(-n_q // n_groups)
    n_qp = max(8, next_pow2(group))
    tile_docs = 32 * WARPS * min(32, n_qp) // n_qp
    cap = 2 * tile_docs  # a buffer is flushed when one more tile could overflow it
    stages = next((s for s in range(MAX_STAGES, 1, -1)
                   if _smem_bytes(n_qp, dim * elem_size, tile_docs, s, cap) <= SMEM_LIMIT), 0)
    if not stages:
        raise ValueError(f"{n_qp} query rows of dim {dim} do not fit a CTA's shared memory")
    n_blocks = n_d // block_d
    per_split = -(-n_blocks // max(1, n_sms // n_groups))
    n_splits = -(-n_blocks // per_split)  # n_groups * n_splits <= max(n_sms, n_groups)
    return {
        "k_pad": next_pow2(k), "cap": cap, "group": group, "n_qp": n_qp,
        "tile_docs": tile_docs, "stages": stages, "n_groups": n_groups,
        "split_rows": per_split * block_d, "n_splits": n_splits,
        "smem": _smem_bytes(n_qp, dim * elem_size, tile_docs, stages, cap),
        "merge_smem": merge_smem_bytes(next_pow2(k), n_splits),
    }


# the C entry point's parameters, in order: p a pointer, i an int
LAUNCH_ARGS = "pp" + "p" * 7 + "pp" + "i" * 15 + "p"
_launch = _build.Entry("score_topk", LAUNCH_ARGS)


# the empty slot (-inf, -1) as a pack_key value: every list's first threshold
EMPTY_KEY = int(pack_key(torch.tensor([float("-inf")]), torch.tensor([-1]))[0])


GATHER_CAP = 4096  # topk_merge.cuh kGatherCap: entries the final merge sorts at once


def merge_smem_bytes(k_pad: int, n_split: int) -> int:
    """Shared memory of the final merge (`topk_merge.cuh` ``merge_lists``):
    a count per CTA, then the gather of up to ``GATHER_CAP`` (key, score)
    pairs or the pairwise merge's two lists of ``k_pad``."""
    return (8 * n_split + 4 + 15) // 16 * 16 + max(GATHER_CAP * 12, 16 * k_pad)


def list_states(n_lists: int, k_pad: int, n_ctas: int, per_cta: int, n_split: int, cap: int,
                device) -> tuple[torch.Tensor, ...]:
    """One call's top-k state (`topk_merge.cuh` ``Lists``), made afresh for
    every call so that no state outlives it or is seen by a call on another
    stream: each CTA's running lists and their lengths (written by the
    kernel before it reads them), each CTA's published r-th key per list
    (0, below every key, until it publishes), each list's proven bound (the
    empty key, as the device's unsigned key ``pack_key + 2^63``), and each
    CTA's candidate buffers."""
    return (
        torch.empty((n_ctas, per_cta, k_pad), dtype=torch.float32, device=device),
        torch.empty((n_ctas, per_cta, k_pad), dtype=torch.int32, device=device),
        torch.empty((n_ctas, per_cta), dtype=torch.int32, device=device),
        torch.zeros((n_lists, n_split), dtype=torch.int64, device=device),
        torch.full((n_lists,), EMPTY_KEY ^ -(1 << 63), dtype=torch.int64, device=device),
        torch.empty((n_ctas, per_cta, cap), dtype=torch.float32, device=device),
        torch.empty((n_ctas, per_cta, cap), dtype=torch.int32, device=device),
    )


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """``x [n, dim]`` with its rows zero-padded to the kernel's row, a whole
    number of ``STAGE_BYTES``; ``x`` itself, no copy, when they are whole
    already. Zeros change no dot product and no norm."""
    pad = -x.shape[1] % (STAGE_BYTES // x.element_size())
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def score_topk_cuda(q: torch.Tensor, d: torch.Tensor, *, k: int,
                    block_d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on contiguous CUDA tensors (checked by the
    caller) -> ``(scores, ids) [n_q, k]``. Raises on any build or launch
    error, and on sizes the kernel cannot take.

    The kernel stages rows ``STAGE_BYTES`` at a time: rows of another width
    are zero-padded here (:func:`pad_rows`, a copy of ``q`` and ``d`` each
    call), which leaves every dot product as it is."""
    _check_args(q, d, k, block_d)
    q, d = pad_rows(q), pad_rows(d)
    n_q, dim = q.shape
    n_d = d.shape[0]
    dev = d.device
    _build.check_aligned("score_topk kernel", q=q, d=d)
    geo = launch_geometry(n_q, dim, n_d, k, block_d, d.element_size(), _build.sm_count(dev))
    state = list_states(n_q, geo["k_pad"], geo["n_groups"] * geo["n_splits"], geo["group"],
                        geo["n_splits"], geo["cap"], dev)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    _launch(
        dev, q.data_ptr(), d.data_ptr(), *(t.data_ptr() for t in state), out_s.data_ptr(),
        out_i.data_ptr(), n_q, dim, n_d, k, geo["k_pad"], geo["cap"], geo["group"],
        geo["n_qp"], geo["split_rows"], geo["n_splits"], geo["n_groups"], geo["stages"],
        int(d.dtype == torch.bfloat16), geo["smem"], geo["merge_smem"],
    )
    return out_s, out_i
