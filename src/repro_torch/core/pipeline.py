"""MapReduce-shaped dataflow on torch: chunked folds over a local shard.

The three-stage shape of the paper's Figure 1 — map over an input split,
fold into an associative *combiner* state, merge states across machines —
is the skeleton of the scan, the statistics job and the sharded job:

    state = fold_chunks(local_shard, chunk, fold_fn, init)   # map + combine

``fold_chunks`` is a Python loop over chunks (PyTorch runs eagerly, so there
is no compiled scan to build). Chunk folds are idempotent re-reduces: the
combiner state is associative, so a re-executed chunk merges to the same
result. :func:`prefetch_segments` streams a corpus to the fold one segment
at a time, staging the next segments on a background thread (and, from the
host to a card, on a copy stream of its own) while the current one folds.

A "pytree" here is a tensor, a tuple of tensors whose leading dims agree
(``(tokens, lengths)`` for a lexical corpus), or a
`packing.PackedCorpus`, whose leaves are its packed tokens and its lengths,
in that order, as the reference's pytree registration has them.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Callable, Iterator, NamedTuple, Sequence, TypeVar

import torch

from repro_torch import obs
from repro_torch.core.packing import PackedCorpus
from repro_torch.device import canonical_device
from repro_torch.tune import config as tune_config

S = TypeVar("S")


def leaves(tree: Any) -> list:
    """The tensors of a tree, in order (a packed corpus: tokens, lengths)."""
    if isinstance(tree, PackedCorpus):
        return [tree.tokens, tree.lengths]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a tree; a packed corpus keeps its spec."""
    if isinstance(tree, PackedCorpus):
        return PackedCorpus(fn(tree.tokens), fn(tree.lengths), tree.spec)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def num_chunks(n: int, chunk_size: int) -> int:
    return -(-n // chunk_size)


def segments(n: int, chunk_size: int, chunks_per_segment: int) -> list[tuple[int, int]]:
    """Chunk-aligned ``[start, stop)`` row ranges for checkpointed folds.

    Every boundary is a chunk boundary, so the segmented fold replays the
    exact per-chunk fold sequence of the unsegmented one.
    """
    if n % chunk_size:
        raise ValueError(f"leading dim {n} not divisible by chunk_size {chunk_size}")
    if chunks_per_segment < 1:
        raise ValueError(f"chunks_per_segment must be >= 1, got {chunks_per_segment}")
    step = chunk_size * chunks_per_segment
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_leading(tree: Any, n_target: int, pad_values: Any = None) -> Any:
    """Pad every leaf's leading dim to ``n_target`` (with leaf-specific fill)."""

    def _pad(x, fill):
        pad = n_target - x.shape[0]
        if pad == 0:
            return x
        filler = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, filler])

    if pad_values is None:
        return tree_map(lambda x: _pad(x, 0), tree)
    xs, fills = leaves(tree), leaves(pad_values)
    padded = iter([_pad(x, f) for x, f in zip(xs, fills)])
    return tree_map(lambda _: next(padded), tree)


def _tree_nbytes(tree: Any) -> int:
    """Tensor bytes across a tree's leaves (the staged-traffic counter's
    unit: packed segments stage fewer bytes for the same rows)."""
    return sum(x.numel() * x.element_size() for x in leaves(tree))


class Staged(NamedTuple):
    """A segment staged for the fold, and the CUDA event after which it
    holds its rows (``None`` when no copy is in flight)."""

    seg: Any
    ready: "torch.cuda.Event | None"

    def take(self) -> Any:
        """The segment, for use on the calling thread's current stream: that
        stream waits for the copy on the device (the host does not), and
        each staged tensor is marked as used there, so that the caching
        allocator does not hand its block to the copy stream again before
        the fold is done with it."""
        if self.ready is None:
            return self.seg
        xs = leaves(self.seg)
        stream = torch.cuda.current_stream(xs[0].device)
        stream.wait_event(self.ready)
        for x in xs:
            x.record_stream(stream)
        return self.seg


def stage(data: Any, a: int, b: int, device: torch.device | None,
          stream: "torch.cuda.Stream | None" = None) -> Staged:
    """Rows ``[a, b)`` of every leaf of ``data`` on ``device``.

    Leaves already on ``device`` (or any leaf, for ``device=None``) are
    sliced: nothing is copied. A host leaf bound for a card is copied
    from pinned memory (a slice of a pinned corpus is pinned; any other is
    pinned here first, on the calling thread) by ``non_blocking`` copies.
    With ``stream`` the copies run there and an event is recorded after
    them, which :meth:`Staged.take` orders the consumer's stream after;
    without it they run on the current stream, in its order.
    """
    seg = tree_map(lambda x: x[a:b], data)
    if device is None or all(x.device == device for x in leaves(seg)):
        return Staged(seg, None)
    if device.type != "cuda":
        return Staged(tree_map(lambda x: x.to(device), seg), None)

    def put(x):
        if x.device.type == "cpu" and not x.is_pinned():
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    if stream is None:
        return Staged(tree_map(put, seg), None)
    with torch.cuda.stream(stream):
        seg = tree_map(put, seg)
        ready = torch.cuda.Event()
        ready.record(stream)
    return Staged(seg, ready)


def prefetch_segments(
    data: Any,
    segments: Sequence[tuple[int, int]],
    *,
    device=None,
    depth: int | None = None,
    cancel: threading.Event | None = None,
) -> Iterator[Any]:
    """Double-buffered segment streaming for pipelined folds (the
    reference's `repro.core.pipeline.prefetch_segments`).

    Yields ``data[a:b]`` for each ``(a, b)`` in ``segments``, staging on a
    background thread so that while segment *s* folds, segment *s+1* is
    already on its way. ``depth`` bounds the segments staged or held by the
    consumer (2 = double buffering; ``None`` = the active tuning's
    ``prefetch_depth``), so the device holds at most ``depth`` segments of
    a streamed corpus at a time, and one more for as long as the consumer
    keeps its previous segment after asking for the next.

    Where the rows go (:func:`stage`): ``device=None`` or a corpus already
    on ``device`` yields slices, and nothing is copied; a host corpus
    bound for a card is copied on the producer's own CUDA stream from
    pinned memory, and each yielded segment is ordered on the consumer's
    current stream after its copy (:meth:`Staged.take`). Pin the corpus
    once before the scan: a pageable one is pinned segment by segment on
    the producer thread. A CUDA ``device`` without a card raises.

    The iterator may be abandoned early: closing it stops the producer and
    drops staged segments. ``cancel`` (a ``threading.Event``) makes the
    producer stop staging and the stream end early.
    """
    if depth is None:
        depth = tune_config.resolve(None).prefetch_depth
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    if device is not None:
        device = canonical_device(device)
    segments = list(segments)
    staged_bytes = obs.metrics().counter("pipeline.staged_bytes")
    if len(segments) <= 1:
        # nothing to overlap with: no producer thread (a fully resumed job
        # streams zero segments, a one-segment shard streams inline)
        for a, b in segments:
            if cancel is not None and cancel.is_set():
                return
            seg = stage(data, a, b, device).seg
            staged_bytes.inc(_tree_nbytes(seg))
            yield seg
        return
    q: queue_mod.Queue = queue_mod.Queue()
    slots = threading.Semaphore(depth)
    stop = threading.Event()
    _DONE = object()

    def _halted() -> bool:
        return stop.is_set() or (cancel is not None and cancel.is_set())

    def _worker():
        tr = obs.tracer()
        occupancy = obs.metrics().gauge("pipeline.prefetch_occupancy")
        try:
            copy_stream = (
                torch.cuda.Stream(device) if device is not None and device.type == "cuda"
                else None
            )
            for i, (a, b) in enumerate(segments):
                while not slots.acquire(timeout=0.05):
                    if _halted():
                        break
                if _halted():
                    q.put(_DONE)  # end the stream early, don't strand the consumer
                    return
                # the producer half of the pipeline: slice (and copy) segment
                # i while the consumer folds an earlier one
                with tr.span("prefetch.stage", "pipeline", segment_pos=i, rows=b - a):
                    staged = stage(data, a, b, device, copy_stream)
                    staged_bytes.inc(_tree_nbytes(staged.seg))
                q.put(staged)
                occupancy.set(q.qsize())
            q.put(_DONE)
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            q.put(e)

    worker = threading.Thread(target=_worker, name="segment-prefetch", daemon=True)
    worker.start()
    try:
        held = False
        while True:
            if held:
                slots.release()  # the consumer is done with its previous segment
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            held = True
            yield item.take()
    finally:
        stop.set()
        worker.join(timeout=5.0)


def fold_chunks(
    data: Any,
    chunk_size: int,
    fold_fn: Callable[[S, Any, int], S],
    init_state: S,
) -> S:
    """Map+combine over a local shard, ``chunk_size`` rows at a time.

    ``fold_fn(state, chunk, chunk_start) -> state``. The leading dim of every
    leaf must be divisible by ``chunk_size`` (use :func:`pad_leading`);
    ``chunk_start`` is the row offset of the chunk within the local shard.
    """
    n = leaves(data)[0].shape[0]
    if n % chunk_size:
        raise ValueError(f"leading dim {n} not divisible by chunk_size {chunk_size}")
    state = init_state
    for start in range(0, n, chunk_size):
        chunk = tree_map(lambda x, a=start: x[a : a + chunk_size], data)
        state = fold_fn(state, chunk, start)
    return state
