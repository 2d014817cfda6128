"""Atomic step checkpoints in the JAX package's on-disk layout.

A checkpoint is ``<dir>/step_XXXXXXXX/`` holding one ``.npy`` per leaf
(``leaf_00000.npy``, ...) and a ``manifest.json`` naming each leaf by its
path in the tree (``.scores``, ``.ids`` for a ``TopKState``; ``[0]`` for a
tuple position; ``['key']`` for a dict entry) — the layout of
`repro.checkpoint`, so either package resumes the other's checkpoints. A
step is written under ``.tmp-`` and renamed into place: a crash mid-write
never corrupts the latest good step.

The pipelined scan job commits through :class:`AsyncCheckpointer`, one
writer thread that runs each segment's ``save`` → progress → ``prune`` in
submission order. Unlike the reference's immutable JAX arrays, a CUDA
tensor handed to another thread is read on that thread's stream, in no
order with the kernel that writes it, and its block may be reused by the
caching allocator; so the job hands the writer a :func:`snapshot`: a host
copy made on the producing stream, which the writer waits for before it
writes.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import obs


def _flatten(tree, path: str = "") -> list[tuple[str, object]]:
    """(key, leaf) pairs in the reference's key syntax and leaf order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree) for kv in _flatten(t, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [kv for key in sorted(tree) for kv in _flatten(tree[key], f"{path}[{key!r}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from leaves in :func:`_flatten` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        return next(it)

    return build(like)


# numpy has no bfloat16 or float8: such a leaf is stored as its bits, an
# unsigned int of the same width, and the manifest records its true dtype,
# as the reference stores them (its ``_VIEW_AS``); restore views the bits back
_VIEW_AS = {"bfloat16": (torch.uint16, np.uint16),
            "float8_e4m3fn": (torch.uint8, np.uint8),
            "float8_e5m2": (torch.uint8, np.uint8)}
_VIEWED = {getattr(torch, name): name for name in _VIEW_AS if hasattr(torch, name)}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array written, the dtype the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        name = _VIEWED.get(leaf.dtype)
        if name is not None:
            return leaf.view(_VIEW_AS[name][0]).numpy(), name
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored leaf as a tensor of the manifest's dtype, bit for bit."""
    if dtype in _VIEW_AS:
        if not hasattr(torch, dtype):
            raise TypeError(f"this torch has no {dtype} to restore a leaf into")
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(_VIEW_AS[dtype][1]))
        return bits.view(getattr(torch, dtype)).to(device)
    return torch.as_tensor(arr, device=device)


class Snapshot:
    """A host copy of a tree, and the CUDA event after which it holds the
    values (``None`` when the copy was made on the CPU)."""

    def __init__(self, tree, ready: "torch.cuda.Event | None"):
        self.tree = tree
        self.ready = ready

    def wait(self):
        """Block this thread until the copy is done; returns the host tree."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.tree


def snapshot(tree) -> Snapshot:
    """Copy ``tree``'s tensors to the host without waiting for them.

    A CUDA leaf is copied into pinned host memory by ``non_blocking`` copies
    on the current stream (the stream that produced it, so the copy is
    ordered after the kernel and before any reuse of the leaf's block), and
    one event is recorded after the copies; :meth:`Snapshot.wait` waits for
    it. A CPU leaf is cloned. The caller may launch the next fold at once.
    """
    leaves, cuda_devices = [], set()
    for _, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf.detach(), non_blocking=True)
            cuda_devices.add(leaf.device)
            leaves.append(host)
        elif isinstance(leaf, torch.Tensor):
            leaves.append(leaf.detach().clone())
        else:
            leaves.append(np.array(leaf))
    if len(cuda_devices) > 1:
        raise ValueError(f"snapshot: leaves on several devices {sorted(map(str, cuda_devices))}")
    ready = None
    if cuda_devices:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(cuda_devices.pop()))
    return Snapshot(_unflatten(tree, leaves), ready)


def save(ckpt_dir: str, step: int, tree, *, on_commit=None) -> str:
    """Write checkpoint for ``step``; returns the final directory.

    ``tree`` may be a :class:`Snapshot`: the write then waits for its copy.
    ``on_commit(step, tmp_dir)``, if given, runs after the full write but
    *before* the rename-commit: an error raised there aborts the commit and
    leaves only the ``.tmp-`` dir behind.
    """
    if isinstance(tree, Snapshot):
        tree = tree.wait()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    t_save = time.monotonic()
    with obs.tracer().span("ckpt.save", "ckpt", step=step):
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = []
        written = 0
        for i, (key, leaf) in enumerate(_flatten(tree)):
            arr, true_dtype = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            written += arr.nbytes
            manifest.append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": true_dtype}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if on_commit is not None:
            on_commit(step, tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        t_rename = time.monotonic()
        with obs.tracer().span("ckpt.rename", "ckpt", step=step):
            os.replace(tmp, final)  # atomic commit
        met = obs.metrics()
        met.histogram("ckpt.rename_s").observe(time.monotonic() - t_rename)
        met.histogram("ckpt.save_s").observe(time.monotonic() - t_save)
        met.counter("ckpt.written_bytes").inc(written)
    return final


def replace_dir(src: str, dst: str) -> None:
    """Promote checkpoint dir ``src`` over ``dst``."""
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.replace(src, dst)


def all_steps(ckpt_dir: str) -> list[int]:
    """Committed checkpoint steps (ascending); uncommitted .tmp dirs excluded."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    )


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def prune(ckpt_dir: str, keep: int) -> list[int]:
    """Delete all but the newest ``keep`` checkpoints; returns removed steps."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    steps = all_steps(ckpt_dir)
    drop = steps[:-keep] if len(steps) > keep else []
    for s in drop:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
    return drop


class AsyncCheckpointer:
    """Ordered background committer: checkpoint I/O off the critical path
    (the reference's `repro.checkpoint.AsyncCheckpointer`).

    * **same order** — tasks run strictly in submission order on one
      thread, so the on-disk write sequence is the synchronous path's; a
      hard kill at any instant leaves a disk state the synchronous path
      could also have left.
    * **fail-stop** — the first task error poisons the queue: later tasks
      are skipped (a progress manifest must never claim a commit whose
      ``save`` failed) and the error re-raises on the next
      :meth:`drain`/:meth:`submit`/:meth:`close`.
    * **drain barrier** — :meth:`drain` blocks until everything submitted
      so far is on disk.

    Hand it a :func:`snapshot` of device state, never the live tensors.
    """

    def __init__(self):
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._closed = False
        self._thread.start()

    def _run(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                if self._error is None:  # poison: skip everything after a failure
                    fn, args, kwargs = item
                    fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised on drain
                self._error = e
            finally:
                self._queue.task_done()
                obs.metrics().gauge("ckpt.writer_queue_depth").set(self._queue.qsize())

    def _check(self):
        # the error stays set: a failed commit poisons the writer for good
        if self._error is not None:
            raise self._error

    def submit(self, fn, *args, **kwargs) -> None:
        """Enqueue ``fn(*args, **kwargs)`` after everything already queued."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._check()
        self._queue.put((fn, args, kwargs))
        obs.metrics().gauge("ckpt.writer_queue_depth").set(self._queue.qsize())

    def drain(self) -> None:
        """Block until all submitted work is on disk; re-raise writer errors."""
        self._queue.join()
        self._check()

    def _shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.join()
        self._queue.put(None)
        self._thread.join()

    def close(self) -> None:
        """Drain, stop the writer thread, and re-raise any pending error."""
        was_closed = self._closed
        self._shutdown()
        if not was_closed:
            self._check()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # an in-flight exception (e.g. an injected kill) wins over a writer error
        if exc_type is not None:
            self._shutdown()
            return False
        self.close()
        return False


def restore(ckpt_dir: str, step: int, tree_like, *, device=None):
    """Load ``step`` into the structure of ``tree_like``, as tensors on
    ``device`` (default: each template leaf's device, CPU for numpy), each of
    the dtype its manifest records (a bfloat16 leaf's stored bits are viewed
    back as bfloat16)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    named = _flatten(tree_like)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    if set(by_key) != {k for k, _ in named}:
        missing = {k for k, _ in named} ^ set(by_key)
        raise ValueError(f"checkpoint structure mismatch; differing keys: {sorted(missing)[:5]}")
    leaves = []
    for key, like in named:
        meta = by_key[key]
        arr = np.load(os.path.join(d, meta["file"]))
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu"
        )
        leaves.append(_from_numpy(arr, meta["dtype"], dev))
    return _unflatten(tree_like, leaves)
