"""Atomic step checkpoints in the JAX package's on-disk layout.

A checkpoint is ``<dir>/step_XXXXXXXX/`` holding one ``.npy`` per leaf
(``leaf_00000.npy``, ...) and a ``manifest.json`` naming each leaf by its
path in the tree (``.scores``, ``.ids`` for a ``TopKState``; ``[0]`` for a
tuple position; ``['key']`` for a dict entry) — the layout of
`repro.checkpoint`, so either package resumes the other's checkpoints. A
step is written under ``.tmp-`` and renamed into place: a crash mid-write
never corrupts the latest good step.

The asynchronous writer (``AsyncCheckpointer``) waits for the executor
slice; this slice's scan job commits synchronously.
"""

from __future__ import annotations

import json
import os
import shutil
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


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, *, on_commit=None) -> str:
    """Write checkpoint for ``step``; returns the final directory.

    ``on_commit(step, tmp_dir)``, if given, runs after the full write but
    *before* the rename-commit: an error raised there aborts the commit and
    leaves only the ``.tmp-`` dir behind.
    """
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
            arr = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            written += arr.nbytes
            manifest.append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
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


def restore(ckpt_dir: str, step: int, tree_like, *, device=None):
    """Load ``step`` into the structure of ``tree_like``, as tensors on
    ``device`` (default: each template leaf's device, CPU for numpy)."""
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
        arr = np.load(os.path.join(d, by_key[key]["file"]))
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu"
        )
        leaves.append(torch.as_tensor(arr, device=dev))
    return _unflatten(tree_like, leaves)
