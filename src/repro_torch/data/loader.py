"""Restart-safe host -> device batch feed (the port's copy of
`repro.data.loader`).

A batch is a pure function of the step, ``make_batch(step) -> dict[str,
np.ndarray]``, so a job restarted from a checkpoint at step N reads exactly
the batches it would have seen. The reference lays each batch out under its
``dp`` sharding with ``jax.make_array_from_process_local_data``; here each
``dp`` shard's rows become tensors on that shard's device.

On a card the rows are staged in pinned host memory and copied without
blocking on the current stream; a background thread builds and pins the
next ``prefetch`` steps' batches while the card works. On the CPU the
arrays become tensors directly.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh


class ShardedBatchLoader:
    def __init__(
        self,
        mesh: Mesh,
        batch_axes: tuple[str, ...],
        make_batch: Callable[[int], dict[str, np.ndarray]],
        *,
        prefetch: int = 2,
    ):
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.make_batch = make_batch
        self.prefetch = prefetch
        self.n_shards = math.prod(mesh.shape[a] for a in self.batch_axes)
        self._pool = None
        self._staged: dict[int, object] = {}

    def shard_device(self, i: int) -> torch.device:
        """The device of ``dp`` shard ``i`` (flat over ``batch_axes``)."""
        return self.mesh.shard(i, self.batch_axes)[0]

    def _host(self, step: int) -> list[dict]:
        """Step ``step``'s batch cut into the shards' rows (pinned when the
        shard is a card)."""
        host = self.make_batch(step)
        out = []
        for i in range(self.n_shards):
            pin = self.shard_device(i).type == "cuda"
            part = {}
            for k, v in host.items():
                if v.shape[0] % self.n_shards:
                    raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split over "
                                     f"{self.n_shards} dp shards")
                n = v.shape[0] // self.n_shards
                t = torch.from_numpy(np.ascontiguousarray(v[i * n:(i + 1) * n]))
                part[k] = t.pin_memory() if pin else t
            out.append(part)
        return out

    def _take(self, step: int) -> list[dict]:
        staged = self._staged.pop(step, None)
        host = staged.result() if staged is not None else self._host(step)
        if self.prefetch > 0:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(1, thread_name_prefix="batch-prefetch")
            for s in range(step + 1, step + 1 + self.prefetch):
                if s not in self._staged:
                    self._staged[s] = self._pool.submit(self._host, s)
            for s in [s for s in self._staged if s <= step]:  # a restart went back
                self._staged.pop(s)
        return host

    def shards(self, step: int) -> list[dict[str, torch.Tensor]]:
        """Step ``step``'s batch as each ``dp`` shard's rows on its device,
        in flat shard order."""
        return [{k: t.to(self.shard_device(i), non_blocking=True) for k, t in part.items()}
                for i, part in enumerate(self._take(step))]

    def get(self, step: int) -> dict[str, torch.Tensor]:
        """Step ``step``'s batch on the one ``dp`` shard's device. A mesh with
        several ``dp`` shards takes :meth:`shards`."""
        if self.n_shards != 1:
            raise ValueError(f"{self.n_shards} dp shards: take each shard's rows with shards()")
        return self.shards(step)[0]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._staged.clear()

    def __iter__(self):
        step = 0
        while True:
            yield self.get(step)
            step += 1
