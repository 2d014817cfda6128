"""A step's cost, counted as its ops run: the port's counterpart of
`repro.launch.hloparse`.

Eager PyTorch makes no HLO. :class:`OpCounter` is a ``TorchDispatchMode``
that sees every aten op a step runs, on ``meta`` tensors (shapes and dtypes,
no data: nothing is computed) or on real ones, and counts:

* **FLOPs** from torch's own registry (``torch.utils.flop_counter``:
  matmuls, convolutions, attention), by the dtype class of the first
  operand: ``bf16`` (bfloat16 / float16 products), ``f32`` (float32
  products) and ``other`` (the rest); the dense kernel charges ``tf32``
  (its three TF32 products, `kernels.score_topk.cost`) and the lexical
  kernel ``other`` (its integer lookups and compares). Elementwise ops cost
  bytes only, as ``hloparse`` counts dots and convolutions only.
* **HBM bytes**: the operands plus the outputs of every aten op. Views and
  other layout-only ops are free (``hloparse._FREE_OPS``), ``copy_``
  reads its source and writes its destination once, a fill writes only,
  and an indexed in-place write (``index_copy_``, ``index_put_``, ...)
  reads its indices and values and writes the values.
* **The kernels' costs.** A wrapper of `repro_torch.kernels.ops` runs its
  body through `obs.counting.kernel`: under a counter it charges the
  kernel's ``cost`` (the formulas of PERF.md's Bound column) and runs the body
  uncounted — the ``meta`` outputs, the plain version on the CPU or the
  launch on the card — so a cell counts what the card's kernel does
  whatever device it runs on.
* **Collectives** in the reference's five kinds, recorded through
  `obs.counting.collective` where the port merges across shards
  (`distributed.sharding.psum_parts` and ``all_gather_parts``, the
  cross-shard merges of `core.topk`, `models.gnn.pmax_diff`), with their
  group sizes. The transposes of ``psum_parts`` and ``all_gather_parts``
  (an all-reduce and a reduce-scatter of the gradient) are recorded when
  the backward reaches them.
* **Peak live bytes**: every storage an op creates (and every input
  :meth:`OpCounter.track` is given) counts from its creation until a weak
  reference's finalizer sees it freed; the peak is the most alive at once.
  Storages the kernels' plain versions create inside their bodies are not
  seen (the card's kernel holds no such tensors). Where
  `obs.counting.each_shard` counts one shard's body for all of them, that
  shard's tensors are live once.

No trip counts are needed: every executed op is seen, once per execution.

**Per device.** The reference's HLO is the per-device program of an SPMD
step. The port runs a mesh's shards one after another on one device (the
mesh's entries may all be ``meta``), so every shard's ops are seen once and
the sums are the whole mesh's. The per-device figures of :meth:`result`
are those sums ÷ the mesh's size: exact where the work splits evenly (an
edge slab, a corpus shard, a batch block), low where SPMD repeats work on
every device that the port does once (a replicated input projection, a
replicated table's bytes in the peak). A collective is recorded once per
group with each member's payload, so its per-device bytes are Σ payload ×
group size ÷ the mesh's size. On a mesh of one (one H100) nothing is
divided.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.obs import counting
from repro_torch.obs.counting import tensor_bytes, tensors_of

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
CLASSES = ("bf16", "tf32", "f32", "other")

# layout-only ops and allocations, beside every op torch marks as a view
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.detach, aten.alias,
         aten.lift_fresh, aten._unsafe_view, aten.resize_, aten.set_}
_WRITE_ONLY = {aten.zero_, aten.fill_, aten.normal_, aten.uniform_, aten.random_,
               aten.zeros_like, aten.ones_like, aten.full_like}
# in-place writes of some rows: the indices and the values read, the values written
_INDEXED_WRITES = {aten.index_copy_, aten.index_put_, aten.scatter_, aten.index_add_,
                   aten.scatter_add_}


def dtype_class(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "f32"
    return "other"


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside ``with OpCounter(n_devices):`` (see the
    module's docstring); :meth:`result` gives the per-device figures."""

    def __init__(self, n_devices: int = 1):
        super().__init__()
        self.n_devices = n_devices
        self.flops = dict.fromkeys(CLASSES, 0.0)
        self.bytes = 0.0
        self.ops = 0
        self.kernels: dict[str, dict] = {}
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_counts: dict[str, float] = defaultdict(float)
        self.coll_groups: dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._suspended = 0
        self._scale = 1

    # -- the mode ---------------------------------------------------------

    def __enter__(self):
        counting.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counting.pop(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        self.ops += self._scale
        packet = func._overloadpacket
        ins, outs = tensors_of((args, kwargs)), tensors_of(out)
        if packet in flop_registry:
            cls = dtype_class(ins[0].dtype) if ins else "other"
            # the registry's formulas take shapes; an ``out_dtype`` overload
            # (``mm.dtype``, ``bmm.dtype``) passes its dtype positionally
            shaped = tuple(a for a in args if not isinstance(a, torch.dtype))
            self.flops[cls] += self._scale * float(
                flop_registry[packet](*shaped, **kwargs, out_val=out))
        if not (func.is_view or packet in _FREE):
            if packet is aten.copy_:
                n = 2 * tensor_bytes(ins[1])
            elif packet in _WRITE_ONLY:
                n = sum(tensor_bytes(t) for t in outs)
            elif packet in _INDEXED_WRITES:
                n = sum(tensor_bytes(t) for t in ins[1:]) + tensor_bytes(ins[-1])
            else:
                n = sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
            self.bytes += self._scale * n
        self._track(outs)
        return out

    # -- what the kernels and the merges report ---------------------------

    def charge_kernel(self, name: str, cost: dict, run: Callable[[], Any]):
        line = self.kernels.setdefault(
            name, {"calls": 0, "flops": dict.fromkeys(CLASSES, 0.0), "bytes": 0.0})
        line["calls"] += self._scale
        for cls, n in cost["flops"].items():
            self.flops[cls] += self._scale * n
            line["flops"][cls] += self._scale * n
        self.bytes += self._scale * cost["bytes"]
        line["bytes"] += self._scale * cost["bytes"]
        self._suspended += 1
        try:
            out = run()
        finally:
            self._suspended -= 1
        self._track(tensors_of(out))
        return out

    def record_collective(self, kind: str, payload: float, group: int) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVES}")
        self.coll_bytes[kind] += self._scale * payload * group
        self.coll_counts[kind] += self._scale * group
        self.coll_groups[kind] = max(self.coll_groups.get(kind, 1), group)

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times (`obs.counting.each_shard`;
        0: not at all)."""
        scale = self._scale
        self._scale *= n
        try:
            yield
        finally:
            self._scale = scale

    # -- live bytes ---------------------------------------------------------

    def track(self, *trees) -> None:
        """Count the tensors of ``trees`` (a step's arguments) as live."""
        self._track(tensors_of(trees))

    def _track(self, tensors) -> None:
        for t in tensors:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):  # a tensor without storage
                continue
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- the figures ----------------------------------------------------------

    def result(self) -> dict:
        """Per-device figures (÷ ``n_devices``; see the module docstring),
        keyed as ``hloparse.analyze_hlo``'s where they mean the same."""
        n = self.n_devices
        return {
            "flops": sum(self.flops.values()) / n,
            "flops_by_class": {c: v / n for c, v in self.flops.items()},
            "bytes_accessed": self.bytes / n,
            "collective_bytes": {k: v / n for k, v in self.coll_bytes.items()},
            "collective_counts": {k: v / n for k, v in self.coll_counts.items()},
            "collective_group_sizes": dict(self.coll_groups),
            "kernels": {k: {"calls": v["calls"],
                            "flops": {c: f / n for c, f in v["flops"].items()},
                            "bytes": v["bytes"] / n} for k, v in self.kernels.items()},
            "peak_bytes": self.peak_bytes / n,
            "ops": self.ops,
            "n_devices": n,
        }
