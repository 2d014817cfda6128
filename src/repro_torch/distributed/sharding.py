"""Mesh-axis vocabulary and logical -> physical sharding rules (the port's
copy of `repro.distributed.sharding`), with the port's own :class:`Mesh`.

Every model is written against *logical* axes; the mapping to physical
mesh axes lives here, so the same code runs on the single-pod
``("data", "model")`` mesh, the multi-pod ``("pod", "data", "model")`` mesh
and a one-device mesh.

Logical axes:
  ``dp``     — batch / corpus-shard axis set (pod composes here)
  ``tp``     — tensor/expert-parallel axis ("model")
  ``scan``   — corpus & candidate scan axis set: all mesh axes flattened
               (a MIREX scan wants *every* device to own documents)

torch has no mesh and no sharding annotations. :class:`Mesh` is an n-d
array of ``torch.device`` with named axes; the code that owns a tensor
places it (`cluster.search_mesh` puts each corpus shard on its shard's
device, `models.moe.make_moe_layer` gives each shard its experts), so
:func:`constrain` is the identity and :meth:`AxisRules.spec` returns a
plain tuple of axis groups. A device may repeat in a mesh: on one card a
4-shard mesh is ``cuda:0`` four times, the counterpart of the reference's
faked host devices (``--xla_force_host_platform_device_count``) and of
nothing more — the shards then share the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.obs import counting


class Mesh:
    """Named axes over an n-d array of devices.

    ``devices`` is any nested sequence (or object array) of devices or
    device names whose shape gives the axes' sizes, in ``axis_names``
    order. ``shape`` maps each axis name to its size, as the reference's
    ``Mesh.shape`` does.
    """

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device array for axes {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def shard(self, index: int, axis_names: Sequence[str] | None = None):
        """``(device, coords)`` of flat shard ``index`` over ``axis_names``
        (default: every axis), row-major in the order given — the
        reference's ``idx = idx * axis_size(a) + axis_index(a)``. Axes not
        named sit at coordinate 0."""
        axis_names = self.axis_names if axis_names is None else tuple(axis_names)
        sizes = [self.shape[a] for a in axis_names]
        if not 0 <= index < math.prod(sizes):
            raise IndexError(f"shard {index} outside {dict(zip(axis_names, sizes))}")
        coords = dict.fromkeys(self.axis_names, 0)
        for a, n in zip(reversed(axis_names), reversed(sizes)):
            index, coords[a] = divmod(index, n)
        full = tuple(coords[a] for a in self.axis_names)
        return self.devices[full], full

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


@dataclasses.dataclass(frozen=True)
class AxisRules:
    dp: tuple[str, ...]
    tp: str

    @property
    def all_axes(self) -> tuple[str, ...]:
        return (*self.dp, self.tp)

    @property
    def scan_axes(self) -> tuple[str, ...]:
        """Physical axes behind the logical "scan" axis — every mesh axis.

        Deduplicated: on a single-axis mesh the degenerate
        :func:`rules_for_mesh` fallback maps dp and tp to the *same* axis,
        and a repeated name would count its shards twice.
        """
        return tuple(dict.fromkeys(self.all_axes))

    def spec(self, *logical: str | None) -> tuple:
        """The physical axis group of each dim's logical name (a plain
        tuple: torch has no ``PartitionSpec``)."""
        return tuple(logical_to_spec(self, name) for name in logical)


def logical_to_spec(rules: AxisRules, name: str | None):
    if name is None:
        return None
    if name == "dp":
        return rules.dp if len(rules.dp) > 1 else rules.dp[0]
    if name == "tp":
        return rules.tp
    if name == "scan":
        return rules.all_axes
    raise ValueError(f"unknown logical axis {name!r}")


def replicated_specs(shapes):
    """A replicated spec (``None`` for every dim) for each leaf of a tree
    (dicts) of shapes (any leaf with a ``shape``)."""
    if isinstance(shapes, dict):
        return {k: replicated_specs(v) for k, v in shapes.items()}
    return (None,) * len(shapes.shape)


RULES_SINGLE_POD = AxisRules(dp=("data",), tp="model")
RULES_MULTI_POD = AxisRules(dp=("pod", "data"), tp="model")


def rules_for_mesh(mesh: Mesh) -> AxisRules:
    names = tuple(mesh.axis_names)
    if "pod" in names:
        return RULES_MULTI_POD
    if names == ("data", "model"):
        return RULES_SINGLE_POD
    # degenerate test meshes: first axis = dp, last = tp
    return AxisRules(dp=tuple(names[:-1]) or (names[0],), tp=names[-1])


def _record(out: torch.Tensor, kind: str, payload: int, group: int, grad_kind: str,
            grad_payload: int) -> None:
    """Tell an op counter in force (`repro_torch.obs.counting`) of a
    collective, and of its transpose when the backward reaches it."""
    if counting.active() is None or group < 2:
        return
    counting.collective(kind, payload, group)
    if out.requires_grad:
        out.register_hook(lambda g: counting.collective(grad_kind, grad_payload, group))


def all_gather_parts(parts: list, dim: int = 0, group: int | None = None) -> torch.Tensor:
    """An all-gather: the shards' parts joined in shard order on the first
    one's device; one part is returned as it is (no copy). ``group``: the
    shards the gather spans, where each part already joins the shards that
    share its device (:func:`device_runs`; default one part a shard)."""
    group = group or len(parts)
    out, share = parts[0], counting.tensor_bytes(parts[0])
    if len(parts) > 1:
        out = torch.cat([p.to(out.device) for p in parts], dim=dim)
    else:
        share //= group
    _record(out, "all-gather", counting.tensor_bytes(out), group, "reduce-scatter", share)
    return out


def psum_parts(parts: list, group: int | None = None) -> torch.Tensor:
    """A psum: the shards' partials added left to right on the first one's
    device. ``group``: the shards the sum spans, where each part already
    sums the shards that share its device (:func:`device_runs`; default one
    part a shard)."""
    dev = parts[0].device
    out = parts[0]
    if len(parts) > 1 and out.is_meta and all(p is out for p in parts):
        # one shard's part standing for all (`counting.each_shard` on meta):
        # one add, counted for each of the n - 1
        with counting.repeated(len(parts) - 1):
            out = out + out
    else:
        for p in parts[1:]:
            out = out + p.to(dev)
    _record(out, "all-reduce", counting.tensor_bytes(out), group or len(parts), "all-reduce",
            counting.tensor_bytes(out))
    return out


def pmax_parts(parts: list, group: int | None = None) -> torch.Tensor:
    """A pmax: the elementwise maximum of the shards' parts on the first
    one's device, an all-reduce recorded as :func:`psum_parts` records one
    (``group`` as there). The port takes no gradient through it."""
    dev = parts[0].device
    out = parts[0] if len(parts) == 1 else torch.stack([p.to(dev) for p in parts]).amax(dim=0)
    _record(out, "all-reduce", counting.tensor_bytes(out), group or len(parts), "all-reduce",
            counting.tensor_bytes(out))
    return out


def device_runs(devices) -> list[tuple[torch.device, int, int]]:
    """``(device, start, stop)`` for each run of consecutive shards on one
    device: shards that share a device compute as one batch (one
    product, one kernel launch) and reduce among themselves before a
    collective crosses devices. On one card a mesh is one run."""
    runs: list = []
    for i, d in enumerate(devices):
        if runs and runs[-1][0] == d:
            runs[-1] = (d, runs[-1][1], i + 1)
        else:
            runs.append((d, i, i + 1))
    return runs


def constrain(x, mesh: Mesh, rules: AxisRules, *logical: str | None):
    """The identity. The reference pins a layout with
    ``with_sharding_constraint``; torch has no sharding annotations, and the
    code that owns each tensor places it on its shard's device."""
    del mesh, rules, logical
    return x
