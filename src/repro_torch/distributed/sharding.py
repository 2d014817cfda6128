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


def constrain(x, mesh: Mesh, rules: AxisRules, *logical: str | None):
    """The identity. The reference pins a layout with
    ``with_sharding_constraint``; torch has no sharding annotations, and the
    code that owns each tensor places it on its shard's device."""
    del mesh, rules, logical
    return x
