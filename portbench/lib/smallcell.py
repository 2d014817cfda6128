"""A cell cut to a size the CPU tests run in a second: the same driver,
traffic and checks at the size its driver declares in ``SMALL``."""

from __future__ import annotations

import dataclasses

from portbench.lib import registry


def small(cell: registry.Cell) -> registry.Cell:
    """``cell`` with its driver's ``SMALL["config"]`` and ``SMALL["mix"]``
    laid over its configuration and mix, and nothing else changed. The
    driver is the one under the cell's own root."""
    driver = registry.load_module("drivers", cell.mix["driver"], cell.root)
    cut = getattr(driver, "SMALL", None)
    if cut is None:
        raise ValueError(f"driver {cell.mix['driver']!r} declares no SMALL")
    return dataclasses.replace(cell, config=dict(cell.config, **cut["config"]),
                               mix=dict(cell.mix, **cut["mix"]))
