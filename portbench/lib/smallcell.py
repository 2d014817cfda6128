"""A cell cut to a size the CPU tests can run in a second: the same
driver, traffic and checks, a few thousand short documents."""

from __future__ import annotations

import dataclasses

from portbench.lib import registry

SMALL_CONFIG = {"n_docs": 4096, "max_doc_len": 32, "vocab": 2048, "chunk_size": 512, "k": 50}
# every answer kept, and at most 1,024 checked: every one that the plain
# scan answers at this size, so that a fault in one answer of a block shows
SMALL_MIX = {"rate_qps": 200, "check_requests": 1024, "keep_answers": 1.0}


def small(cell: registry.Cell) -> registry.Cell:
    cfg = {k: v for k, v in SMALL_CONFIG.items() if k in cell.config}
    mix = {k: v for k, v in SMALL_MIX.items() if k in cell.mix}
    return dataclasses.replace(cell, config=dict(cell.config, **cfg), mix=dict(cell.mix, **mix))
