"""Architecture registry of the port: ``get_config`` and ``reduced_config``.

The port holds the paper's own system, ``mirex`` (what `launch.serve`
reads). The assigned LM, GNN and recsys architectures of `repro.configs`
wait for the models slice; asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.archs import mirex
from repro_torch.configs.base import MirexConfig

_MODULES = {"mirex": mirex}
_MODELS_SLICE = (
    "dbrx-132b", "qwen3-moe-30b-a3b", "h2o-danube-1.8b", "gemma2-27b", "gemma2-2b",
    "pna", "dcn-v2", "fm", "mind", "sasrec",
)

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> MirexConfig:
    if arch in _MODELS_SLICE:
        raise NotImplementedError(f"the {arch!r} config waits for the models slice of the port")
    try:
        return _MODULES[arch].config()
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}") from None


def reduced_config(arch: str) -> MirexConfig:
    """Tiny same-family config for CPU smoke tests, as `repro.configs`
    reduces ``mirex``: same structure, reduced dims."""
    cfg = get_config(arch)
    return dataclasses.replace(cfg, vocab=512, k=16, chunk_size=64, max_doc_len=32, dense_dim=32)
