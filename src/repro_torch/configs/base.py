"""Config dataclasses of the port: the paper's own system, ``MirexConfig``.

The LM, GNN and recsys configs (`repro.configs.base`) wait for the models
slice of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MirexConfig:
    """The paper's own system: scan + top-k over a (sharded) corpus."""

    name: str = "mirex"
    scorer: str = "ql_lm"
    k: int = 1000
    chunk_size: int = 1024
    vocab: int = 65_536
    max_doc_len: int = 128
    max_q_len: int = 8
    dense_dim: int = 256  # dense-representation scan path
