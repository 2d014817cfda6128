"""mirex — the paper's own system: sequential-scan search over a sharded
corpus with the k-bounded combiner merge. [Hiemstra & Hauff, TR-CTIT-10-15]"""

from repro_torch.configs.base import MirexConfig


def config() -> MirexConfig:
    return MirexConfig(
        name="mirex",
        scorer="ql_lm",
        k=1000,
        chunk_size=16384,
        vocab=65_536,
        max_doc_len=128,
        max_q_len=8,
        dense_dim=256,
    )
