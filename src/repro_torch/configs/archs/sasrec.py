"""sasrec [recsys] — causal self-attention over item history.
[arXiv:1808.09781; paper]"""

from repro_torch.configs.base import RecsysConfig


def config() -> RecsysConfig:
    return RecsysConfig(
        name="sasrec",
        variant="sasrec",
        embed_dim=50,
        n_blocks=2,
        n_heads=1,
        seq_len=50,
        n_items=3_000_000,
    )
