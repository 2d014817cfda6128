"""mind [recsys] — multi-interest capsule routing (B2I dynamic routing).
[arXiv:1904.08030; unverified]"""

from repro_torch.configs.base import RecsysConfig


def config() -> RecsysConfig:
    return RecsysConfig(
        name="mind",
        variant="mind",
        embed_dim=64,
        n_interests=4,
        capsule_iters=3,
        seq_len=50,
        n_items=3_000_000,
    )
