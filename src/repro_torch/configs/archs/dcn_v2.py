"""dcn-v2 [recsys] — 13 dense + 26 sparse fields (criteo layout), 3 full-rank
cross layers, stacked MLP 1024-1024-512. [arXiv:2008.13535; paper]"""

from repro_torch.configs.base import RecsysConfig


def config() -> RecsysConfig:
    return RecsysConfig(
        name="dcn-v2",
        variant="dcn-v2",
        n_dense=13,
        n_sparse=26,
        embed_dim=16,
        n_cross_layers=3,
        mlp_dims=(1024, 1024, 512),
        vocab_per_field=1_000_000,
    )
