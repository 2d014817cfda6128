"""fm [recsys] — factorization machine, pairwise ⟨vᵢ,vⱼ⟩xᵢxⱼ via the O(nk)
sum-square trick. [ICDM'10 (Rendle); paper]"""

from repro_torch.configs.base import RecsysConfig


def config() -> RecsysConfig:
    return RecsysConfig(
        name="fm",
        variant="fm",
        n_sparse=39,
        embed_dim=10,
        vocab_per_field=1_000_000,
    )
