"""pna [gnn] — 4 aggregators (mean/max/min/std) × scalers (id/amp/atten).
[arXiv:2004.05718; paper]"""

from repro_torch.configs.base import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(
        name="pna",
        n_layers=4,
        d_hidden=75,
        aggregators=("mean", "max", "min", "std"),
        scalers=("identity", "amplification", "attenuation"),
        delta=2.5,  # E[log(deg+1)] over the training graphs (dataset constant)
    )
