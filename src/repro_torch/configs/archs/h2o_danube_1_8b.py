"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""

from repro_torch.configs.base import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="h2o-danube-1.8b",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32000,
        sliding_window=4096,  # mistral-style SWA on every layer
        activation="silu",
        rope_theta=10_000.0,
    )
