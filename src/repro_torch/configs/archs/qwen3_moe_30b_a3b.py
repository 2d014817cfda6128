"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained experts.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-30b-a3b",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,
        vocab=151936,
        n_experts=128,
        top_k=8,
        activation="silu",
        rope_theta=1_000_000.0,
    )
