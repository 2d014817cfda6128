"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.configs.base import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="dbrx-132b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        n_experts=16,
        top_k=4,
        activation="silu",
        rope_theta=500_000.0,
        remat_chunk=5,  # two-level checkpointing: 8 chunks × 5 layers
        grad_accum=8,  # 8 microbatches: peak activations ÷8 at 132B scale
        # f32 Adam moments for 132B params on 256×16GB chips cannot fit
        # (8 B/param = 4.1 GiB/chip after full sharding); bf16 moments are
        # the standard trade at this chip count.
        opt_dtype="bfloat16",
    )
