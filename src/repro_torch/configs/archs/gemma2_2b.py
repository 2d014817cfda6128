"""gemma2-2b [dense] — local+global alternating, logit softcaps; 8 heads (so
attention TP falls back to dp-only on a 16-way model axis — see DESIGN §5).
[arXiv:2408.00118; hf]"""

from repro_torch.configs.base import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-2b",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_ff=9216,
        vocab=256000,
        head_dim=256,
        sliding_window=4096,
        local_global_alternating=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        activation="gelu",
        rms_one_plus=True,
        rope_theta=10_000.0,
    )
