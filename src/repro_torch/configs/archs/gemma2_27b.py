"""gemma2-27b [dense] — local+global alternating attention, logit softcaps,
gemma (1+w) RMSNorm, GeGLU. [arXiv:2408.00118; hf]"""

from repro_torch.configs.base import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-27b",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_ff=36864,
        vocab=256000,
        head_dim=128,
        sliding_window=4096,
        local_global_alternating=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        activation="gelu",
        rms_one_plus=True,
        rope_theta=10_000.0,
        remat_chunk=2,  # 23 chunks × 2 layers: carry stack ÷2, keeps local/global pairing
        grad_accum=8,  # per-microbatch activations ÷8 (27B dense, d_ff 36k)
    )
