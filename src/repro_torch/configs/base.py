"""Config dataclasses of the port: the paper's own system, ``MirexConfig``,
the decoder-only LM, ``TransformerConfig``, the GNN, ``GNNConfig``, the
recsys models, ``RecsysConfig``, and one (architecture x input-shape) cell,
``ShapeSpec`` (copies of `repro.configs.base`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MirexConfig:
    """The paper's own system: scan + top-k over a (sharded) corpus."""

    name: str = "mirex"
    scorer: str = "ql_lm"
    k: int = 1000
    chunk_size: int = 1024
    vocab: int = 65_536
    max_doc_len: int = 128
    max_q_len: int = 8
    dense_dim: int = 256  # dense-representation scan path


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Decoder-only LM (dense or MoE)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # None -> d_model // n_heads
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention flavour
    sliding_window: int | None = None  # SWA width (local layers)
    local_global_alternating: bool = False  # gemma2: even layers local
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10_000.0
    activation: str = "silu"  # swiglu | geglu via "gelu"
    rms_one_plus: bool = False  # gemma-style (1 + w) RMSNorm scale
    dtype: str = "bfloat16"
    remat: bool = True
    remat_chunk: int = 1  # >1: two-level checkpointing, layers per chunk
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)
    grad_accum: int = 1  # microbatches per step (grad accumulation)
    opt_dtype: str = "float32"  # Adam moment dtype (bf16 at extreme scale)
    q_block: int = 512  # chunked-attention query block

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * f * max(self.n_experts, 1)
        router = d * self.n_experts
        per_layer = attn + ffn + router + 2 * d
        return v * d * 2 + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * f * self.top_k
        per_layer = attn + ffn + d * self.n_experts + 2 * d
        return v * d * 2 + self.n_layers * per_layer + d


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """PNA-style message-passing network."""

    name: str
    n_layers: int
    d_hidden: int
    aggregators: tuple[str, ...] = ("mean", "max", "min", "std")
    scalers: tuple[str, ...] = ("identity", "amplification", "attenuation")
    n_classes: int = 16
    delta: float = 1.0  # mean log-degree normalizer (dataset constant)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """Sparse-embedding + feature-interaction ranking/retrieval model."""

    name: str
    variant: str  # dcn-v2 | fm | mind | sasrec
    embed_dim: int
    n_dense: int = 0
    n_sparse: int = 0
    vocab_per_field: int = 1_000_000
    # dcn-v2
    n_cross_layers: int = 0
    mlp_dims: tuple[int, ...] = ()
    # mind
    n_interests: int = 0
    capsule_iters: int = 0
    # sasrec
    n_blocks: int = 0
    n_heads: int = 0
    seq_len: int = 0
    n_items: int = 3_000_000
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture x input-shape) cell."""

    name: str
    kind: str  # train | prefill | decode | full_graph | minibatch | batched_graphs | rec_train | rec_serve | retrieval | scan
    dims: dict

    def __str__(self) -> str:
        return f"{self.name}({self.kind}:{self.dims})"
