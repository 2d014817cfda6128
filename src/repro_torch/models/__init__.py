"""Models of the port: the decoder-only transformer, dense and MoE (LM
serving and training), its attention and shared pieces, the recsys models
and their embedding lookups, and the GNN (PNA) with its deterministic
segment reduces (`segment`)."""
