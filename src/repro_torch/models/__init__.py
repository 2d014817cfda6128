"""Models of the port: the dense decoder-only transformer (LM serving:
prefill, then decode over a KV cache), its attention and shared pieces.
The MoE, GNN, recsys and embedding models wait for their slices."""
