"""The plain reference: collection statistics, BM25 and query-likelihood
scores and the exact top k, in plain PyTorch.
Nothing here imports the program; it takes only the benchmark's inputs."""
