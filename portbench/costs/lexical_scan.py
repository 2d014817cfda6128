"""The least time one call of the multi-model lexical scan can take on one
H100 (the kernel `csrc/lexical_scan.cu`: shared term frequencies, each
model's epilogue, each (model, query)'s top k).

Bytes: every input read once (the query terms, each model's weights, its
alpha and beta and its mode code, the token rows as stored, the lengths),
both outputs (scores and ids, float32 and int32) written once. Operations:
one lookup a stored token and one epilogue and compare a (model, query,
document), at the INT32 rate. The bound is the larger of the two times.
"""


def bound_s(*, n_models: int, n_q: int, l_q: int, n_d: int, l_d: int, k: int,
            peaks: dict) -> float:
    n_bytes = 4 * (n_q * l_q + n_models * n_q * l_q + 2 * n_models + n_models
                   + n_d * l_d + n_d) + 2 * 4 * n_models * n_q * k
    ops = n_d * l_d + n_models * n_q * n_d
    return max(n_bytes / peaks["hbm_bytes_per_s"], ops / peaks["int32_ops_per_s"])
