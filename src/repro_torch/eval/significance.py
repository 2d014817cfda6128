"""Paired randomization (Fisher permutation) test between two runs.

The standard IR significance test (Smucker, Allan & Carterette, CIKM'07):
under H0 the two systems are exchangeable per query, so each query's pair of
metric values can be swapped freely. The test statistic is the mean per-query
difference; its null distribution is sampled by random sign flips of the
observed differences. Exact for small query sets, assumption-free (no
normality, unlike the t-test), and it consumes exactly the per-query vectors
`repro_torch.eval.metrics.evaluate_run` already returns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SignificanceResult(NamedTuple):
    mean_a: float
    mean_b: float
    diff: float  # mean_a - mean_b
    p_value: float  # two-sided
    n_permutations: int

    def __str__(self) -> str:
        return (
            f"diff={self.diff:+.4f} (A={self.mean_a:.4f}, B={self.mean_b:.4f}), "
            f"p={self.p_value:.4f} [{self.n_permutations} permutations]"
        )


def paired_randomization_test(
    per_query_a: np.ndarray,
    per_query_b: np.ndarray,
    *,
    n_permutations: int = 10_000,
    seed: int = 0,
) -> SignificanceResult:
    """Two-sided paired randomization test on per-query metric vectors.

    The +1/(n+1) smoothing makes the Monte-Carlo p-value a valid test (the
    observed labeling is itself one permutation), so p is never exactly 0.
    """
    a = np.asarray(per_query_a, np.float64)
    b = np.asarray(per_query_b, np.float64)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"need matching per-query vectors, got {a.shape} vs {b.shape}")
    if a.size == 0:
        raise ValueError("empty per-query vectors")
    d = a - b
    observed = d.mean()
    rng = np.random.default_rng(seed)
    signs = rng.choice((-1.0, 1.0), size=(n_permutations, d.size))
    null = (signs * d).mean(axis=1)
    p = (np.sum(np.abs(null) >= abs(observed)) + 1.0) / (n_permutations + 1.0)
    return SignificanceResult(
        mean_a=float(a.mean()),
        mean_b=float(b.mean()),
        diff=float(observed),
        p_value=float(p),
        n_permutations=n_permutations,
    )
