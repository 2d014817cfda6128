"""The frozen cost of the lexical scan against a count by hand."""

import json

from portbench.lib import registry

PEAKS = json.loads((registry.ROOT / "peaks.json").read_text())


def test_lexical_scan_bound_by_hand():
    cost = registry.load_module("costs", "lexical_scan")
    # one mirex segment: 262,144 rows of 128 int32 tokens, 50 queries of 8
    # slots, 5 models, k 1000
    read = (50 * 8 + 5 * 50 * 8 + 5 * 2 + 5 + 262144 * 128 + 262144) * 4
    written = 5 * 50 * 1000 * (4 + 4)
    want_bytes = read + written
    assert want_bytes == 137_275_964
    ops = 262144 * 128 + 5 * 50 * 262144
    t = cost.bound_s(n_models=5, n_q=50, l_q=8, n_d=262144, l_d=128, k=1000, peaks=PEAKS)
    assert t == max(want_bytes / 3.35e12, ops / (64 * 132 * 1.98e9))
    assert t == want_bytes / 3.35e12 and 4.09e-5 < t < 4.11e-5  # bytes bound it: 41 us
    # a block of 64 queries over a quarter of cat. B: 6.44 GB of tokens
    t = cost.bound_s(n_models=1, n_q=64, l_q=8, n_d=12582912, l_d=128, k=1000, peaks=PEAKS)
    assert 1.9e-3 < t < 1.95e-3


def test_peaks_keep_the_lexical_bound_and_follow_their_sources():
    """The rates the lexical roofline reads are the parent's to the bit (its
    bounds at the shapes above are unchanged), and each tensor-core and
    FP32 rate is its source's arithmetic."""
    cost = registry.load_module("costs", "lexical_scan")
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12 and PEAKS["int32_ops_per_s"] == 64 * 132 * 1.98e9
    assert cost.bound_s(n_models=5, n_q=50, l_q=8, n_d=262144, l_d=128, k=1000,
                        peaks=PEAKS) == 4.097789970149254e-05
    assert cost.bound_s(n_models=1, n_q=64, l_q=8, n_d=12582912, l_d=128, k=1000,
                        peaks=PEAKS) == 0.001938298119402985
    # dense is half the data sheet's rate with sparsity (1,979 and 989
    # TFLOPS, rounded there); the white paper's 989.4 and 494.7
    assert PEAKS["bf16_tensor_flops_per_s"] == 989.4e12
    assert abs(2 * PEAKS["bf16_tensor_flops_per_s"] - 1979e12) <= 1e12
    assert PEAKS["tf32_tensor_flops_per_s"] == PEAKS["bf16_tensor_flops_per_s"] / 2
    assert abs(2 * PEAKS["tf32_tensor_flops_per_s"] - 989e12) <= 1e12
    # 128 FP32 lanes x 2 operations an FMA x 132 SMs x 1.98 GHz: the data sheet's 67 TFLOPS
    assert PEAKS["fp32_flops_per_s"] == 128 * 2 * 132 * 1.98e9
    assert round(PEAKS["fp32_flops_per_s"] / 1e12) == 67
    assert set(PEAKS["sources"]) == set(PEAKS) - {"device", "sources"}
