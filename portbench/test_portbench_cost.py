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
