"""Shared comparison rule for the port's float results against the JAX
reference (imported by the ``test_torch_*`` files).

Scores agree within 1e-5 (libm ``log``/``log1p`` differ in the last place
between XLA and torch); ids agree exactly, except where the reference's own
scores at that rank lie within 1e-5 of a neighbour's — a float near-tie the
last-place difference may order either way. Such places are named in the
assertion message.
"""

from __future__ import annotations

import numpy as np

TOL = 1e-5


def assert_rankings_close(got_s, got_i, want_s, want_i, *, what: str = "") -> list:
    """Check ``[..., k]`` (scores, ids) rankings; returns the near-tie places
    where the ids differ (empty when they match exactly)."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    assert got_s.shape == want_s.shape and got_i.shape == want_i.shape, what
    np.testing.assert_array_equal(np.isneginf(got_s), np.isneginf(want_s), err_msg=what)
    finite = np.isfinite(want_s)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=TOL, atol=TOL, err_msg=what)
    near = np.zeros(want_s.shape, bool)
    with np.errstate(invalid="ignore"):  # -inf - -inf in empty tails
        gap = np.abs(np.diff(want_s, axis=-1)) <= TOL * np.maximum(1.0, np.abs(want_s[..., 1:]))
    gap &= np.isfinite(want_s[..., 1:])
    near[..., 1:] |= gap
    near[..., :-1] |= gap
    differ = got_i != want_i
    bad = np.argwhere(differ & ~near)
    assert bad.size == 0, (
        f"{what}: ids differ at {bad[:5].tolist()} with no near-tie in the reference's scores"
    )
    return np.argwhere(differ).tolist()
