"""Shared comparison rule for the port's float results against the JAX
reference (imported by the ``test_torch_*`` files).

Scores agree within 1e-5 (libm ``log``/``log1p`` differ in the last place
between XLA and torch); ids agree exactly, except where the reference's own
scores at that rank lie within 1e-5 of a neighbour's — a float near-tie the
last-place difference may order either way. Such places are named in the
assertion message.

A reference ranking deeper than the one checked (``k + extra`` places for
``k``) also shows the neighbours past the k-th place, so a near-tie across
the cut — the port keeps the (k+1)-th document in place of a k-th that
scores within 1e-5 of it — is seen as one too. The first ``k`` places are
compared.
"""

from __future__ import annotations

import numpy as np

TOL = 1e-5


def assert_rankings_close(got_s, got_i, want_s, want_i, *, what: str = "",
                          tol: float = TOL) -> list:
    """Check ``[..., k]`` (scores, ids) rankings against a reference ranking
    of ``k`` or more places; returns the near-tie places where the ids
    differ (empty when they match exactly). ``tol`` bounds the score
    difference and the width of a near-tie."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    k = got_s.shape[-1]
    assert got_s.shape[:-1] == want_s.shape[:-1] and want_s.shape[-1] >= k, what
    assert got_i.shape == got_s.shape and want_i.shape == want_s.shape, what
    near = np.zeros(want_s.shape, bool)
    with np.errstate(invalid="ignore"):  # -inf - -inf in empty tails
        gap = np.abs(np.diff(want_s, axis=-1)) <= tol * np.maximum(1.0, np.abs(want_s[..., 1:]))
    gap &= np.isfinite(want_s[..., 1:])
    near[..., 1:] |= gap
    near[..., :-1] |= gap
    want_s, want_i, near = want_s[..., :k], want_i[..., :k], near[..., :k]
    np.testing.assert_array_equal(np.isneginf(got_s), np.isneginf(want_s), err_msg=what)
    finite = np.isfinite(want_s)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=tol, atol=tol, err_msg=what)
    differ = got_i != want_i
    bad = np.argwhere(differ & ~near)
    assert bad.size == 0, (
        f"{what}: ids differ at {bad[:5].tolist()} with no near-tie in the reference's scores"
    )
    return np.argwhere(differ).tolist()
