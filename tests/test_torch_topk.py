"""The port's top-k combiner against the JAX reference, on tie-heavy data.

BM25 gives exactly 0 to every document without a query term, so ties are
the common case. ``topk.update`` must reproduce ``lax.top_k``'s positional
tie-break (a stable sort does; a bare ``torch.topk`` promises no order on
ties), and the lexicographic merges must equal the reference's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.core import topk as ref_topk
from repro.kernels import score_topk as ref_score_topk
from repro_torch.core import topk
from repro_torch.kernels import score_topk

# the reference's merges, compiled once per shape (eager dispatch of the
# bitonic network op by op would dominate the test's time)
REF_BITONIC = jax.jit(ref_score_topk.bitonic_merge_desc)
REF_MERGE_LEX = jax.jit(ref_topk.merge_lex)
REF_REDUCE_LEX = jax.jit(ref_topk.reduce_lex)

PALETTE = np.array([-np.inf, 0.0, 0.5, 1.0, 2.25], np.float32)  # exact, tie-heavy


def _lex_sorted(rng, lead, m, id_pool):
    """Lists sorted by (score desc, id asc) with distinct ids, (-inf, -1) pads."""
    s = rng.choice(PALETTE[1:], size=(*lead, m)).astype(np.float32)
    ids = np.stack([rng.choice(id_pool, size=m, replace=False) for _ in range(int(np.prod(lead)))])
    ids = ids.reshape(*lead, m).astype(np.int32)
    order = np.lexsort((ids, -s), axis=-1)
    s = np.take_along_axis(s, order, -1)
    ids = np.take_along_axis(ids, order, -1)
    n_pad = rng.integers(0, m + 1)
    if n_pad:
        s[..., m - n_pad :] = -np.inf
        ids[..., m - n_pad :] = -1
    return s, ids


def _ref_state(s, i):
    return ref_topk.TopKState(jnp.asarray(s), jnp.asarray(i))


def _port_state(s, i):
    return topk.TopKState(torch.tensor(s), torch.tensor(i))


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.ids.numpy(), np.asarray(ref.ids))
    assert port.scores.numpy().tobytes() == np.asarray(ref.scores).tobytes()


@pytest.mark.parametrize("k", [1, 5, 16, 37])
def test_update_matches_lax_top_k_on_bm25_ties(k):
    rng = np.random.default_rng(k)
    ref = ref_topk.init(k, (3, 4))
    port = topk.init(k, (3, 4))
    for start in range(0, 240, 60):
        # mostly exact zeros, a few matches, some zero-length rows (-inf)
        s = np.where(rng.random((3, 4, 60)) < 0.8, 0.0, rng.choice(PALETTE, (3, 4, 60)))
        s = s.astype(np.float32)
        ids = np.broadcast_to(np.arange(start, start + 60, dtype=np.int32), s.shape)
        ref = ref_topk.update(ref, jnp.asarray(s), jnp.asarray(ids))
        port = topk.update(port, torch.tensor(s), torch.tensor(np.ascontiguousarray(ids)))
        _assert_same(port, ref)


def test_init_and_valid_mask():
    st0 = topk.init(4, (2,))
    assert st0.k == 4 and st0.ids.dtype == torch.int32
    assert not topk.valid_mask(st0).any()
    h = topk.init_host(4, (2,))
    assert h.scores.dtype == np.float32 and (h.ids == -1).all()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000), log_m=st.integers(0, 4))
def test_bitonic_merge_matches_reference(seed, log_m):
    rng = np.random.default_rng(seed)
    m = 1 << log_m
    pool = np.arange(4 * m + 8)
    a_s, a_i = _lex_sorted(rng, (3,), m, pool[: 2 * m + 4])
    b_s, b_i = _lex_sorted(rng, (3,), m, pool[2 * m + 4 :])
    want = REF_BITONIC(
        jnp.asarray(a_s), jnp.asarray(a_i), jnp.asarray(b_s), jnp.asarray(b_i)
    )
    got = score_topk.bitonic_merge_desc(
        torch.tensor(a_s), torch.tensor(a_i), torch.tensor(b_s), torch.tensor(b_i)
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.sampled_from([1, 3, 8, 23]), n_states=st.integers(1, 4))
def test_merge_lex_and_reduce_lex_match_reference(seed, k, n_states):
    rng = np.random.default_rng(seed)
    pool = rng.permutation(n_states * k * 3 + 10)
    chunks = np.array_split(pool, n_states)
    states = [_lex_sorted(rng, (2, 3), k, c) for c in chunks]
    ref = REF_REDUCE_LEX([_ref_state(s, i) for s, i in states])
    port = topk.reduce_lex([_port_state(s, i) for s, i in states])
    _assert_same(port, ref)
    if n_states >= 2:
        a, b = states[0], states[1]
        _assert_same(
            topk.merge_lex(_port_state(*a), _port_state(*b)),
            REF_MERGE_LEX(_ref_state(*a), _ref_state(*b)),
        )


def test_merge_rejects_bad_inputs():
    a = topk.init(4, (2,))
    with pytest.raises(ValueError, match="shape mismatch"):
        topk.merge_lex(a, topk.init(4, (3,)))
    with pytest.raises(ValueError, match="at least one"):
        topk.reduce_lex([])
    with pytest.raises(ValueError, match="power-of-two"):
        score_topk.bitonic_merge_desc(a.scores[:, :3], a.ids[:, :3], a.scores[:, :3], a.ids[:, :3])


def test_topk_dense_positional_ties():
    s = np.array([[0.0, 1.0, 0.0, 1.0, 0.0]], np.float32)
    want = ref_topk.topk_dense(jnp.asarray(s), 3)
    got = topk.topk_dense(torch.tensor(s), 3)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
