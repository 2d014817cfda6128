"""The anchor-text job of the port against the JAX reference, on the CPU.

`synthetic.make_links` must give the reference's link graph byte for byte,
and `anchors.extract_anchors` the reference's anchor rows and lengths byte
for byte, dtypes included (tolerance: none — integer work), on edge cases:
no links, one link, overflow past ``max_anchor_len``, a ``max_anchor_len``
that is not a multiple of the anchor length, all-PAD anchors, destinations
outside ``[0, n_docs)`` (negative ones counting from the end, as the
reference's indexing does, the others dropped) and the reference test's own
case. The card's run is held to the CPU's in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anchors as ref_anchors
from repro.data import synthetic as ref_synthetic
from repro_torch.core import anchors
from repro_torch.data import synthetic


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize(
    "n_docs, n_links, vocab, max_anchor_len, seed",
    [(10, 0, 5, 6, 3), (7, 1, 3, 1, 0), (32, 100, 500, 6, 6), (2048, 8192, 4096, 6, 1),
     (1000, 5000, 65_536, 4, 9), (1 << 14, 1 << 16, 65_536, 6, 3)],
)
def test_make_links_is_the_references(n_docs, n_links, vocab, max_anchor_len, seed):
    kw = dict(n_docs=n_docs, n_links=n_links, vocab=vocab, max_anchor_len=max_anchor_len,
              seed=seed)
    for got, want in zip(synthetic.make_links(**kw), ref_synthetic.make_links(**kw)):
        _same(got, want)


def _both(dst, toks, n_docs, max_anchor_len):
    dst, toks = np.asarray(dst, np.int32), np.asarray(toks)
    want = ref_anchors.extract_anchors(jnp.asarray(dst), jnp.asarray(toks), n_docs=n_docs,
                                       max_anchor_len=max_anchor_len)
    got = anchors.extract_anchors(torch.as_tensor(dst), torch.as_tensor(toks), n_docs=n_docs,
                                  max_anchor_len=max_anchor_len)
    _same(got[0].numpy(), want[0])
    _same(got[1].numpy(), want[1])
    return got[0].numpy(), got[1].numpy()


def _links(seed, n_docs, n_links, l_a, vocab=50, n_pad_anchors=0):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_docs, n_links).astype(np.int32)
    toks = rng.integers(0, vocab, (n_links, l_a)).astype(np.int32)
    toks[np.arange(l_a)[None, :] >= rng.integers(1, l_a + 1, n_links)[:, None]] = -1
    toks[:n_pad_anchors] = -1
    return dst, toks


CASES = {
    "no_links": (np.zeros(0), np.zeros((0, 3)), 3, 4),
    "one_link": (np.array([2]), np.array([[5, 6, -1]]), 4, 8),
    "overflow": (*_links(1, 4, 40, 3), 4, 9),
    "not_a_multiple_of_L_a": (*_links(2, 8, 30, 4), 8, 10),
    "all_pad_anchors": (*_links(3, 6, 12, 3, n_pad_anchors=12), 6, 9),
    "some_pad_anchors": (*_links(4, 6, 24, 3, n_pad_anchors=7), 6, 12),
    "dst_out_of_range": (np.array([3, -1, 1, 5, -5, -4, 3, 0, 7, -2]),
                         np.arange(1, 31).reshape(10, 3), 4, 7),
    "negative_dst_wraps": (np.array([-1, -3, 0]), np.array([[5, 6], [7, 8], [9, -1]]), 4, 4),
    # a page reached by a wrapped negative id and by its own id: its own
    # group's tokens win where both write
    "negative_dst_collides": (np.array([-1, -1, 3]),
                              np.array([[5, 6], [9, 10], [7, -1]]), 4, 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_anchors_is_the_references(case):
    dst, toks, n_docs, max_anchor_len = CASES[case]
    out, lens = _both(dst, np.asarray(toks, np.int32), n_docs, max_anchor_len)
    assert lens.dtype == np.int32 and out.shape == (n_docs, max_anchor_len)
    if case == "negative_dst_wraps":
        assert out[3, :2].tolist() == [5, 6] and out[1, :2].tolist() == [7, 8]
    if case == "negative_dst_collides":
        assert out[3].tolist() == [7, 6, 9, 10, -1, -1]
    if case in ("no_links", "all_pad_anchors"):
        assert (out == -1).all() and (lens == 0).all()


def test_extract_anchors_keeps_the_token_dtype():
    dst, toks = _links(5, 8, 40, 3)
    out, lens = _both(dst, toks.astype(np.int16), 8, 12)
    assert out.dtype == np.int16 and lens.dtype == np.int32


@pytest.mark.parametrize("max_anchor_len", [48, 64, 7])
def test_extract_anchors_on_a_link_graph(max_anchor_len):
    """The reference test's own case (`tests/test_scoring.py`), then a
    larger graph from `make_links`."""
    dst, toks = synthetic.make_links(n_docs=32, n_links=100, vocab=500, seed=6)
    out, lens = _both(dst, toks, 32, max_anchor_len)
    for d in range(32):  # every token of row d comes from an anchor pointing at d
        pool = toks[dst == d]
        assert set(out[d][out[d] >= 0].tolist()) <= set(pool[pool >= 0].tolist())
    assert int(lens.sum()) > 0
    dst, toks = synthetic.make_links(n_docs=4096, n_links=1 << 15, vocab=4096, seed=1)
    _both(dst, toks, 4096, max_anchor_len)
