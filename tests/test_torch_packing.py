"""The port's packed corpus segments against the JAX reference's, on the CPU.

The same seeded numpy token matrices go through both packages'
`core.packing`: the packed bytes must be identical for every mode and vocab
class, the port's torch unpack must equal the reference's (jnp) on the same
packed array, and the mode resolution must agree over a sweep. Decode is
integer arithmetic, so every comparison here is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing
from repro_torch.core import packing, pipeline

VOCABS = [1, 255, 256, 2048, 65_535, 65_536, 200_000, 2**30]
LENGTHS = [1, 23, 32, 128, 300]


def _tokens(seed, n, length, vocab, pad_share=0.3):
    """Seeded tokens in [0, vocab) with a PAD tail of random length per row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(n, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, size=n)
    lens[rng.random(n) > pad_share] = length
    toks[np.arange(length)[None, :] >= lens[:, None]] = packing.PAD_TOKEN
    return toks, lens.astype(np.int32)


@pytest.mark.parametrize("mode", packing.PACK_MODES)
@pytest.mark.parametrize("vocab", VOCABS)
def test_pack_tokens_is_the_references_bytes(vocab, mode):
    for seed, length in enumerate(LENGTHS):
        toks, _ = _tokens(seed, 37, length, vocab)
        spec = packing.make_spec(vocab, length, mode)
        ref_spec = ref_packing.make_spec(vocab, length, mode)
        assert (spec is None) == (ref_spec is None)
        if spec is None:
            continue
        assert spec.describe() == ref_spec.describe()
        assert spec.packed_width == ref_spec.packed_width
        assert spec.nbytes(37) == ref_spec.nbytes(37)
        got, want = packing.pack_tokens(toks, spec), ref_packing.pack_tokens(toks, ref_spec)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (vocab, length, mode)


@pytest.mark.parametrize("pad_to", [None, 7])
@pytest.mark.parametrize("mode", ["8", "16", "bitpack"])
@pytest.mark.parametrize("vocab", [1, 255, 2048, 65_536, 200_000])
def test_unpack_tokens_matches_the_reference(vocab, mode, pad_to):
    for seed, length in enumerate(LENGTHS):
        toks, _ = _tokens(100 + seed, 29, length, vocab)
        ref_spec = ref_packing.make_spec(vocab, length, mode)
        spec = packing.make_spec(vocab, length, mode)
        packed = ref_packing.pack_tokens(toks, ref_spec)
        extra = None if pad_to is None else length + pad_to
        want = np.asarray(ref_packing.unpack_tokens(jnp.asarray(packed), ref_spec, pad_to=extra))
        got = packing.unpack_tokens(torch.as_tensor(packed), spec, pad_to=extra)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the round trip is exact: the PAD sentinel maps back
        np.testing.assert_array_equal(got.numpy()[:, :length], toks)


def test_resolve_mode_and_make_spec_agree_with_the_reference():
    vocabs = sorted({1, 2, 3, 254, 255, 256, 257, 4095, 65_534, 65_535, 65_536, 65_537,
                     131_071, 131_072, 2**24, 2**30, 2**31 - 1, 2**31, 2**32, *VOCABS})
    for vocab in vocabs:
        for mode in packing.PACK_MODES:
            assert packing.resolve_mode(vocab, mode) == ref_packing.resolve_mode(vocab, mode)
            got, want = packing.make_spec(vocab, 23, mode), ref_packing.make_spec(vocab, 23, mode)
            assert (got and got.describe()) == (want and want.describe()), (vocab, mode)
    # a forced width the vocab cannot fit degrades to the auto choice
    assert packing.resolve_mode(300, "8") == "u16"
    assert packing.resolve_mode(70_000, "16") == "bitpack"
    assert packing.resolve_mode(2**31, "bitpack") == "none"
    with pytest.raises(ValueError, match="unknown token_pack"):
        packing.resolve_mode(10, "4")
    with pytest.raises(ValueError, match="u8 cannot hold sentinel 256"):
        packing.PackSpec("u8", 256, 4)
    with pytest.raises(ValueError, match="bits 3 != bit_length"):
        packing.PackSpec("bitpack", 100, 4, bits=3)


def test_out_of_range_tokens_raise():
    spec = packing.make_spec(50, 8, "auto")
    ref_spec = ref_packing.make_spec(50, 8, "auto")
    for bad in (50, -2, 1 << 20):
        toks, _ = _tokens(3, 5, 8, 50)
        toks[2, 1] = bad
        with pytest.raises(ValueError, match=r"outside \[0, 50\)") as got:
            packing.pack_tokens(toks, spec)
        with pytest.raises(ValueError) as want:
            ref_packing.pack_tokens(toks, ref_spec)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"tokens shape \(5, 7\) != \[n, 8\]"):
        packing.pack_tokens(np.zeros((5, 7), np.int32), spec)
    with pytest.raises(ValueError, match="pad_to 3 < unpacked length 8"):
        packing.unpack_tokens(torch.zeros((5, 8), dtype=torch.uint8), spec, pad_to=3)


@pytest.mark.parametrize("dtype, bad", [
    (np.int32, 65_536), (np.int32, -2), (np.int64, 1 << 40), (np.uint32, (1 << 32) - 1),
    (np.int16, -32_768)])
def test_out_of_range_bitpack_tokens_of_any_integer_dtype_raise(dtype, bad):
    """The range check of a block (its least and largest value) refuses what
    the reference refuses, in any integer dtype; the in-range tokens of that
    dtype pack to the reference's bytes."""
    vocab = 65_536 if dtype != np.int16 else 20_000
    spec, ref_spec = packing.make_spec(vocab, 40, "bitpack"), ref_packing.make_spec(vocab, 40,
                                                                                   "bitpack")
    toks, _ = _tokens(7, 6, 40, vocab)
    if np.iinfo(dtype).min == 0:
        toks[toks == packing.PAD_TOKEN] = 0  # an unsigned matrix holds no PAD
    toks = toks.astype(dtype)
    assert packing.pack_tokens(toks, spec).tobytes() == np.asarray(
        ref_packing.pack_tokens(toks, ref_spec)).tobytes()
    toks[4, 3] = bad
    with pytest.raises(ValueError, match=rf"outside \[0, {vocab}\)") as got:
        packing.pack_tokens(toks, spec)
    with pytest.raises(ValueError) as want:
        ref_packing.pack_tokens(toks, ref_spec)
    assert str(got.value) == str(want.value)


def test_bitpack_zero_padding_past_the_length_is_dropped():
    """Bit-planes pad the last group of 32 with zeros, and 0 is a real term:
    decode must stop at L."""
    toks = np.full((3, 23), packing.PAD_TOKEN, np.int32)
    toks[:, :5] = 7
    spec = packing.make_spec(1000, 23, "bitpack")
    packed = packing.pack_tokens(toks, spec)
    assert packed.shape == (3, spec.bits)  # one group of 32 positions
    # the planes of positions 23..31 are zero: their tokens would read 0
    words = packed.view(np.uint32)
    assert not (words >> np.uint32(23)).any()
    got = packing.unpack_tokens(torch.as_tensor(packed), spec, pad_to=32)
    assert got.shape == (3, 32)
    assert (got[:, :5] == 7).all() and (got[:, 5:] == packing.PAD_TOKEN).all()
    assert not (got == 0).any()


def test_many_blocks_pack_as_one():
    """A corpus of several packing blocks (packed in parallel) gives the
    reference's bytes, and a bad token in a late block still raises."""
    n = 2 * packing._PACK_ROWS + 5
    toks, _ = _tokens(4, n, 23, 70_000)
    spec = packing.make_spec(70_000, 23, "auto")
    got = packing.pack_tokens(toks, spec)
    assert got.tobytes() == ref_packing.pack_tokens(toks, ref_packing.make_spec(70_000, 23, "auto")).tobytes()
    toks[n - 1, 0] = 70_000
    with pytest.raises(ValueError, match="cannot be packed"):
        packing.pack_tokens(toks, spec)


def test_packed_corpus_is_a_corpus_tree():
    toks, lens = _tokens(5, 64, 40, 300)
    packed = packing.pack_corpus(toks, lens, vocab=300, mode="auto")
    ref = ref_packing.pack_corpus(toks, lens, vocab=300, mode="auto")
    assert isinstance(packed, packing.PackedCorpus) and packed.spec.mode == "u16"
    assert packed.spec.describe() == ref.spec.describe() and packed.n_docs == 64
    assert packing.tree_nbytes(packed) == ref_packing.tree_nbytes(ref) == 64 * 40 * 2 + 64 * 4
    on = packed.to("cpu")
    assert on.tokens.dtype == torch.uint16 and on.lengths.dtype == torch.int32
    assert packing.tree_nbytes(on) == packing.tree_nbytes(packed)
    # leaves in the reference's pytree order; tree_map keeps the spec
    assert [x.shape for x in pipeline.leaves(on)] == [(64, 40), (64,)]
    half = pipeline.tree_map(lambda x: x[8:24], on)
    assert isinstance(half, packing.PackedCorpus) and half.spec == on.spec and half.n_docs == 16
    t, l = half.unpack()
    assert torch.equal(t, torch.as_tensor(toks[8:24])) and torch.equal(l, torch.as_tensor(lens[8:24]))
    padded = pipeline.pad_leading(on, 80, packing.PackedCorpus(packed.spec.vocab, 0, on.spec))
    assert padded.n_docs == 80 and (padded.unpack()[0][64:] == packing.PAD_TOKEN).all()
    # "none" hands the plain tuple back
    plain = packing.pack_corpus(toks, lens, vocab=300, mode="none")
    assert isinstance(plain, tuple) and plain[0] is toks
