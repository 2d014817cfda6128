"""Packed corpus segments: width-aware token storage, exact by construction.

The port's copy of `repro.core.packing`. A PAD-padded int32 token matrix
pays 4 bytes a position for vocabularies that fit in 8–21 bits; every hop
that moves tokens (host to card, device memory to a CTA's shared memory,
checkpoint I/O) pays them. This module shrinks the bytes *moved* without
touching the bytes *written*:

    **pack on the producer, decode on the consumer, exact round-trip.**

Pack widths (chosen from the vocab size, ``mode="auto"``):

    ========  ======================  ==========================  =========
    mode      representable           storage                     bytes/tok
    ========  ======================  ==========================  =========
    ``u8``    vocab <= 255            ``uint8  [n, L]``           1
    ``u16``   vocab <= 65535          ``uint16 [n, L]``           2
    bitpack   bits(vocab) <= 31       ``int32  [n, G * bits]``    bits / 8
    ========  ======================  ==========================  =========

where ``bits = vocab.bit_length()`` (the sentinel below must fit too) and
``G = ceil(L / 32)``. Bitpack is *bit-plane* layout: positions are grouped
32 at a time along ``L``; group ``g`` stores ``bits`` int32 words, and bit
``t`` of word ``p`` is bit ``p`` of the token at position ``32 g + t``.
Positions past ``L`` in the last group are zeros. Decode is ``token =
sum_p ((word_p >> t) & 1) << p``, exact in integer arithmetic (an
arithmetic right shift plus ``& 1`` reads the right bit even from a
negative int32 word).

PAD handling: real tokens are ``0 .. vocab-1`` and `scoring.PAD_TOKEN` is
``-1``, which no unsigned width can hold, so pack maps PAD to the sentinel
``vocab`` (representable by construction: widths are chosen for ``vocab``,
not ``vocab - 1``) and unpack maps it back. ``unpack(pack(x)) == x`` for
every width, so scores downstream are the unpacked path's bit for bit.

The pack side is numpy, on the host (the producer); :func:`unpack_tokens`
is torch and runs on whatever device its tensor lies on. The lexical scan
kernel decodes packed tiles itself (``kernels/csrc/lexical_scan.cu``).
:class:`PackedCorpus` stands in for the ``(tokens, lengths)`` corpus tuple:
`pipeline.leaves` sees its two tensors in that order and `pipeline.tree_map`
rebuilds it with the same spec, so shard and segment slicing and the scan
job's fingerprint work on it unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.core.scoring import PAD_TOKEN

# knob values accepted by resolve_mode / TuningConfig.token_pack
PACK_MODES = ("none", "auto", "8", "16", "bitpack")
# storage layouts a PackSpec can carry ("none" never reaches a PackSpec)
_RESOLVED = ("u8", "u16", "bitpack")

_GROUP = 32  # positions per bit-plane group (one int32 word per plane)
_PACK_ROWS = 1 << 12  # rows packed at a time: temporaries near the cache's size
_PACK_THREADS = 8  # numpy releases the GIL in its loops: blocks pack in parallel

_TORCH_DTYPES = {"u8": torch.uint8, "u16": torch.uint16, "bitpack": torch.int32}


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static description of one packed token matrix.

    ``length`` is the *unpacked* L (the packed trailing dim is derived from
    it); ``bits`` is only meaningful for ``mode="bitpack"``.
    """

    mode: str  # u8 | u16 | bitpack
    vocab: int  # tokens are 0..vocab-1; `vocab` itself is the PAD sentinel
    length: int  # unpacked trailing dim L
    bits: int = 0  # bit-plane count (bitpack only)

    def __post_init__(self):
        if self.mode not in _RESOLVED:
            raise ValueError(f"unknown pack mode {self.mode!r}; expected {_RESOLVED}")
        if self.vocab < 1:
            raise ValueError(f"vocab must be >= 1, got {self.vocab}")
        if self.length < 0:
            raise ValueError(f"length must be >= 0, got {self.length}")
        if self.mode == "u8" and self.vocab > 0xFF:
            raise ValueError(f"u8 cannot hold sentinel {self.vocab}")
        if self.mode == "u16" and self.vocab > 0xFFFF:
            raise ValueError(f"u16 cannot hold sentinel {self.vocab}")
        if self.mode == "bitpack":
            need = int(self.vocab).bit_length()
            if not 1 <= need <= 31:
                raise ValueError(f"bitpack needs 1..31 bits, vocab {self.vocab}")
            if self.bits != need:
                raise ValueError(f"bits {self.bits} != bit_length(vocab) {need}")

    @property
    def packed_width(self) -> int:
        """Trailing dim of the packed matrix."""
        if self.mode == "bitpack":
            return -(-self.length // _GROUP) * self.bits
        return self.length

    def packed_dtype(self) -> np.dtype:
        return np.dtype(
            {"u8": np.uint8, "u16": np.uint16, "bitpack": np.int32}[self.mode]
        )

    def torch_dtype(self) -> torch.dtype:
        """The packed matrix's dtype as a tensor holds it."""
        return _TORCH_DTYPES[self.mode]

    def nbytes(self, n_docs: int) -> int:
        """Token bytes for ``n_docs`` packed rows (lengths excluded)."""
        return n_docs * self.packed_width * self.packed_dtype().itemsize

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def resolve_mode(vocab: int, mode: str) -> str:
    """Map a ``token_pack`` knob value to a storage layout for ``vocab``.

    ``"auto"`` picks the narrowest width that holds the sentinel ``vocab``:
    ``u8``, then ``u16``, then ``bitpack`` (only above 16 bits), then
    ``"none"`` for >=32-bit vocabs. A *forced* width the vocab cannot fit
    degrades to the auto choice rather than failing: knobs degrade, never
    fail.
    """
    if mode not in PACK_MODES:
        raise ValueError(f"unknown token_pack {mode!r}; expected one of {PACK_MODES}")
    if mode == "none":
        return "none"
    bits = int(vocab).bit_length()
    if mode == "8" and vocab <= 0xFF:
        return "u8"
    if mode == "16" and vocab <= 0xFFFF:
        return "u16"
    if mode == "bitpack" and bits <= 31:
        return "bitpack"
    # auto, or a forced width that can't represent the sentinel
    if vocab <= 0xFF:
        return "u8"
    if vocab <= 0xFFFF:
        return "u16"
    if bits <= 31:
        return "bitpack"
    return "none"


def make_spec(vocab: int, length: int, mode: str) -> PackSpec | None:
    """Resolve ``mode`` for ``vocab`` into a spec; ``None`` means unpacked."""
    resolved = resolve_mode(vocab, mode)
    if resolved == "none":
        return None
    bits = int(vocab).bit_length() if resolved == "bitpack" else 0
    return PackSpec(mode=resolved, vocab=int(vocab), length=int(length), bits=bits)


# the three masked swaps of an 8 x 8 bit-matrix transpose of a uint64
# (Hacker's Delight, 7-3): bit c of byte r moves to bit r of byte c
_TRANSPOSE8 = ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC), (28, 0x00000000F0F0F0F0))


def _transpose8(x: np.ndarray) -> np.ndarray:
    for shift, mask in _TRANSPOSE8:
        s, m = np.uint64(shift), np.uint64(mask)
        t = (x ^ (x >> s)) & m
        x = x ^ t ^ (t << s)
    return x


def _pack_rows(t: np.ndarray, spec: PackSpec) -> np.ndarray:
    """Pack one block of rows (validated, any integer dtype)."""
    mapped = np.where(t == PAD_TOKEN, spec.vocab, t).astype("<u4")
    if spec.mode == "u8":
        return mapped.astype(np.uint8)
    if spec.mode == "u16":
        return mapped.astype(np.uint16)
    n, l = mapped.shape
    groups = -(-l // _GROUP)
    padded = mapped
    if groups * _GROUP != l:
        padded = np.zeros((n, groups * _GROUP), "<u4")
        padded[:, :l] = mapped
    # bit-plane transpose: word p of group g collects bit p of its 32 tokens,
    # bit t from position 32 g + t (little bit order). Bit p of a token is
    # bit p % 8 of its byte k = p // 8: byte k of 8 tokens in a row makes a
    # uint64 whose bit transpose holds in its byte c the 8 bits of plane
    # 8 k + c, and 4 such bytes are a plane's word
    by = padded.view(np.uint8).reshape(n, groups, _GROUP, 4)
    words = np.empty((n, groups, spec.bits, 4), np.uint8)  # [.., plane, byte of the word]
    for k in range(-(-spec.bits // 8)):
        octets = np.ascontiguousarray(by[..., k]).view("<u8")  # [n, g, 4]: 8 tokens each
        planes = _transpose8(octets).view(np.uint8).reshape(n, groups, 4, 8)
        hi = min(8, spec.bits - 8 * k)
        words[:, :, 8 * k : 8 * k + hi] = planes[..., :hi].transpose(0, 1, 3, 2)
    return words.view("<u4").reshape(n, groups * spec.bits).view(np.int32)


def pack_tokens(tokens: Any, spec: PackSpec) -> np.ndarray:
    """Pack a PAD-padded int32 token matrix ``[n, L]`` under ``spec``.

    Host-side (numpy): packing happens on the producer, before staging.
    Validates the token range: values outside ``{PAD_TOKEN} | [0, vocab)``
    cannot round-trip and raise instead of corrupting silently. Blocks of
    ``_PACK_ROWS`` rows are packed by a few threads at once, so the
    temporaries stay small however large the corpus.
    """
    t = np.asarray(tokens)
    if t.ndim != 2 or t.shape[1] != spec.length:
        raise ValueError(f"tokens shape {t.shape} != [n, {spec.length}]")
    n = t.shape[0]
    out = np.empty((n, spec.packed_width), spec.packed_dtype())

    def pack_block(a: int) -> None:
        blk = t[a : a + _PACK_ROWS]
        # PAD_TOKEN is -1, the one value below 0 a row may hold: a block is
        # in range when its least value is at least -1 and its largest
        # below vocab (two reductions, no temporaries)
        if blk.size and (blk.min() < PAD_TOKEN or blk.max() >= spec.vocab):
            raise ValueError(
                f"tokens outside [0, {spec.vocab}) ∪ {{PAD_TOKEN}} cannot be packed"
            )
        out[a : a + _PACK_ROWS] = _pack_rows(blk, spec)

    starts = range(0, n, _PACK_ROWS)
    if len(starts) <= 1:
        for a in starts:
            pack_block(a)
        return out
    with ThreadPoolExecutor(min(_PACK_THREADS, os.cpu_count() or 1)) as pool:
        list(pool.map(pack_block, starts))  # re-raises a block's error
    return out


def unpack_tokens(packed: torch.Tensor, spec: PackSpec, *, pad_to: int | None = None):
    """Decode packed tokens back to PAD-padded int32 ``[n, pad_to or L]``.

    Torch, on the tensor's own device. ``pad_to`` > L appends PAD_TOKEN
    columns (the scan's ``tile_d`` alignment). Narrow widths are widened to
    int32 before any shift (the CPU has no ``>>`` on ``torch.uint16``), and
    bit-planes are read with an arithmetic shift on int32. Exact:
    ``unpack_tokens(pack_tokens(x, spec), spec) == x`` bit for bit.
    """
    l = spec.length
    if pad_to is None:
        pad_to = l
    if pad_to < l:
        raise ValueError(f"pad_to {pad_to} < unpacked length {l}")
    packed = torch.as_tensor(packed)
    n = packed.shape[0]
    if spec.mode in ("u8", "u16"):
        vals = packed.to(torch.int32)
    else:
        groups = -(-l // _GROUP) if l else 0
        words = packed.to(torch.int32).reshape(n, groups, spec.bits)
        # token t of group g: sum_p ((word[g, p] >> t) & 1) << p
        shifts = torch.arange(_GROUP, dtype=torch.int32, device=packed.device)
        vals = torch.zeros((n, groups, _GROUP), dtype=torch.int32, device=packed.device)
        for p in range(spec.bits):
            plane = (words[:, :, p : p + 1] >> shifts) & 1
            vals = vals + (plane << p)
        vals = vals.reshape(n, groups * _GROUP)[:, :l]
    toks = torch.where(vals == spec.vocab, PAD_TOKEN, vals)
    if pad_to > l:
        pad = torch.full((n, pad_to - l), PAD_TOKEN, dtype=torch.int32, device=toks.device)
        toks = torch.cat([toks, pad], dim=1)
    return toks


@dataclasses.dataclass
class PackedCorpus:
    """A packed token matrix + doc lengths + the spec that decodes it.

    Stands in for the ``(tokens, lengths)`` corpus tuple on the lexical scan
    paths: its leaves (`pipeline.leaves`) are ``tokens`` then ``lengths``,
    both with the corpus's leading dim, and `pipeline.tree_map` rebuilds it
    with the same spec. ``tokens``/``lengths`` are numpy arrays as
    :func:`pack_corpus` makes them, or tensors after :meth:`to`.
    """

    tokens: Any  # packed [n, W], dtype per spec
    lengths: Any  # [n] int32
    spec: PackSpec

    @property
    def n_docs(self) -> int:
        return self.tokens.shape[0]

    def unpack(self, *, pad_to: int | None = None):
        """Back to the plain ``(tokens, lengths)`` representation."""
        return unpack_tokens(self.tokens, self.spec, pad_to=pad_to), self.lengths

    def to(self, device) -> "PackedCorpus":
        """Both matrices as tensors on ``device`` (no copy where they are)."""
        return PackedCorpus(
            torch.as_tensor(self.tokens, device=device),
            torch.as_tensor(self.lengths, dtype=torch.int32, device=device),
            self.spec,
        )


def pack_corpus(tokens: Any, lengths: Any, *, vocab: int, mode: str = "auto"):
    """Pack a corpus under a ``token_pack`` knob value.

    Returns a :class:`PackedCorpus` of numpy arrays, or the plain ``(tokens,
    lengths)`` tuple when the resolved mode is ``"none"`` (so callers can
    pass the result straight to the scan either way).
    """
    t = np.asarray(tokens)
    spec = make_spec(vocab, t.shape[1] if t.ndim == 2 else 0, mode)
    if spec is None:
        return tokens, lengths
    return PackedCorpus(pack_tokens(t, spec), np.asarray(lengths, np.int32), spec)


def tree_nbytes(tree: Any) -> int:
    """Total array bytes across a corpus tree's arrays and tensors."""
    if isinstance(tree, PackedCorpus):
        return tree_nbytes((tree.tokens, tree.lengths))
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))
