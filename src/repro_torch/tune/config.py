"""The frozen config the port's performance knobs live in.

The port's copy of `repro.tune.config`, with the knobs the port reads: the
fold's ``chunk_size``, the pipelined executor's ``prefetch_depth``,
``max_workers``, ``cross_shard_prefetch`` and ``writer_reuse``, the
checkpoints kept on disk, the scheduler's retry backoff
(``backoff_base``/``backoff_cap``), the lexical kernel's
``lex_block_d``/``lex_tile_d``, ``token_pack`` (packed corpus segments,
`repro_torch.core.packing`: read by the runner and the lexical session),
the dense kernel's ``dense_block_d``, the serve microbatch triggers
(``serve_max_batch``, ``serve_max_delay_s``, ``serve_min_bucket``,
``serve_max_bucket``) and the flash kernels' tiles (``flash_block_q``,
``flash_block_k``, ``decode_block_s``). The knob table is the
reference's, so a config's ``config_hash`` is the reference's for the same
knobs. Defaults reproduce the hand-picked values, so ``TuningConfig()`` is
the identity config, and the contract is the reference's:

    **tuning changes speed, never bytes.**

The block/tile knobs only regroup the value-deterministic top-k merges,
the tf reduction accumulates in int32, and the executor's knobs reorder
work that commutes, so run files under any legal config are byte-identical
to the default-config run.

Code paths accept an explicit ``tuning=`` argument and fall back to the
process-wide active config (:func:`active` / the :func:`use` context
manager).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import threading
from typing import Any, Iterator

# Bump when knobs are added/removed/re-meaning-ed.
SPACE_VERSION = 3

# legal token_pack values (the reference's packing.PACK_MODES)
_TOKEN_PACK_MODES = ("none", "auto", "8", "16", "bitpack")


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    """The port's knobs, one frozen record. Defaults == the hand-picked
    values, so ``TuningConfig()`` is the identity config.

    ``None`` on the geometry knobs means "follow the caller": ``chunk_size``
    defers to the experiment/job's declared chunking, ``lex_block_d`` /
    ``dense_block_d`` follow ``chunk_size`` on the scan paths (the kernels'
    own defaults, 512 / 1024, on direct calls) and ``max_workers`` defers
    to one worker per device. ``serve_max_bucket=None``
    means an uncapped bucket ladder (its default is a cap, 128; capping only
    regroups dispatches, so results stay byte-identical).
    """

    chunk_size: int | None = None  # rows per fold chunk; None = caller's
    prefetch_depth: int = 2  # staged segments ahead of the fold
    max_workers: int | None = None  # shard pool cap; None = per device
    cross_shard_prefetch: bool = True  # stage next shard's first segment
    writer_reuse: bool = False  # share the async ckpt writer per worker
    keep_checkpoints: int = 2  # committed segments kept on disk
    backoff_base: float = 0.1  # scheduler retry pacing
    backoff_cap: float = 5.0
    lex_block_d: int | None = None  # doc tile; None = chunk_size / 512
    lex_tile_d: int = 16  # L_d sub-tile of the tf reduction
    dense_block_d: int | None = None  # doc tile; None = chunk_size / 1024
    serve_max_batch: int = 64
    serve_max_delay_s: float = 5e-3
    serve_min_bucket: int = 8
    # bucket-ladder cap: blocks never pad past it, and larger takes split
    # into <= cap dispatches; None = uncapped
    serve_max_bucket: int | None = 128
    # packed corpus segments (core.packing): "none" keeps int32 tokens,
    # "auto" the narrowest width the vocab fits, "8"/"16"/"bitpack" force one
    token_pack: str = "none"
    flash_block_q: int = 128  # flash attention query tile
    flash_block_k: int = 128  # flash attention key/value tile
    decode_block_s: int = 512  # cache positions per split-KV decode CTA

    def __post_init__(self):
        for name in ("chunk_size", "lex_block_d", "dense_block_d", "max_workers",
                     "serve_max_bucket"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be a positive int or None, got {v!r}")
        for name in ("prefetch_depth", "keep_checkpoints", "lex_tile_d", "serve_max_batch",
                     "serve_min_bucket", "flash_block_q", "flash_block_k", "decode_block_s"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        for name in ("backoff_base", "backoff_cap", "serve_max_delay_s"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or v < 0:
                raise ValueError(f"{name} must be a non-negative number, got {v!r}")
        if self.token_pack not in _TOKEN_PACK_MODES:
            raise ValueError(
                f"token_pack must be one of {_TOKEN_PACK_MODES}, "
                f"got {self.token_pack!r}"
            )
        if self.serve_max_bucket is not None and self.serve_max_bucket < self.serve_min_bucket:
            raise ValueError(
                f"serve_max_bucket {self.serve_max_bucket} below "
                f"serve_min_bucket {self.serve_min_bucket}"
            )

    def replace(self, **kw: Any) -> "TuningConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> dict:
        """JSON-able full knob table (report payloads)."""
        return dataclasses.asdict(self)

    def overrides(self) -> dict:
        """Only the knobs that differ from the defaults ('{}' literally means
        'the hand-picked configuration')."""
        base = DEFAULT.describe()
        return {k: v for k, v in self.describe().items() if v != base[k]}

    @classmethod
    def from_dict(cls, d: dict, *, strict: bool = True) -> "TuningConfig":
        """Build from a (possibly partial) knob dict, such as one the
        reference's ``tune.save`` wrote. ``strict`` rejects unknown knob
        names — the stale-cache guard: an entry recorded under a different
        knob space must not half-apply; otherwise they are left out."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown and strict:
            raise ValueError(f"unknown tuning knobs {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in fields})

    def config_hash(self) -> str:
        """Short content hash of (knob space version, full knob table),
        stamped into report.json."""
        payload = json.dumps(
            {"space_version": SPACE_VERSION, "config": self.describe()},
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def scan_chunk(self, declared: int, *, n_docs: int, n_shards: int) -> int:
        """The scan fold's chunk: the tuned ``chunk_size`` where it cuts
        every shard into whole chunks (the plan's rule), else the declared
        one — a knob may be ignored, never fail a job."""
        shards = max(1, n_shards)
        if (self.chunk_size is not None and n_docs % shards == 0
                and (n_docs // shards) % self.chunk_size == 0):
            return self.chunk_size
        return declared

    def lex_block(self, chunk_size: int, n_rows: int | None = None) -> int:
        """Lexical-kernel doc tile for a scan over ``chunk_size`` chunks.

        ``None`` follows the chunk; an explicit block that doesn't divide
        the shard falls back to the chunk, as in the reference (byte-identical
        either way: block size only regroups the combiner fold).
        """
        block = self.lex_block_d if self.lex_block_d is not None else chunk_size
        if n_rows is not None and n_rows % block:
            block = chunk_size
        return block

    def dense_block(self, chunk_size: int, n_rows: int | None = None) -> int:
        """Dense-kernel doc tile; same rules as :meth:`lex_block`."""
        block = self.dense_block_d if self.dense_block_d is not None else chunk_size
        if n_rows is not None and n_rows % block:
            block = chunk_size
        return block


DEFAULT = TuningConfig()


@dataclasses.dataclass(frozen=True)
class ActiveTuning:
    """The installed config plus where it came from (default | explicit |
    file | cache | search) and whether a winner-cache lookup hit."""

    config: TuningConfig = DEFAULT
    source: str = "default"
    cache_hit: bool = False

    def provenance(self) -> dict:
        return {
            "config_hash": self.config.config_hash(),
            "source": self.source,
            "cache_hit": self.cache_hit,
        }


_LOCK = threading.Lock()
_active = ActiveTuning()


def active() -> ActiveTuning:
    """The process-wide active tuning (never None; defaults when unset)."""
    return _active


def _install(record: ActiveTuning) -> ActiveTuning:
    global _active
    with _LOCK:
        prev, _active = _active, record
    return prev


def set_active(
    config: TuningConfig | None,
    *,
    source: str = "explicit",
    cache_hit: bool = False,
) -> ActiveTuning:
    """Install ``config`` as the process-wide active tuning; returns the
    *previous* record so callers can restore it. ``None`` restores defaults."""
    return _install(ActiveTuning() if config is None else ActiveTuning(config, source, cache_hit))


@contextlib.contextmanager
def use(
    config: TuningConfig | None,
    *,
    source: str = "explicit",
    cache_hit: bool = False,
) -> Iterator[ActiveTuning]:
    """Scoped :func:`set_active` (``None`` installs the defaults): the
    tuning search measures every candidate under ``with use(candidate)``
    and leaks nothing. A module global, not thread-local, as in the
    reference."""
    prev = set_active(config, source=source, cache_hit=cache_hit)
    try:
        yield active()
    finally:
        _install(prev)


def provenance() -> dict:
    """The active config's provenance block (benchmarks stamp this)."""
    return _active.provenance()


def resolve(tuning: TuningConfig | None) -> TuningConfig:
    """Explicit argument wins; otherwise the active config. The standard
    first line of every ``tuning=``-threaded code path."""
    return tuning if tuning is not None else _active.config


def save(config: TuningConfig, path: str) -> str:
    """Write a config as JSON (the ``--tuning-config`` file format: a flat
    knob dict; missing knobs mean 'default')."""
    with open(path, "w") as f:
        json.dump(config.describe(), f, indent=2)
        f.write("\n")
    return path


def load(path: str) -> TuningConfig:
    """Read a ``--tuning-config`` JSON file (flat knob dict)."""
    with open(path) as f:
        return TuningConfig.from_dict(json.load(f))
