"""The frozen config the port's performance knobs live in.

The port's copy of `repro.tune.config`, cut down to the knobs the ported
slices read: the fold's ``chunk_size``, the checkpoints kept on disk, the
lexical kernel's ``lex_block_d``/``lex_tile_d``, ``token_pack`` (only
``"none"`` runs; the runner and the lexical session refuse the others until
the packing slice), the dense kernel's ``dense_block_d`` and the serve
microbatch triggers (``serve_max_batch``, ``serve_max_delay_s``,
``serve_min_bucket``, ``serve_max_bucket``).
Defaults reproduce the hand-picked values, so ``TuningConfig()`` is the
identity config, and the contract is the reference's:

    **tuning changes speed, never bytes.**

The block/tile knobs only regroup the value-deterministic top-k merges and
the tf reduction accumulates in int32, so run files under any legal config
are byte-identical to the default-config run.

The reference's other knobs (prefetch, workers, writer reuse, retry
backoff, the flash kernels' blocks) wait for the slices
that read them. :meth:`TuningConfig.from_dict` (and so ``--tuning-config``)
accepts such a knob only at the reference's default value, which changes
nothing, and raises ``NotImplementedError`` for any other value.

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

# the reference's knobs that no code of this slice reads: (default, slice)
_LATER_KNOBS = {
    "prefetch_depth": (2, "executor"),
    "max_workers": (None, "executor"),
    "cross_shard_prefetch": (True, "executor"),
    "writer_reuse": (False, "executor"),
    "backoff_base": (0.1, "executor"),
    "backoff_cap": (5.0, "executor"),
    "flash_block_q": (128, "models"),
    "flash_block_k": (128, "models"),
    "decode_block_s": (512, "models"),
}


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    """The knobs of this slice, one frozen record. Defaults == the
    hand-picked values, so ``TuningConfig()`` is the identity config.

    ``None`` on the geometry knobs means "follow the caller": ``chunk_size``
    defers to the experiment/job's declared chunking and ``lex_block_d`` /
    ``dense_block_d`` follow ``chunk_size`` on the scan paths (the kernels'
    own defaults, 512 / 1024, on direct calls). ``serve_max_bucket=None``
    means an uncapped bucket ladder (its default is a cap, 128; capping only
    regroups dispatches, so results stay byte-identical).
    """

    chunk_size: int | None = None  # rows per fold chunk; None = caller's
    keep_checkpoints: int = 2  # committed segments kept on disk
    lex_block_d: int | None = None  # doc tile; None = chunk_size / 512
    lex_tile_d: int = 16  # L_d sub-tile of the tf reduction
    dense_block_d: int | None = None  # doc tile; None = chunk_size / 1024
    serve_max_batch: int = 64
    serve_max_delay_s: float = 5e-3
    serve_min_bucket: int = 8
    # bucket-ladder cap: blocks never pad past it, and larger takes split
    # into <= cap dispatches; None = uncapped
    serve_max_bucket: int | None = 128
    token_pack: str = "none"  # packed corpus segments (packing slice)

    def __post_init__(self):
        for name in ("chunk_size", "lex_block_d", "dense_block_d", "serve_max_bucket"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be a positive int or None, got {v!r}")
        for name in ("keep_checkpoints", "lex_tile_d", "serve_max_batch", "serve_min_bucket"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not isinstance(self.serve_max_delay_s, (int, float)) or self.serve_max_delay_s < 0:
            raise ValueError(
                f"serve_max_delay_s must be a non-negative number, got {self.serve_max_delay_s!r}"
            )
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
    def from_dict(cls, d: dict) -> "TuningConfig":
        """Build from a (possibly partial) knob dict, such as one the
        reference's ``tune.save`` wrote. Unknown knob names are rejected; a
        reference knob this slice does not read is dropped at its default
        value and refused at any other."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields - set(_LATER_KNOBS)
        if unknown:
            raise ValueError(f"unknown tuning knobs {sorted(unknown)}")
        for name in sorted(set(d) & set(_LATER_KNOBS)):
            default, slice_name = _LATER_KNOBS[name]
            if d[name] != default:
                raise NotImplementedError(
                    f"tuning knob {name}={d[name]!r} waits for the {slice_name} "
                    "slice of the port"
                )
        return cls(**{k: v for k, v in d.items() if k in fields})

    def config_hash(self) -> str:
        """Short content hash of (knob space version, full knob table),
        stamped into report.json."""
        payload = json.dumps(
            {"space_version": SPACE_VERSION, "config": self.describe()},
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

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
    """The installed config plus where it came from (default | explicit)."""

    config: TuningConfig = DEFAULT
    source: str = "default"

    def provenance(self) -> dict:
        return {"config_hash": self.config.config_hash(), "source": self.source}


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


@contextlib.contextmanager
def use(config: TuningConfig | None, *, source: str = "explicit") -> Iterator[ActiveTuning]:
    """Install ``config`` as the process-wide active tuning for the body
    (``None`` installs the defaults), then restore the previous one. A
    module global, not thread-local, as in the reference."""
    prev = _install(ActiveTuning() if config is None else ActiveTuning(config, source))
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
