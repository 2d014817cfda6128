"""Persistent autotune winner cache, keyed by what a winner was measured on.

The port's copy of `repro.tune.cache`: one JSON file of winning
TuningConfigs, one entry per

    key = kind × backend × shape-signature × knob-space version

* **kind** — what was measured ("scan_job", "serve", ...); a serve winner
  must never be handed to a scan job even if the shape strings collide.
* **backend** — where it was measured (`backend_sig`): ``cpu`` for the
  kernels' plain versions; on a card the CUDA device's name and compute
  capability with the torch and CUDA versions. A winner measured on the CPU
  says nothing about a card, and misses there.
* **shape-signature** — the workload geometry (docs × queries × k ×
  shards × models), built by `repro_torch.tune.scan_shape_sig` and friends
  so that the recorder (`repro_torch.tune.targets`) and the reader (the
  experiment runner's ``--tune`` lookup) agree by construction.
* **knob-space version** — `config.SPACE_VERSION`; bumping it stales every
  recorded winner at once, because a knob that changed meaning would
  otherwise half-apply.

Lookups degrade, never fail: a miss, a stale version, a kind mismatch, an
unreadable file, or an entry whose knobs no longer parse all give the
defaults with ``cache_hit=False`` — ``--tune`` on a cold cache is a slower
spelling of the default run. That is a fallback of *knobs*, never of the
device: the run stays where it was asked to run.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.tune.config import DEFAULT, SPACE_VERSION, TuningConfig

DEFAULT_PATH = "results/tune_cache.json"


def cache_path(path: str | None = None) -> str:
    """Resolve the cache file: explicit arg > $REPRO_TUNE_CACHE > default."""
    return path or os.environ.get("REPRO_TUNE_CACHE") or DEFAULT_PATH


def backend_sig(device=None) -> str:
    """The backend half of the key: ``cpu`` (the plain versions), or on a
    card ``cuda:<name>:sm_<major><minor>:torch<v>:cuda<v>`` (default device
    ``cuda``; without a card that raises, as every entry point does)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"no tuning backend for device {dev}")
    major, minor = torch.cuda.get_device_capability(dev)
    return (f"cuda:{torch.cuda.get_device_name(dev)}:sm_{major}{minor}"
            f":torch{torch.__version__}:cuda{torch.version.cuda}")


def cache_key(kind: str, backend: str, shape: str, version: int = SPACE_VERSION) -> str:
    return f"{kind}|{backend}|{shape}|v{version}"


class TuneCache:
    """The on-disk winner table: one JSON file, atomic rewrite on put."""

    def __init__(self, path: str | None = None):
        self.path = cache_path(path)

    # -- I/O ------------------------------------------------------------------

    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):  # missing, unreadable, not JSON, not UTF-8
            return {"entries": {}}
        if not isinstance(data, dict) or not isinstance(data.get("entries"), dict):
            return {"entries": {}}
        return data

    def _write(self, data: dict) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d or ".", ".tmp-" + os.path.basename(self.path))
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)

    # -- API ------------------------------------------------------------------

    def put(
        self,
        *,
        kind: str,
        shape: str,
        config: TuningConfig,
        score: float,
        backend: str | None = None,
        meta: dict | None = None,
    ) -> str:
        """Record a winner; returns its key. ``score`` is the measured
        figure of merit (docs/s, qps — higher is better), kept so a later
        re-tune can tell whether it actually improved on the record."""
        backend = backend if backend is not None else backend_sig()
        key = cache_key(kind, backend, shape)
        data = self._read()
        data["entries"][key] = {
            "kind": kind,
            "backend": backend,
            "shape": shape,
            "space_version": SPACE_VERSION,
            "config": config.overrides(),  # defaults stay implicit
            "config_hash": config.config_hash(),
            "score": float(score),
            "meta": meta or {},
        }
        self._write(data)
        return key

    def get(
        self, *, kind: str, shape: str, backend: str | None = None
    ) -> tuple[TuningConfig, bool]:
        """(config, hit). Every failure mode — miss, stale knob-space
        version, recorded-kind mismatch, unparsable knobs, an unreadable
        file — returns ``(DEFAULT, False)``; a hit returns the recorded
        winner."""
        backend = backend if backend is not None else backend_sig()
        entry = self._read()["entries"].get(cache_key(kind, backend, shape))
        if not isinstance(entry, dict):
            return DEFAULT, False
        if entry.get("space_version") != SPACE_VERSION:
            return DEFAULT, False  # stale: knobs may have changed meaning
        if entry.get("kind") != kind:
            return DEFAULT, False  # a corrupted/hand-edited entry
        try:
            cfg = TuningConfig.from_dict(entry.get("config") or {}, strict=True)
        except (AttributeError, TypeError, ValueError):  # knobs that no longer parse
            return DEFAULT, False
        return cfg, True

    def entry(self, *, kind: str, shape: str, backend: str | None = None) -> Any:
        """The raw recorded entry (score, meta, hash) or None — for tests
        and the autotune report."""
        backend = backend if backend is not None else backend_sig()
        return self._read()["entries"].get(cache_key(kind, backend, shape))


def best_config(
    kind: str,
    *,
    shape: str,
    backend: str | None = None,
    path: str | None = None,
) -> tuple[TuningConfig, bool]:
    """The one-call lookup: ``repro_torch.tune.best_config("scan_job",
    shape=sig, backend=backend_sig(device))`` → (winner-or-default,
    cache_hit)."""
    return TuneCache(path).get(kind=kind, shape=shape, backend=backend)
