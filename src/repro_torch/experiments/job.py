"""Resumable scan jobs — the one-shard special case of `repro_torch.cluster`.

This module stays as the experiments-facing import path; everything here is
a re-export of `repro_torch.cluster.job`.
"""

from __future__ import annotations

from repro_torch.cluster.job import (  # noqa: F401
    ScanJobResult,
    ShardedScanResult,
    read_progress,
    run_scan_job,
    run_sharded_scan_job,
)

__all__ = [
    "ScanJobResult",
    "ShardedScanResult",
    "read_progress",
    "run_scan_job",
    "run_sharded_scan_job",
]
