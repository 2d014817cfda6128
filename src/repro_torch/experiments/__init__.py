"""Batch experiment engine on torch: grids, resumable scan jobs, lifecycle.

  * `grid`   — scorer-variant grids + the named-experiment registry;
  * `job`    — segment-checkpointed, kill/resume-bit-identical scan jobs;
  * `runner` — prepare → scan → TREC run files → `repro_torch.eval` report;
  * `bench`  — the models-per-pass amortization curve
               (``BENCH_experiments.json``).

`launch/experiment.py` is the CLI over all of it.
"""

from repro_torch.experiments import bench, grid, job, runner
from repro_torch.experiments.grid import (
    EXPERIMENTS,
    ExperimentSpec,
    GridSpec,
    expand_grids,
    get_experiment,
    parse_grid,
    register_experiment,
)
from repro_torch.experiments.job import ScanJobResult, read_progress, run_scan_job
from repro_torch.experiments.runner import prepare_collection, run_experiment

__all__ = [
    "bench",
    "grid",
    "job",
    "runner",
    "EXPERIMENTS",
    "ExperimentSpec",
    "GridSpec",
    "expand_grids",
    "get_experiment",
    "parse_grid",
    "register_experiment",
    "ScanJobResult",
    "read_progress",
    "run_scan_job",
    "prepare_collection",
    "run_experiment",
]
