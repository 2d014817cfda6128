"""Sharded scan jobs — one map/reduce layer from kernel to runner.

A **plan** partitions the corpus into chunk-aligned shards (`cluster.plan`),
a **map** runs the one shard fold every job shares
(`cluster.mapreduce.map_shard`), and a **reduce** merges per-shard top-k
states through the k-bounded lexicographic bitonic merge
(`cluster.mapreduce.reduce_states`), whose value-determinism makes merged
rankings byte-identical at every shard count. `cluster.job` adds per-shard
checkpoints, progress manifests, kill/resume and the pipelined executor.

`cluster.faults` + `cluster.scheduler` are the Hadoop-style reliability
layer the paper leans on: deterministic seeded fault injection (crashes,
writer errors, stragglers, dead workers) driving a work-stealing shard
scheduler with checkpoint-resumed retries and speculative re-execution —
under any injected schedule the merged result stays byte-identical to the
fault-free single-host oracle. The reference's mesh pieces (``scan_shards``,
``search_mesh``, ``plan_for_mesh``, ``mesh_scan_axes``) wait for the mesh
slice of the port.
"""

from repro_torch.cluster.faults import (
    FaultSchedule,
    FaultSpec,
    InjectedFault,
    InjectedWriterError,
    ShardCancelled,
    WorkerCrash,
    build_schedule,
    parse_fault,
)
from repro_torch.cluster.scheduler import SchedulerStats, ShardScheduler
from repro_torch.cluster.plan import Shard, ShardPlan, plan_shards
from repro_torch.cluster.mapreduce import map_shard, reduce_states, segment_fold
from repro_torch.cluster.job import (
    ScanJobResult,
    ShardedScanResult,
    read_cluster_manifest,
    read_progress,
    run_scan_job,
    run_sharded_scan_job,
    shard_ckpt_dir,
    spec_ckpt_dir,
)

__all__ = [
    "FaultSchedule",
    "FaultSpec",
    "InjectedFault",
    "InjectedWriterError",
    "SchedulerStats",
    "Shard",
    "ShardCancelled",
    "ShardPlan",
    "ShardScheduler",
    "ScanJobResult",
    "ShardedScanResult",
    "WorkerCrash",
    "build_schedule",
    "map_shard",
    "parse_fault",
    "plan_shards",
    "read_cluster_manifest",
    "read_progress",
    "reduce_states",
    "run_scan_job",
    "run_sharded_scan_job",
    "segment_fold",
    "shard_ckpt_dir",
    "spec_ckpt_dir",
]
