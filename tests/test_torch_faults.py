"""The port's reliability layer under deterministic fault injection, on the CPU.

Whatever schedule of crashes, writer errors, stragglers, speculative
duplicates and dead workers is injected, the port's sharded job completes
(or fails with the *original* error once retries are exhausted), and its
merged state is byte-identical to the port's fault-free single-host oracle.
Against the JAX reference: a seed gives the same chaos schedule, the CLI
syntax parses and fails alike, and under one worker (deterministic
scheduling) the same schedule fires the same faults, with rankings under
`_torch_parity`'s rule.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro import cluster as ref_cluster
from repro.cluster import faults as ref_faults
from repro.core import anchors as ref_anchors
from repro.core import scoring as ref_scoring
from repro.data import synthetic
from repro_torch import checkpoint as ckpt
from repro_torch import cluster, obs
from repro_torch.cluster.faults import (
    FaultSchedule,
    FaultSpec,
    InjectedWriterError,
    WorkerCrash,
    parse_fault,
)
from repro_torch.core import anchors, scoring
from repro_torch.experiments import runner

VOCAB = 1024
N_DOCS = 256
CHUNK = 32
K = 8
N_SHARDS = 4
SEGMENTS_PER_SHARD = 2  # 64 rows/shard / (CHUNK * segment_chunks=1)


@pytest.fixture(autouse=True)
def tracing_on():
    """Every chaos test runs with tracing recording: the byte-identity
    contract must hold with tracing on (tracing observes, never decides)."""
    with obs.session():
        yield


@pytest.fixture(scope="module")
def corpus():
    return synthetic.make_corpus(n_docs=N_DOCS, vocab=VOCAB, max_len=24, seed=11)


@pytest.fixture(scope="module")
def collection(corpus):
    docs = (torch.as_tensor(corpus.tokens), torch.as_tensor(corpus.lengths))
    stats = anchors.collection_stats(*docs, vocab=VOCAB, chunk_size=CHUNK)
    queries = torch.as_tensor(synthetic.make_queries(corpus, n_queries=4, seed=12))
    return stats, queries, docs


@pytest.fixture(scope="module")
def oracle(collection):
    """The fault-free single-host run every chaos run must match."""
    stats, queries, docs = collection
    return cluster.run_sharded_scan_job(
        queries, docs, _scorers(), k=K, chunk_size=CHUNK, segment_chunks=1,
        n_shards=1, stats=stats, pipelined=False,
    )


def _scorers():
    return [scoring.make_variant("ql_lm"), scoring.make_variant("bm25")]


def _run(collection, *, faults=None, ckpt_dir=None, **kw):
    stats, queries, docs = collection
    args = dict(
        k=K, chunk_size=CHUNK, segment_chunks=1, n_shards=N_SHARDS, stats=stats,
        ckpt_dir=ckpt_dir, faults=faults, pipelined=True, max_workers=4, backoff_base=0.01,
    )
    args.update(kw)
    return cluster.run_sharded_scan_job(queries, docs, _scorers(), **args)


def assert_matches_oracle(got, oracle, *, err=""):
    assert torch.equal(got.state.ids, oracle.state.ids), err
    assert got.state.scores.numpy().tobytes() == oracle.state.scores.numpy().tobytes(), err


# -- the schedule and its syntax, against the reference ------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_schedule_is_the_references(seed):
    for n_shards, n_segments in ((N_SHARDS, SEGMENTS_PER_SHARD), (1, 2), (8, 5)):
        got = FaultSchedule.random(seed, n_shards=n_shards, n_segments=n_segments)
        want = ref_faults.FaultSchedule.random(seed, n_shards=n_shards, n_segments=n_segments)
        assert got.describe() == want.describe()


def test_parse_fault_round_trips():
    spec = parse_fault("crash:shard=1,segment=0,phase=pre_commit")
    assert spec == FaultSpec(kind="crash", shard=1, segment=0, phase="pre_commit")
    assert parse_fault("straggler:shard=2,delay=0.05").delay_s == 0.05
    assert parse_fault("crash:shard=0,segment=1,attempts=all").attempts is None
    assert parse_fault("crash:shard=0,segment=1,attempts=0|2").attempts == (0, 2)
    assert parse_fault("dead_worker:worker=3,after_shards=1").after_shards == 1
    for text in ("crash:shard=1,segment=0,phase=pre_commit", "writer_error:shard=0,segment=1",
                 "straggler:shard=2,delay=0.05", "dead_worker:worker=3,after_shards=1",
                 "crash:segment=1,attempts=0|2", "straggler:attempts=all"):
        assert parse_fault(text).describe() == ref_faults.parse_fault(text).describe(), text


@pytest.mark.parametrize(
    "bad",
    [
        "explode:shard=1",
        "crash:shard=1",  # crash needs a segment
        "writer_error:shard=0",  # so does writer_error
        "dead_worker:after_shards=1",  # dead_worker needs a worker
        "crash:shard=1,segment=0,wat=1",
        "straggler:delay",
    ],
)
def test_parse_fault_rejects(bad):
    with pytest.raises(ValueError):
        ref_faults.parse_fault(bad)
    with pytest.raises(ValueError):
        parse_fault(bad)


# -- seeded chaos --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_chaos_byte_identical_to_oracle(collection, oracle, tmp_path, seed):
    """Crash pre-/post-commit × straggler × writer error from one seed,
    against retries + stealing + speculation: the run files are the
    fault-free oracle's, byte for byte."""
    schedule = FaultSchedule.random(seed, n_shards=N_SHARDS, n_segments=SEGMENTS_PER_SHARD)
    job = _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "ckpt"), max_retries=3,
               speculative=True)
    assert_matches_oracle(job, oracle, err=f"seed {seed}")
    hard = [f for f in schedule.fired if f["kind"] in ("crash", "writer_error")]
    assert hard, schedule.describe()
    assert job.scheduler.retries + job.scheduler.speculative_launched >= 1
    assert sum(job.scheduler.attempts) >= N_SHARDS + 1
    pa = runner.write_run_files(str(tmp_path / "ra"), _scorers(), oracle.state, tag_prefix="t")
    pb = runner.write_run_files(str(tmp_path / "rb"), _scorers(), job.state, tag_prefix="t")
    for name in pa:
        assert open(pa[name], "rb").read() == open(pb[name], "rb").read(), name


def test_chaos_survives_without_checkpoints(collection, oracle):
    """No ckpt_dir: retries re-fold the whole shard instead of resuming."""
    schedule = FaultSchedule.random(1, n_shards=N_SHARDS, n_segments=SEGMENTS_PER_SHARD)
    job = _run(collection, faults=schedule, max_retries=3, speculative=True)
    assert_matches_oracle(job, oracle)


# -- retry semantics -----------------------------------------------------------


def test_pre_commit_crash_retries_from_last_checkpoint(collection, oracle, tmp_path):
    schedule = FaultSchedule([FaultSpec(kind="crash", shard=1, segment=1, phase="pre_commit")])
    job = _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "c"), max_retries=1)
    assert_matches_oracle(job, oracle)
    assert schedule.count_fired("crash") == 1
    assert job.scheduler.retries == 1
    assert job.scheduler.attempts[1] == 2
    # the retry resumed at segment 1 (segment 0's commit survived the crash)
    assert job.shard_results[1].resumed_from == 1
    assert job.shard_results[1].segments_run == 1


def test_permanent_failure_surfaces_original_error(collection, tmp_path):
    schedule = FaultSchedule(
        [FaultSpec(kind="crash", shard=2, segment=1, phase="pre_commit", attempts="all")]
    )
    with pytest.raises(WorkerCrash, match="injected failure before segment 1"):
        _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "p"), max_retries=2)
    assert schedule.count_fired("crash") == 3  # 1 first try + 2 retries
    # segment 0's commit is still durable: without the fault shard 2 resumes
    job = _run(collection, ckpt_dir=str(tmp_path / "p"))
    assert job.shard_results[2].resumed_from == 1


def test_lowest_failed_shard_error_wins(collection, tmp_path):
    schedule = FaultSchedule(
        [
            FaultSpec(kind="crash", shard=3, segment=0, attempts="all"),
            FaultSpec(kind="crash", shard=1, segment=1, attempts="all", phase="pre_commit"),
        ]
    )
    with pytest.raises(WorkerCrash, match="before segment 1"):
        _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "p"), max_retries=0)


# -- writer errors -------------------------------------------------------------


def test_writer_error_poisons_then_retry_reopens_dir(collection, oracle, tmp_path):
    schedule = FaultSchedule([FaultSpec(kind="writer_error", shard=0, segment=1)])
    job = _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "w"), max_retries=1)
    assert_matches_oracle(job, oracle)
    assert schedule.count_fired("writer_error") == 1
    assert job.scheduler.retries == 1
    sdir = str(tmp_path / "w" / "shard_0000")
    assert ckpt.all_steps(sdir) == [1, 2]
    # the retry's commit of the same step replaced the poisoned tmp dir
    assert not [d for d in os.listdir(sdir) if d.startswith(".tmp-")]
    assert cluster.read_progress(sdir)["shards"]["0"]["complete"]


def test_writer_error_without_retries_fails_job(collection, tmp_path):
    schedule = FaultSchedule([FaultSpec(kind="writer_error", shard=0, segment=0)])
    with pytest.raises(InjectedWriterError, match="injected checkpoint-writer"):
        _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "w"))
    # the poisoned dir: the uncommitted step stays a .tmp- dir, nothing committed
    sdir = str(tmp_path / "w" / "shard_0000")
    assert ckpt.all_steps(sdir) == []
    assert [d for d in os.listdir(sdir) if d.startswith(".tmp-")] == [".tmp-step_00000001"]


# -- stragglers + speculation ----------------------------------------------------


def test_straggler_triggers_speculation(collection, oracle, tmp_path):
    # only attempt 0 is slow: the clone runs at full speed, so the race is
    # real but the artifacts must not care who wins
    schedule = FaultSchedule([FaultSpec(kind="straggler", shard=3, delay_s=0.4, attempts=(0,))])
    job = _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "s"), speculative=True)
    assert_matches_oracle(job, oracle)
    assert schedule.count_fired("straggler") >= 1
    assert job.scheduler.speculative_launched >= 1


def test_speculative_win_promotes_clone_checkpoints(collection, oracle, tmp_path):
    schedule = FaultSchedule([FaultSpec(kind="straggler", shard=2, delay_s=0.6, attempts=(0,))])
    job = _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "s"), speculative=True)
    assert_matches_oracle(job, oracle)
    # shard 2's primary naps 1.2 s and its clone none, so at least that clone wins
    assert job.scheduler.speculative_won >= 1
    root = str(tmp_path / "s")
    assert not [d for d in os.listdir(root) if d.endswith(".spec")]
    assert cluster.read_progress(os.path.join(root, "shard_0002"))["shards"]["2"]["complete"]
    assert ckpt.all_steps(os.path.join(root, "shard_0002")) == [1, 2]


# -- dead workers + work stealing --------------------------------------------------


def test_dead_worker_job_completes_via_stealing(collection, oracle, tmp_path):
    schedule = FaultSchedule([FaultSpec(kind="dead_worker", worker=0)])
    job = _run(collection, faults=schedule, ckpt_dir=str(tmp_path / "d"))
    assert_matches_oracle(job, oracle)
    assert job.scheduler.dead_workers == (0,)
    assert job.scheduler.steals >= 1
    assert all(a == 1 for a in job.scheduler.attempts)


def test_all_workers_dead_is_an_error(collection):
    schedule = FaultSchedule([FaultSpec(kind="dead_worker", worker=w) for w in range(4)])
    with pytest.raises(RuntimeError, match="unscanned shards"):
        _run(collection, faults=schedule)


# -- legacy aliases ----------------------------------------------------------------


def test_legacy_kwargs_fire_once_on_one_shard(collection, tmp_path):
    """``fail_at_segment`` means one transient post-commit crash on
    ``fail_at_shard``: the same call over the same dir resumes past it."""
    stats, queries, docs = collection
    kw = dict(k=K, chunk_size=CHUNK, segment_chunks=1, n_shards=N_SHARDS, stats=stats,
              ckpt_dir=str(tmp_path / "l"))
    with pytest.warns(DeprecationWarning):
        with pytest.raises(RuntimeError, match="injected failure after segment 0"):
            cluster.run_sharded_scan_job(
                queries, docs, _scorers(), fail_at_segment=0, fail_at_shard=2, **kw
            )
    with pytest.warns(DeprecationWarning):
        job = cluster.run_sharded_scan_job(
            queries, docs, _scorers(), fail_at_segment=0, fail_at_shard=2, **kw
        )
    assert job.shard_results[2].resumed_from == 1
    for i, r in enumerate(job.shard_results):
        if i != 2:
            assert r.resumed_from in (0, SEGMENTS_PER_SHARD)


def test_legacy_kwarg_conflicts_with_faults(collection):
    stats, queries, docs = collection
    with pytest.raises(ValueError, match="deprecated fail_at_segment"):
        cluster.run_scan_job(
            queries, docs, _scorers(), k=K, chunk_size=CHUNK, segment_chunks=1,
            stats=stats, fail_at_segment=0, faults=FaultSchedule(),
        )


# -- one worker: the reference's faults, fired alike -------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_one_worker_fires_the_references_faults(corpus, collection, tmp_path, seed):
    """With one worker the scheduling is deterministic, so one seeded schedule
    fires the same faults in the reference and the port,
    and the states agree under the parity rule."""
    stats, queries, docs = collection
    kw = dict(k=K, chunk_size=CHUNK, segment_chunks=1, n_shards=N_SHARDS, pipelined=True,
              max_workers=1, max_retries=2, backoff_base=0.01)
    ref_docs = (jnp.asarray(corpus.tokens), jnp.asarray(corpus.lengths))
    ref_stats = ref_anchors.collection_stats(*ref_docs, vocab=VOCAB, chunk_size=CHUNK)
    ref_sched = ref_faults.FaultSchedule.random(seed, n_shards=N_SHARDS,
                                                n_segments=SEGMENTS_PER_SHARD)
    ref = ref_cluster.run_sharded_scan_job(
        jnp.asarray(queries.numpy()), ref_docs,
        [ref_scoring.make_variant("ql_lm"), ref_scoring.make_variant("bm25")],
        stats=ref_stats, ckpt_dir=str(tmp_path / "ref"), faults=ref_sched, **kw,
    )
    sched = FaultSchedule.random(seed, n_shards=N_SHARDS, n_segments=SEGMENTS_PER_SHARD)
    got = cluster.run_sharded_scan_job(queries, docs, _scorers(), stats=stats,
                                       ckpt_dir=str(tmp_path / "port"), faults=sched, **kw)
    # the writer thread records a writer error, the job thread the rest: the
    # interleaving of the two logs may differ, the faults fired may not
    assert sorted(map(json.dumps, sched.fired)) == sorted(map(json.dumps, ref_sched.fired))
    assert got.scheduler.describe() == ref.scheduler.describe()
    for m in range(2):
        assert_rankings_close(got.state.scores[m], got.state.ids[m],
                              np.asarray(ref.state.scores[m]), np.asarray(ref.state.ids[m]),
                              what=f"seed {seed} model {m}")
