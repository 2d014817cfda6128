"""The port's pipelined scan executor, on the CPU: segment prefetch, async
checkpoint commits, concurrent shards — and the reference's own contract,
that every overlap is invisible in the artifacts: pipelined jobs (killed and
resumed ones, concurrent ones) give states, checkpoint bytes, progress
manifests and run files byte-identical to the synchronous executor's.
Against the JAX reference's pipelined job and CLI the rankings agree under
`_torch_parity`'s rule (ids equal except at the reference's float
near-ties, scores within 1e-5).
"""

import dataclasses
import json
import os
import sys
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rankings_close
from repro import cluster as ref_cluster
from repro.core import anchors as ref_anchors
from repro.core import scoring as ref_scoring
from repro.data import synthetic
from repro.launch import experiment as ref_cli
from repro_torch import checkpoint as ckpt
from repro_torch import cluster
from repro_torch.core import anchors, pipeline, scoring
from repro_torch.eval import trec
from repro_torch.experiments import runner
from repro_torch.launch import experiment as cli

VOCAB = 2048
N_DOCS = 512
CHUNK = 64
K = 10
DEEPER = 8


@pytest.fixture(scope="module")
def corpus():
    return synthetic.make_corpus(n_docs=N_DOCS, vocab=VOCAB, max_len=32, seed=7)


@pytest.fixture(scope="module")
def collection(corpus):
    docs = (torch.as_tensor(corpus.tokens), torch.as_tensor(corpus.lengths))
    stats = anchors.collection_stats(*docs, vocab=VOCAB, chunk_size=CHUNK)
    queries = torch.as_tensor(synthetic.make_queries(corpus, n_queries=8, seed=8))
    return stats, queries, docs


def _scorers():
    return [scoring.make_variant("ql_lm"), scoring.make_variant("bm25")]


def assert_states_identical(got, want, *, err=""):
    assert torch.equal(got.ids, want.ids), err
    assert got.scores.numpy().tobytes() == want.scores.numpy().tobytes(), err


def _ckpt_bytes(root) -> dict:
    """Every committed checkpoint file and progress manifest under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "segment-prefetch"]


# -- segment prefetch ---------------------------------------------------------


@pytest.mark.parametrize("device, depth", [(None, 2), ("cpu", 1), ("cpu", 3)])
def test_prefetch_segments_yields_exact_slices(collection, device, depth):
    _, _, docs = collection
    segs = pipeline.segments(N_DOCS, CHUNK, 2)
    got = list(pipeline.prefetch_segments(docs, segs, device=device, depth=depth))
    assert len(got) == len(segs)
    for (a, b), seg in zip(segs, got):
        for leaf, want in zip(pipeline.leaves(seg), pipeline.leaves(docs)):
            assert torch.equal(leaf, want[a:b])
    assert not _prefetch_threads()


def test_prefetch_segments_stages_at_most_depth_segments(collection):
    """The producer stages segment j only once the consumer has taken
    segment j - depth: the device holds ``depth`` segments of a streamed
    corpus, not the shard."""
    _, _, docs = collection
    segs = pipeline.segments(N_DOCS, CHUNK, 1)  # 8 segments
    taken = []
    lead = []
    real_stage = pipeline.stage

    def stage(data, a, b, device, stream=None):
        lead.append(a // CHUNK - (taken[-1] if taken else -1))
        return real_stage(data, a, b, device, stream)

    for depth in (1, 2, 3):
        taken.clear()
        lead.clear()
        pipeline.stage = stage
        try:
            for i, _ in enumerate(pipeline.prefetch_segments(docs, segs, depth=depth)):
                time.sleep(0.01)  # a slow fold: the producer runs ahead if it may
                taken.append(i)
        finally:
            pipeline.stage = real_stage
        assert len(lead) == len(segs) and max(lead) == depth, (depth, lead)


@pytest.mark.parametrize("how", ["close", "cancel"])
def test_prefetch_segments_stops_its_thread(collection, how):
    _, _, docs = collection
    segs = pipeline.segments(N_DOCS, CHUNK, 1)  # 8 segments, depth 2
    cancel = threading.Event()
    stream = pipeline.prefetch_segments(docs, segs, depth=2, cancel=cancel)
    first = next(stream)
    assert pipeline.leaves(first)[0].shape[0] == CHUNK
    if how == "close":
        stream.close()  # must not hang on the staged-but-unconsumed segments
    else:
        cancel.set()
        rest = list(stream)  # the stream ends early instead of running out
        assert len(rest) < len(segs) - 1
    deadline = time.monotonic() + 5
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads()


def test_prefetch_segments_rejects_bad_depth(collection):
    _, _, docs = collection
    with pytest.raises(ValueError, match="depth"):
        next(pipeline.prefetch_segments(docs, [(0, CHUNK)], depth=0))


def test_prefetch_to_a_card_without_one_raises(collection):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, docs = collection
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pipeline.prefetch_segments(docs, [(0, CHUNK), (CHUNK, 2 * CHUNK)],
                                        device="cuda"))


# -- pipelined == sequential, byte for byte -----------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pipelined_matches_sequential_executor(collection, tmp_path, n_shards):
    stats, queries, docs = collection
    scorers = _scorers()
    kw = dict(k=K, chunk_size=CHUNK, segment_chunks=2, stats=stats, n_shards=n_shards)
    seq = cluster.run_sharded_scan_job(
        queries, docs, scorers, ckpt_dir=str(tmp_path / "seq"), pipelined=False, **kw
    )
    pipe = cluster.run_sharded_scan_job(
        queries, docs, scorers, ckpt_dir=str(tmp_path / "pipe"), pipelined=True, **kw
    )
    assert_states_identical(pipe.state, seq.state, err=f"{n_shards} shards")
    assert seq.scheduler.n_workers == pipe.scheduler.n_workers == 1
    pa = runner.write_run_files(str(tmp_path / "ra"), scorers, seq.state, tag_prefix="t")
    pb = runner.write_run_files(str(tmp_path / "rb"), scorers, pipe.state, tag_prefix="t")
    for name in pa:
        assert open(pa[name], "rb").read() == open(pb[name], "rb").read(), name
    # the async writer left the sync path's checkpoints and manifests, byte for byte
    want = _ckpt_bytes(tmp_path / "seq")
    assert want and _ckpt_bytes(tmp_path / "pipe") == want


def test_pipelined_kill_resume_byte_identical(collection, tmp_path):
    """A lost-ack kill on the pipelined path: the drain before the kill makes
    the commit durable, and the resumed job matches the uninterrupted
    synchronous executor byte for byte, checkpoints included."""
    stats, queries, docs = collection
    scorers = _scorers()
    kw = dict(k=K, chunk_size=CHUNK, segment_chunks=2, stats=stats, n_shards=4)
    seq = cluster.run_sharded_scan_job(
        queries, docs, scorers, ckpt_dir=str(tmp_path / "s"), pipelined=False, **kw
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="injected failure"):
            cluster.run_sharded_scan_job(
                queries, docs, scorers, ckpt_dir=str(tmp_path / "p"),
                fail_at_segment=0, fail_at_shard=2, pipelined=True, **kw
            )
    prog = cluster.read_progress(str(tmp_path / "p" / "shard_0002"))
    assert prog["shards"]["2"]["segments_done"] == 1
    resumed = cluster.run_sharded_scan_job(
        queries, docs, scorers, ckpt_dir=str(tmp_path / "p"), pipelined=True, **kw
    )
    assert resumed.shard_results[2].resumed_from == 1
    assert_states_identical(resumed.state, seq.state)
    assert _ckpt_bytes(tmp_path / "p") == _ckpt_bytes(tmp_path / "s")


def test_concurrent_shard_executor_matches_sequential(collection, tmp_path):
    """Four workers over four devices (all the CPU here): the plan-ordered
    reduce keeps the merged bytes whatever order shards finish in, and a
    shard failure propagates and resumes."""
    stats, queries, docs = collection
    scorers = _scorers()
    kw = dict(k=K, chunk_size=CHUNK, segment_chunks=2, stats=stats, n_shards=4)
    seq = cluster.run_sharded_scan_job(queries, docs, scorers, pipelined=False, **kw)
    conc = cluster.run_sharded_scan_job(
        queries, docs, scorers, pipelined=True, devices=["cpu"] * 4, max_workers=4, **kw
    )
    assert conc.scheduler.n_workers == 4
    assert_states_identical(conc.state, seq.state)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="injected failure"):
            cluster.run_sharded_scan_job(
                queries, docs, scorers, ckpt_dir=str(tmp_path / "c"), fail_at_segment=0,
                fail_at_shard=1, pipelined=True, devices=["cpu"] * 4, max_workers=4, **kw
            )
    resumed = cluster.run_sharded_scan_job(
        queries, docs, scorers, ckpt_dir=str(tmp_path / "c"), pipelined=True,
        devices=["cpu"] * 4, max_workers=4, **kw
    )
    assert resumed.shard_results[1].resumed_from == 1
    assert_states_identical(resumed.state, seq.state)


@pytest.mark.parametrize("knobs", [{"cross_shard_prefetch": False}, {"writer_reuse": True},
                                   {"prefetch_depth": 1, "keep_checkpoints": 1}])
def test_executor_knobs_change_no_byte(collection, tmp_path, knobs):
    from repro_torch.tune import TuningConfig

    stats, queries, docs = collection
    scorers = _scorers()
    kw = dict(k=K, chunk_size=CHUNK, segment_chunks=1, stats=stats, n_shards=4)
    seq = cluster.run_sharded_scan_job(queries, docs, scorers, pipelined=False, **kw)
    got = cluster.run_sharded_scan_job(
        queries, docs, scorers, ckpt_dir=str(tmp_path / "k"), devices=["cpu"] * 2,
        tuning=TuningConfig(**knobs), **kw
    )
    assert got.scheduler.n_workers == 2
    assert_states_identical(got.state, seq.state, err=str(knobs))


# -- async checkpointing ------------------------------------------------------


def test_async_checkpointer_keeps_order_and_contents(tmp_path):
    log = []
    with ckpt.AsyncCheckpointer() as w:
        for i in range(20):
            w.submit(log.append, i)
        w.drain()
        assert log == list(range(20))
        state = (torch.arange(6, dtype=torch.int32), torch.ones(3))
        snap = ckpt.snapshot(state)
        state[0].add_(100)  # the snapshot is a copy: the live tensor may change
        w.submit(ckpt.save, str(tmp_path), 1, snap)
    back = ckpt.restore(str(tmp_path), 1, state)
    assert back[0].tolist() == list(range(6)) and back[1].tolist() == [1.0] * 3


def test_async_checkpointer_is_fail_stop():
    ran = []

    def boom():
        raise OSError("disk full (injected)")

    w = ckpt.AsyncCheckpointer()
    w.submit(ran.append, 1)
    w.submit(boom)
    w.submit(ran.append, 2)  # poisoned: skipped
    with pytest.raises(OSError, match="disk full"):
        w.drain()
    with pytest.raises(OSError, match="disk full"):
        w.submit(ran.append, 3)  # the error stays set
    with pytest.raises(OSError, match="disk full"):
        w.close()
    assert ran == [1]
    w.close()  # a second close is quiet
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(ran.append, 4)
    assert not w._thread.is_alive()


def test_async_writer_error_fails_the_job(collection, tmp_path, monkeypatch):
    """A checkpoint that cannot commit fails the job at the next drain —
    never a scan reported complete whose progress is not durable."""
    stats, queries, docs = collection
    real_save = ckpt.save

    def failing_save(ckpt_dir, step, tree, **kw):
        if step == 2:
            raise OSError("disk full (injected)")
        return real_save(ckpt_dir, step, tree, **kw)

    monkeypatch.setattr(ckpt, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        cluster.run_scan_job(
            queries, docs, [scoring.make_variant("ql_lm")], k=K, chunk_size=CHUNK,
            segment_chunks=2, stats=stats, ckpt_dir=str(tmp_path / "w"), pipelined=True,
        )
    # fail-stop: nothing after the failed step 2 was committed, step 1 is intact
    assert ckpt.all_steps(str(tmp_path / "w")) == [1]
    assert cluster.read_progress(str(tmp_path / "w"))["shards"]["0"]["segments_done"] == 1


# -- against the JAX reference ------------------------------------------------


def _dense_inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((8, 32)).astype(np.float32),
            rng.standard_normal((N_DOCS, 32)).astype(np.float32))


@pytest.mark.parametrize("grid", ["bm25", "dense"])
def test_pipelined_sharded_job_matches_reference(corpus, tmp_path, grid):
    kw = dict(chunk_size=CHUNK, segment_chunks=1, n_shards=4, max_workers=2, pipelined=True)
    if grid == "bm25":
        names = [("bm25", {}), ("bm25", {"k1": 0.9, "b": 0.4}), ("ql_lm", {})]
        q = synthetic.make_queries(corpus, n_queries=8, seed=8)
        ref_docs = (jnp.asarray(corpus.tokens), jnp.asarray(corpus.lengths))
        port_docs = (torch.as_tensor(corpus.tokens), torch.as_tensor(corpus.lengths))
        ref_stats = ref_anchors.collection_stats(*ref_docs, vocab=VOCAB, chunk_size=CHUNK)
        port_stats = anchors.collection_stats(*port_docs, vocab=VOCAB, chunk_size=CHUNK)
    else:
        names = [("dense_dot", {}), ("dense_cosine", {})]
        q, d = _dense_inputs()
        ref_docs, port_docs = jnp.asarray(d), torch.as_tensor(d)
        ref_stats = port_stats = None
    ref = ref_cluster.run_sharded_scan_job(
        jnp.asarray(q), ref_docs, [ref_scoring.make_variant(b, **p) for b, p in names],
        k=K + DEEPER, stats=ref_stats, ckpt_dir=str(tmp_path / "ref"), **kw,
    )
    got = cluster.run_sharded_scan_job(
        torch.as_tensor(q), port_docs, [scoring.make_variant(b, **p) for b, p in names],
        k=K, stats=port_stats, ckpt_dir=str(tmp_path / "port"), **kw,
    )
    assert got.scheduler.n_workers == ref.scheduler.n_workers == 2
    assert got.segments_run == ref.segments_run == 8
    for m, (b, p) in enumerate(names):
        assert_rankings_close(got.state.scores[m], got.state.ids[m], np.asarray(ref.state.scores[m]),
                              np.asarray(ref.state.ids[m]), what=f"{b} {p}")


CLI_FLAGS = [
    ["--pipeline"],
    ["--n-shards", "2", "--max-workers", "2"],
    ["--n-shards", "2", "--max-retries", "1", "--fault",
     "crash:shard=1,segment=0,phase=pre_commit"],
    ["--n-shards", "4", "--speculative"],
    ["--fault-seed", "3", "--max-retries", "1"],
]


@pytest.mark.parametrize("flags", CLI_FLAGS, ids=lambda f: " ".join(f))
def test_cli_matches_the_reference_cli(tmp_path, monkeypatch, flags):
    from repro.tune import config as ref_tune

    common = ["--experiment", "smoke", "--no-trace"]
    # the reference's --fault is its --fault-spec (argparse takes the prefix
    # only where it is unambiguous, so the reference is given the full name).
    # The reference runs without its cross-shard prefetch: its
    # _ShardStager.take can join the staging thread before that thread is
    # started (src/repro/cluster/job.py:573 against :603), which fails a
    # multi-shard run now and then; tuning changes no byte of a run file.
    ref_flags = ["--fault-spec" if f == "--fault" else f for f in flags]
    no_stager = ref_tune.save(ref_tune.TuningConfig(cross_shard_prefetch=False),
                              str(tmp_path / "ref_tuning.json"))
    monkeypatch.setattr(sys, "argv", ["experiment", *common, "--out", str(tmp_path / "r"),
                                      "--tuning-config", no_stager, *ref_flags])
    ref_cli.main()
    cli.main([*common, "--out", str(tmp_path / "p"), "--device", "cpu", *flags])
    with open(tmp_path / "r" / "smoke" / "report.json") as f:
        ref_job = json.load(f)["job"]
    with open(tmp_path / "p" / "smoke" / "report.json") as f:
        job = json.load(f)["job"]
    for key in ("pipelined", "n_shards", "max_retries", "speculative", "segments_total"):
        assert job[key] == ref_job[key], key
    assert job["scheduler"]["n_workers"] == ref_job["scheduler"]["n_workers"]
    assert len(job["faults_fired"]) == len(ref_job["faults_fired"])
    names = sorted(os.listdir(tmp_path / "r" / "smoke" / "runs"))
    assert names == sorted(os.listdir(tmp_path / "p" / "smoke" / "runs"))
    for name in names:
        ids, scores, tag = trec.read_run(str(tmp_path / "p" / "smoke" / "runs" / name))
        r_ids, r_scores, r_tag = trec.read_run(str(tmp_path / "r" / "smoke" / "runs" / name))
        assert tag == r_tag
        assert_rankings_close(scores, ids, r_scores, r_ids, what=f"{flags} {name}")


def test_runner_pipelined_flag_round_trips(tmp_path):
    from repro_torch.experiments import grid

    spec = dataclasses.replace(grid.get_experiment("smoke"), segment_chunks=1, n_shards=2)
    coll = runner.prepare_collection(spec, device="cpu")
    reports = {
        p: runner.run_experiment(spec, out_dir=str(tmp_path / str(p)), collection=coll,
                                 pipelined=p, device="cpu")
        for p in (False, True)
    }
    assert reports[False]["job"]["pipelined"] is False
    assert reports[True]["job"]["pipelined"] is True
    for name in reports[False]["runs"]:
        assert (open(reports[False]["runs"][name], "rb").read()
                == open(reports[True]["runs"][name], "rb").read()), name
    assert reports[False]["metrics"] == reports[True]["metrics"]
    assert _ckpt_bytes(tmp_path / "False" / "ckpt") == _ckpt_bytes(tmp_path / "True" / "ckpt")


def test_launch_counts_are_exact_under_threads():
    """Workers launch from several threads: no count may be lost."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [ops.count_launch("lexical_scan_topk")
                                                    for _ in range(5000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ops.LAUNCHES["lexical_scan_topk"] == before["lexical_scan_topk"] + 8 * 5000
    ops.reset_launches()
    assert set(ops.LAUNCHES.values()) == {0}
