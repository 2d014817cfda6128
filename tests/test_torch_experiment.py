"""The experiment lifecycle of the port against the JAX reference, on the CPU.

The ``smoke`` experiment runs through both ``run_experiment``s (the
reference with its synchronous executor, the port with ``device="cpu"``):
run files agree under the tolerance rule of `_torch_parity`, and the eval
report agrees wherever the ids do. Within the port the artifacts are
byte-identical at 1, 2 and 4 shards, across a crash and resume and under
every ``token_pack`` mode, and the port resumes a checkpoint directory the
reference left behind, packed or not.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

from _torch_parity import assert_rankings_close
from repro.cluster import FaultSchedule as RefFaultSchedule
from repro.cluster import WorkerCrash as RefWorkerCrash
from repro.experiments import grid as ref_grid
from repro.experiments import runner as ref_runner
from repro_torch import checkpoint as ckpt
from repro_torch.cluster import FaultSchedule, FaultSpec, WorkerCrash, build_schedule
from repro_torch.cluster import job as port_job
from repro_torch.eval import trec
from repro_torch.experiments import grid, runner
from repro_torch.launch import experiment as cli

SMOKE = grid.get_experiment("smoke")
REF_SMOKE = ref_grid.get_experiment("smoke")


def _runs(out_dir):
    d = os.path.join(out_dir, "runs")
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def _run_port(out_dir, spec=SMOKE, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return runner.run_experiment(spec, out_dir=str(out_dir), device="cpu", **kw)


def _run_ref(out_dir, spec=REF_SMOKE, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return ref_runner.run_experiment(spec, out_dir=str(out_dir), pipelined=False, **kw)


@pytest.fixture(scope="module")
def port_clean(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_clean")
    return out, _run_port(out)


def test_smoke_matches_reference(tmp_path, port_clean):
    out, report = port_clean
    ref_out = tmp_path / "ref"
    ref_report = _run_ref(ref_out)
    assert report["models"] == ref_report["models"]
    with open(out / "qrels.txt", "rb") as a, open(ref_out / "qrels.txt", "rb") as b:
        assert a.read() == b.read()
    all_ids_equal = True
    for model in report["models"]:
        ids, scores, tag = trec.read_run(report["runs"][model])
        r_ids, r_scores, r_tag = trec.read_run(ref_report["runs"][model])
        assert tag == r_tag
        differ = assert_rankings_close(scores, ids, r_scores, r_ids, what=model)
        all_ids_equal &= not differ
        if not differ:
            assert report["metrics"][model] == ref_report["metrics"][model]
    assert all_ids_equal  # the smoke grid has no near-tie that flips an id
    assert report["job"]["segments_total"] == ref_report["job"]["segments_total"] == 2
    assert report["device"] == "cpu"


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_count_changes_no_byte(tmp_path, port_clean, n_shards):
    out, _ = port_clean
    spec = dataclasses.replace(SMOKE, n_shards=n_shards)
    report = _run_port(tmp_path, spec)
    assert report["job"]["n_shards"] == n_shards
    assert os.path.exists(tmp_path / "ckpt" / "cluster.json")
    assert _runs(tmp_path) == _runs(out)


@pytest.mark.parametrize("phase", ["post_commit", "pre_commit"])
def test_crash_and_resume_is_byte_identical(tmp_path, port_clean, phase):
    out, _ = port_clean
    if phase == "post_commit":
        kw = {"fail_at_segment": 0}
    else:
        kw = {"faults": FaultSchedule([FaultSpec("crash", segment=1, phase=phase)])}
    with pytest.raises(WorkerCrash, match="injected failure"):
        _run_port(tmp_path, **kw)
    report = _run_port(tmp_path)
    assert report["job"]["resumed_from"] == 1
    assert report["job"]["segments_run"] == 1
    assert _runs(tmp_path) == _runs(out)


def test_crash_commits_the_same_segments_as_the_reference(tmp_path):
    """A post-commit crash at segment s leaves s+1 committed steps, a
    pre-commit one s, with the same progress manifest as the reference."""
    spec = dataclasses.replace(SMOKE, segment_chunks=1)
    ref_spec = dataclasses.replace(REF_SMOKE, segment_chunks=1)
    for phase, committed in (("post_commit", 3), ("pre_commit", 2)):
        port_dir, ref_dir = tmp_path / f"p_{phase}", tmp_path / f"r_{phase}"
        with pytest.raises(WorkerCrash):
            _run_port(port_dir, spec, faults=build_schedule([f"crash:segment=2,phase={phase}"]))
        from repro.cluster import build_schedule as ref_build

        with pytest.raises(RefWorkerCrash):
            _run_ref(ref_dir, ref_spec, faults=ref_build([f"crash:segment=2,phase={phase}"]))
        assert ckpt.latest_step(str(port_dir / "ckpt")) == committed
        assert ckpt.all_steps(str(port_dir / "ckpt")) == ckpt.all_steps(str(ref_dir / "ckpt"))
        assert port_job.read_progress(str(port_dir / "ckpt")) == port_job.read_progress(
            str(ref_dir / "ckpt")
        )


def test_port_resumes_a_reference_checkpoint(tmp_path, port_clean):
    spec = dataclasses.replace(SMOKE, segment_chunks=1)
    ref_spec = dataclasses.replace(REF_SMOKE, segment_chunks=1)
    with pytest.raises(RefWorkerCrash):
        _run_ref(tmp_path, ref_spec, faults=RefFaultSchedule.from_legacy(1, 0))
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 2
    report = _run_port(tmp_path, spec)
    assert report["job"]["resumed_from"] == 2 and report["job"]["segments_run"] == 2
    out, clean = port_clean
    for model in report["models"]:
        ids, scores, _ = trec.read_run(report["runs"][model])
        c_ids, c_scores, _ = trec.read_run(clean["runs"][model])
        assert_rankings_close(scores, ids, c_scores, c_ids, what=model)


def test_cli_writes_the_same_artifacts(tmp_path, port_clean, capsys):
    out, report = port_clean
    cli.main(["--experiment", "smoke", "--out", str(tmp_path), "--device", "cpu", "--no-trace"])
    printed = capsys.readouterr().out
    assert "== experiment smoke: 2 models" in printed
    cli_dir = tmp_path / "smoke"
    assert _runs(cli_dir) == _runs(out)
    with open(cli_dir / "qrels.txt", "rb") as a, open(out / "qrels.txt", "rb") as b:
        assert a.read() == b.read()
    with open(cli_dir / "report.json") as f:
        assert json.load(f)["metrics"] == report["metrics"]


@pytest.mark.parametrize(
    "flag", [["--pipeline"], ["--max-retries", "1"], ["--speculative"],
             ["--fault-seed", "3", "--max-retries", "1"]],
)
def test_cli_runs_the_executor_flags(tmp_path, port_clean, flag):
    """The executor's flags run, and the run files are the clean run's."""
    out, report = port_clean
    cli.main(["--experiment", "smoke", "--out", str(tmp_path), "--device", "cpu", "--no-trace",
              *flag])
    assert _runs(tmp_path / "smoke") == _runs(out)
    with open(tmp_path / "smoke" / "report.json") as f:
        job = json.load(f)["job"]
    assert job["pipelined"] is True
    assert job["max_retries"] == (1 if "--max-retries" in flag else 0)
    assert job["speculative"] is ("--speculative" in flag)
    assert bool(job["faults_fired"]) is ("--fault-seed" in flag)


def test_runner_runs_packing_and_every_fault_kind(tmp_path):
    from repro_torch.tune import TuningConfig

    # token_pack runs (the packing slice): its artifacts are checked below
    packed = _run_port(tmp_path / "packed", tuning=TuningConfig(token_pack="bitpack"))
    assert packed["job"]["tuning"]["pack_resolved"] == "bitpack"
    # every fault kind constructs now (the executor slice)
    assert FaultSpec("writer_error", segment=0, shard=0).attempts == (0,)
    assert FaultSpec("straggler", shard=0, delay_s=0.01).attempts is None
    assert FaultSpec("dead_worker", worker=1).worker == 1
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("meteor", segment=0)
    with pytest.raises(ValueError, match="belongs to a different job"):
        _run_port(tmp_path / "a")
        _run_port(tmp_path / "a", dataclasses.replace(SMOKE, k=9))


def test_fault_schedule_records_what_fired():
    sched = FaultSchedule.from_legacy(3, 1)
    assert sched.describe() == [{"kind": "crash", "shard": 1, "segment": 3,
                                 "phase": "post_commit", "attempts": [0], "delay_s": 0.0,
                                 "worker": None, "after_shards": 0}]
    assert sched.crash_at(1, 3, 0, "pre_commit") is None
    assert sched.crash_at(0, 3, 0, "post_commit") is None
    assert sched.crash_at(1, 3, 1, "post_commit") is None  # transient: attempt 0 only
    assert sched.crash_at(1, 3, 0, "post_commit") is not None
    assert sched.fired == [{"kind": "crash", "shard": 1, "segment": 3, "attempt": 0,
                            "phase": "post_commit"}]
    assert sched.count_fired("crash") == 1
    assert np.array_equal(
        [s.segment for s in build_schedule(["crash:segment=1", "crash:segment=4"]).specs], [1, 4]
    )
    # per-attempt crashes parse now (the executor slice has retries to need them)
    assert build_schedule(["crash:segment=1,attempts=1"]).specs[0].attempts == (1,)


def test_tuning_knobs_of_later_slices_are_refused(tmp_path):
    from repro.tune import config as ref_tune
    from repro_torch import tune

    path = ref_tune.save(ref_tune.TuningConfig(lex_tile_d=32), str(tmp_path / "ref.json"))
    assert tune.load(path) == tune.TuningConfig(lex_tile_d=32)
    # the executor's knobs are read now: they load at any legal value, and
    # the config hashes to the reference's
    knobs = {"prefetch_depth": 3, "max_workers": 4, "backoff_base": 0.5, "backoff_cap": 2.0,
             "cross_shard_prefetch": False, "writer_reuse": True}
    path = ref_tune.save(ref_tune.TuningConfig(**knobs), str(tmp_path / "k.json"))
    assert tune.load(path) == tune.TuningConfig(**knobs)
    assert tune.load(path).config_hash() == ref_tune.TuningConfig(**knobs).config_hash()
    with pytest.raises(ValueError, match="prefetch_depth"):
        tune.TuningConfig(prefetch_depth=0)
    with pytest.raises(ValueError, match="unknown tuning knobs"):
        tune.TuningConfig.from_dict({"meteor": 1})
    # the serving and LM serving slices' knobs are read now: they load at any legal value
    path = ref_tune.save(ref_tune.TuningConfig(serve_max_batch=8, dense_block_d=512),
                         str(tmp_path / "serve.json"))
    assert tune.load(path) == tune.TuningConfig(serve_max_batch=8, dense_block_d=512)
    knobs = {"flash_block_q": 64, "flash_block_k": 256, "decode_block_s": 256}
    path = ref_tune.save(ref_tune.TuningConfig(**knobs), str(tmp_path / "lm.json"))
    assert tune.load(path) == tune.TuningConfig(**knobs)
    with pytest.raises(ValueError, match="decode_block_s"):
        tune.TuningConfig(decode_block_s=0)


def test_checkpoint_layout_is_the_references(tmp_path):
    import jax.numpy as jnp
    import torch

    from repro import checkpoint as ref_ckpt
    from repro.core import topk as ref_topk
    from repro_torch.core import topk

    rng = np.random.default_rng(0)
    s = rng.standard_normal((2, 3, 5)).astype(np.float32)
    i = rng.integers(0, 99, (2, 3, 5)).astype(np.int32)
    ckpt.save(str(tmp_path / "p"), 4, topk.TopKState(torch.tensor(s), torch.tensor(i)))
    back = ref_ckpt.restore(str(tmp_path / "p"), 4, ref_topk.init(5, (2, 3)))
    assert np.asarray(back.scores).tobytes() == s.tobytes()
    assert np.asarray(back.ids).tobytes() == i.tobytes()
    ref_ckpt.save(str(tmp_path / "r"), 7, ref_topk.TopKState(jnp.asarray(s), jnp.asarray(i)))
    got = ckpt.restore(str(tmp_path / "r"), 7, topk.init(5, (2, 3)))
    assert got.scores.numpy().tobytes() == s.tobytes() and got.ids.dtype == torch.int32
    with open(tmp_path / "p" / "step_00000004" / "manifest.json") as a, open(
        tmp_path / "r" / "step_00000007" / "manifest.json"
    ) as b:
        pa, pb = json.load(a), json.load(b)
    assert pa["leaves"] == pb["leaves"]
    for step in (5, 6):
        ckpt.save(str(tmp_path / "p"), step, got)
    assert ckpt.prune(str(tmp_path / "p"), 2) == [4]
    assert ckpt.all_steps(str(tmp_path / "p")) == [5, 6]
    ckpt.replace_dir(str(tmp_path / "p"), str(tmp_path / "r"))
    assert ckpt.latest_step(str(tmp_path / "r")) == 6 and not (tmp_path / "p").exists()


@pytest.mark.parametrize("token_pack, resolved", [("auto", "u16"), ("16", "u16"),
                                                  ("bitpack", "bitpack")])
def test_packed_runs_are_byte_identical(tmp_path, port_clean, token_pack, resolved):
    """Packing changes bytes moved, never bytes written: the smoke run under
    each pack mode, crashed after its first segment and resumed, writes the
    unpacked run's files."""
    from repro_torch.tune import TuningConfig

    out, clean = port_clean
    tuning = TuningConfig(token_pack=token_pack)
    with pytest.raises(WorkerCrash, match="injected failure"):
        _run_port(tmp_path, tuning=tuning, fail_at_segment=0)
    report = _run_port(tmp_path, tuning=tuning)
    assert report["job"]["resumed_from"] == 1 and report["job"]["segments_run"] == 1
    assert report["job"]["tuning"]["token_pack"] == token_pack
    assert report["job"]["tuning"]["pack_resolved"] == resolved
    assert _runs(tmp_path) == _runs(out)
    assert report["metrics"] == clean["metrics"]


def test_packed_job_fingerprint_is_the_references():
    """The scan job's resume guard hashes a packed corpus's leaves (packed
    tokens, then lengths) as the reference's pytree has them."""
    import jax.numpy as jnp
    import torch

    from repro.cluster import job as ref_job
    from repro.core import packing as ref_packing
    from repro.core import scoring as ref_scoring
    from repro_torch.core import packing, scoring

    rng = np.random.default_rng(0)
    toks = rng.integers(0, 3000, size=(256, 24)).astype(np.int32)
    toks[:, 20:] = -1
    lens = np.full(256, 20, np.int32)
    q = rng.integers(0, 3000, size=(5, 4)).astype(np.int32)
    for mode in ("auto", "bitpack"):
        ref_docs = ref_packing.pack_corpus(toks, lens, vocab=3000, mode=mode)
        docs = packing.pack_corpus(toks, lens, vocab=3000, mode=mode).to("cpu")
        want = ref_job._job_fingerprint(
            jnp.asarray(q), ref_docs, [ref_scoring.get_scorer("bm25")], 10, 64, 2, 0, None)
        got = port_job._job_fingerprint(
            torch.as_tensor(q), docs, [scoring.get_scorer("bm25")], 10, 64, 2, 0, None)
        assert got == want
        unpacked = port_job._job_fingerprint(
            torch.as_tensor(q), (torch.as_tensor(toks), torch.as_tensor(lens)),
            [scoring.get_scorer("bm25")], 10, 64, 2, 0, None)
        assert got != unpacked  # a packed checkpoint never resumes an unpacked job


def test_port_resumes_a_reference_packed_checkpoint(tmp_path, port_clean):
    from repro.tune import TuningConfig as RefTuningConfig
    from repro_torch.tune import TuningConfig

    spec = dataclasses.replace(SMOKE, segment_chunks=1)
    ref_spec = dataclasses.replace(REF_SMOKE, segment_chunks=1)
    with pytest.raises(RefWorkerCrash):
        _run_ref(tmp_path, ref_spec, faults=RefFaultSchedule.from_legacy(1, 0),
                 tuning=RefTuningConfig(token_pack="bitpack"))
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 2
    report = _run_port(tmp_path, spec, tuning=TuningConfig(token_pack="bitpack"))
    assert report["job"]["resumed_from"] == 2 and report["job"]["segments_run"] == 2
    assert report["job"]["tuning"]["pack_resolved"] == "bitpack"
    out, clean = port_clean
    for model in report["models"]:
        ids, scores, _ = trec.read_run(report["runs"][model])
        c_ids, c_scores, _ = trec.read_run(clean["runs"][model])
        assert_rankings_close(scores, ids, c_scores, c_ids, what=model)


def test_cli_token_pack_writes_the_unpacked_artifacts(tmp_path, port_clean):
    out, report = port_clean
    cli.main(["--experiment", "smoke", "--out", str(tmp_path), "--device", "cpu", "--no-trace",
              "--token-pack", "auto"])
    cli_dir = tmp_path / "smoke"
    assert _runs(cli_dir) == _runs(out)
    with open(cli_dir / "report.json") as f:
        got = json.load(f)
    assert got["metrics"] == report["metrics"]
    assert got["job"]["tuning"]["pack_resolved"] == "u16"
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["--experiment", "smoke", "--out", str(tmp_path), "--device", "cpu",
                  "--token-pack", "auto", "--tune"])
