"""The autotuning subsystem of the port against the JAX reference, on the CPU.

* `tune.search` runs the reference's trials: the same candidates in the
  same order and the same winner for the same space, seed and a
  deterministic measure, and fails as the reference does when every trial
  fails (tolerance: none — the scores are the measure's own floats).
* The winner cache keeps the reference's contract (after
  ``tests/test_tune.py``): a round trip hits; a miss, another backend, a
  stale knob-space version, a kind mismatch, an unknown knob or an
  unreadable file give the defaults. A winner measured on the CPU misses
  under a card's backend signature.
* The shape signatures are the reference's strings.
* Tuning changes speed, never bytes: every trial of the scan job's search
  gives the default config's state bytes, and ``run_experiment(
  tune_lookup=True)`` writes the default run's files byte for byte, on a hit
  and on a miss; the CLI's ``--tune`` runs.
"""

import dataclasses
import hashlib
import json
import os

import pytest
import torch

from repro import tune as ref_tune
from repro.experiments import grid as ref_grid
from repro_torch import tune
from repro_torch.experiments import grid, runner
from repro_torch.launch import experiment as cli
from repro_torch.tune import DEFAULT, TuneCache, TuningConfig, targets

SMOKE = grid.get_experiment("smoke")
CUDA_SIG = "cuda:NVIDIA H100 80GB HBM3:sm_90:torch2.0:cuda12.0"


def _spaces(pkg):
    """The same space built from either package's classes."""
    def legal(cfg):
        return cfg.chunk_size is None or 512 % cfg.chunk_size == 0

    return pkg.KnobSpace(
        kind="scan_job",
        knobs=(pkg.Knob("chunk_size", (64, 96, 128, 256)),
               pkg.Knob("prefetch_depth", (1, 2, 4)),
               pkg.Knob("token_pack", ("none", "auto", "bitpack"))),
        constraint=legal,
    )


def _measure(cfg):
    """Deterministic figure of merit of a config's knob table."""
    digest = hashlib.sha256(json.dumps(cfg.describe(), sort_keys=True).encode()).digest()
    return float(int.from_bytes(digest[:4], "little") % 1000)


def _trials(result):
    return [(t.config.describe(), t.score, t.error) for t in result.trials]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("budget", [6, 40])
def test_search_runs_the_references_trials(seed, budget):
    got = tune.run_search(_spaces(tune), _measure, budget=budget, seed=seed)
    want = ref_tune.run_search(_spaces(ref_tune), _measure, budget=budget, seed=seed)
    assert _trials(got) == _trials(want)
    assert got.best.config.describe() == want.best.config.describe()
    assert got.default.config == DEFAULT
    assert got.describe()["space_size"] == want.describe()["space_size"] == 36
    # the candidate pools agree, default first, the illegal chunk left out
    pool = [c.describe() for c in _spaces(tune).candidates(seed=seed)]
    assert pool == [c.describe() for c in _spaces(ref_tune).candidates(seed=seed)]
    assert pool[0] == DEFAULT.describe() and all(c["chunk_size"] != 96 for c in pool)
    assert len(got.trials) == min(budget, len(pool))


def test_search_fails_as_the_reference_does():
    def boom(cfg):
        raise OSError("no disk")

    for pkg in (tune, ref_tune):
        with pytest.raises(RuntimeError, match="every scan_job trial failed; first error: "
                                               "OSError: no disk"):
            pkg.run_search(_spaces(pkg), boom, budget=3)
        with pytest.raises(ValueError, match="budget must be >= 1"):
            pkg.run_search(_spaces(pkg), _measure, budget=0)
    # one failed trial scores -inf and the search goes on
    flaky = lambda cfg: _measure(cfg) if cfg.token_pack == "none" else 1 / 0  # noqa: E731
    got = tune.run_search(_spaces(tune), flaky, budget=8, seed=2)
    want = ref_tune.run_search(_spaces(ref_tune), flaky, budget=8, seed=2)
    assert _trials(got) == _trials(want)
    assert any(t.error for t in got.trials) and got.best.ok


def test_config_reads_partial_and_stale_dicts():
    assert TuningConfig.from_dict({"chunk_size": 32, "meteor": 1}, strict=False) == \
        TuningConfig(chunk_size=32)
    with pytest.raises(ValueError, match="unknown tuning knobs"):
        TuningConfig.from_dict({"meteor": 1})
    cfg = TuningConfig(prefetch_depth=4)
    assert tune.active().provenance() == {"config_hash": DEFAULT.config_hash(),
                                          "source": "default", "cache_hit": False}
    with tune.use(cfg, source="cache", cache_hit=True) as rec:
        assert rec.cache_hit and tune.provenance()["cache_hit"] is True
        assert tune.resolve(None) == cfg
    assert tune.active().source == "default"
    prev = tune.set_active(cfg, source="file")
    try:
        assert tune.active() == tune.ActiveTuning(cfg, "file", False)
    finally:
        tune.set_active(None)
    assert prev == tune.ActiveTuning() and tune.active() == tune.ActiveTuning()
    assert cfg.config_hash() == ref_tune.TuningConfig(prefetch_depth=4).config_hash()


# -- winner cache -------------------------------------------------------------


def _put_one(tmp_path, **kw):
    cache = TuneCache(str(tmp_path / "cache.json"))
    args = dict(kind="scan_job", shape="scan:test", backend="cpu",
                config=TuningConfig(chunk_size=32), score=123.0)
    args.update(kw)
    key = cache.put(**args)
    return cache, key, args


def test_cache_roundtrip(tmp_path):
    cache, key, args = _put_one(tmp_path, meta={"target": "t"})
    assert key == "scan_job|cpu|scan:test|v3"
    got, hit = cache.get(kind="scan_job", shape="scan:test", backend="cpu")
    assert hit and got == args["config"]
    entry = cache.entry(kind="scan_job", shape="scan:test", backend="cpu")
    assert entry["score"] == 123.0 and entry["meta"] == {"target": "t"}
    assert entry["config_hash"] == args["config"].config_hash()
    got2, hit2 = tune.best_config("scan_job", shape="scan:test", backend="cpu", path=cache.path)
    assert hit2 and got2 == got
    # the file is the reference's: its cache reads the port's entry
    ref_got, ref_hit = ref_tune.TuneCache(cache.path).get(kind="scan_job", shape="scan:test",
                                                          backend="cpu")
    assert ref_hit and ref_got == ref_tune.TuningConfig(chunk_size=32)


def test_cache_miss_and_backend_isolation(tmp_path):
    cache, _, _ = _put_one(tmp_path)
    assert cache.get(kind="scan_job", shape="scan:other", backend="cpu") == (DEFAULT, False)
    assert cache.get(kind="scan_job", shape="scan:test", backend=CUDA_SIG) == (DEFAULT, False)
    assert tune.backend_sig("cpu") == "cpu"


def test_backend_sig_follows_the_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.backend_sig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TuneCache("unused.json").get(kind="scan_job", shape="s")


def _corrupt(cache, mutate):
    data = json.load(open(cache.path))
    (entry,) = data["entries"].values()
    mutate(entry)
    with open(cache.path, "w") as f:
        json.dump(data, f)


@pytest.mark.parametrize("mutate", [
    lambda e: e.update(space_version=tune.SPACE_VERSION - 1),
    lambda e: e.update(kind="serve"),
    lambda e: e.update(config={"block_z": 7}),
    lambda e: e.update(config=["chunk_size"]),
    lambda e: e.update(config={"chunk_size": -4}),
], ids=["stale_version", "kind_mismatch", "unknown_knob", "not_a_dict", "illegal_value"])
def test_cache_degrades_to_the_defaults(tmp_path, mutate):
    cache, _, _ = _put_one(tmp_path)
    _corrupt(cache, mutate)
    assert cache.get(kind="scan_job", shape="scan:test", backend="cpu") == (DEFAULT, False)


@pytest.mark.parametrize("content", [b"not json {", b"\xff\xfe\x00garbage", b"[1, 2]",
                                     b'{"entries": 3}'])
def test_cache_unreadable_file_falls_back(tmp_path, content):
    path = tmp_path / "garbage.json"
    path.write_bytes(content)
    assert TuneCache(str(path)).get(kind="scan_job", shape="s", backend="cpu") == (DEFAULT, False)
    assert TuneCache(str(tmp_path / "missing.json")).get(
        kind="scan_job", shape="s", backend="cpu") == (DEFAULT, False)


def test_cache_path_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    assert tune.cache.cache_path() == "results/tune_cache.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/elsewhere/c.json")
    assert tune.cache.cache_path() == "/elsewhere/c.json"
    assert tune.cache.cache_path("x.json") == "x.json"


@pytest.mark.parametrize("name", ["smoke", "bm25-grid"])
def test_shape_signatures_are_the_references(name):
    spec, ref_spec = grid.get_experiment(name), ref_grid.get_experiment(name)
    assert tune.scan_shape_sig_for(spec) == ref_tune.scan_shape_sig_for(ref_spec)
    spec = dataclasses.replace(spec, n_shards=4, k=9)
    assert tune.scan_shape_sig_for(spec) == ref_tune.scan_shape_sig_for(
        dataclasses.replace(ref_spec, n_shards=4, k=9))
    assert "c" + str(spec.chunk_size) not in tune.scan_shape_sig_for(spec)
    kw = dict(n_docs=1 << 20, k=1000, chunk_size=16_384, kind="lexical")
    assert tune.serve_shape_sig(**kw) == ref_tune.serve_shape_sig(**kw)


# -- tuning changes speed, never bytes ------------------------------------------


def _runs(out_dir):
    d = os.path.join(out_dir, "runs")
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("default")
    coll = runner.prepare_collection(SMOKE, seed=0, device="cpu")
    runner.run_experiment(SMOKE, out_dir=str(out), collection=coll, device="cpu")
    return coll, out


def test_scan_search_keeps_every_trials_bytes(tmp_path, smoke_run):
    coll, _ = smoke_run
    target = targets.scan_target(SMOKE, coll, chunk_values=(64, 96, 128, 256),
                                 prefetch_values=(1, 2, 4), device="cpu")
    assert target.backend == "cpu" and target.shape == tune.scan_shape_sig_for(SMOKE)
    assert target.space.size() == 36 and len(target.space.candidates()) == 28  # no chunk 96
    block = targets.tune_target(target, budget=6, seed=0, cache_path=str(tmp_path / "c.json"))
    assert block["n_trials"] == 6 and block["byte_identity"] and block["cache_hit_roundtrip"]
    assert all(t["error"] is None for t in block["trials"])
    for t in block["trials"]:  # every trial's state is the default's, bit for bit
        cfg = TuningConfig.from_dict(t["overrides"])
        assert targets.state_bytes(target.run(cfg)) == target.oracle
    assert block["speedup_x"] >= 1.0
    # a trial that fails (as one whose bytes differ does) fails the search
    broken = dataclasses.replace(target, measure=lambda cfg: 1 / 0 if cfg.token_pack != "none"
                                 else target.measure(cfg))
    with pytest.raises(RuntimeError, match="trial"):
        targets.tune_target(broken, budget=28, cache_path=str(tmp_path / "d.json"))


def test_a_chunk_the_plan_cannot_cut_is_ignored():
    """The runner's and the search's rule: a tuned chunk applies only where
    it cuts every shard into whole chunks."""
    assert TuningConfig(chunk_size=96).scan_chunk(128, n_docs=512, n_shards=1) == 128
    assert TuningConfig(chunk_size=64).scan_chunk(128, n_docs=512, n_shards=2) == 64
    assert TuningConfig(chunk_size=256).scan_chunk(128, n_docs=512, n_shards=4) == 128
    assert TuningConfig(chunk_size=64).scan_chunk(128, n_docs=510, n_shards=4) == 128
    assert TuningConfig().scan_chunk(128, n_docs=512, n_shards=1) == 128


@pytest.mark.parametrize("recorded", ["hit", "miss", "cpu_winner_on_a_card_backend"])
def test_runner_tune_lookup_writes_the_default_runs(tmp_path, smoke_run, recorded):
    coll, default_out = smoke_run
    cache_file = str(tmp_path / "cache.json")
    winner = TuningConfig(chunk_size=256, prefetch_depth=1, token_pack="bitpack")
    if recorded != "miss":
        TuneCache(cache_file).put(
            kind="scan_job", shape=tune.scan_shape_sig_for(SMOKE), config=winner, score=1.0,
            backend="cpu" if recorded == "hit" else CUDA_SIG)
    report = runner.run_experiment(SMOKE, out_dir=str(tmp_path / "out"), collection=coll,
                                   device="cpu", tune_lookup=True, tune_cache=cache_file)
    block = report["job"]["tuning"]
    assert block["source"] == "cache"
    assert block["cache_hit"] is (recorded == "hit")
    want = winner if recorded == "hit" else DEFAULT
    assert block["config_hash"] == want.config_hash()
    assert block["pack_resolved"] == ("bitpack" if recorded == "hit" else "none")
    assert block["chunk_size"] == (256 if recorded == "hit" else SMOKE.chunk_size)
    assert _runs(tmp_path / "out") == _runs(default_out)
    with open(tmp_path / "out" / "report.json") as f:
        assert json.load(f)["job"]["tuning"]["cache_hit"] is (recorded == "hit")
    with pytest.raises(ValueError, match="not both"):
        runner.run_experiment(SMOKE, out_dir=str(tmp_path / "x"), device="cpu",
                              tuning=winner, tune_lookup=True)


def test_cli_tune_runs(tmp_path, smoke_run, capsys):
    _, default_out = smoke_run
    cache_file = str(tmp_path / "cache.json")
    TuneCache(cache_file).put(kind="scan_job", shape=tune.scan_shape_sig_for(SMOKE),
                              config=TuningConfig(chunk_size=64), score=1.0, backend="cpu")
    cli.main(["--experiment", "smoke", "--out", str(tmp_path), "--device", "cpu", "--no-trace",
              "--tune", "--tune-cache", cache_file])
    assert "(cache, cache hit)" in capsys.readouterr().out
    assert _runs(tmp_path / "smoke") == _runs(default_out)
    for flags in (["--tune", "--tuning-config", "x.json"], ["--tune", "--token-pack", "auto"]):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            cli.main(["--experiment", "smoke", "--out", str(tmp_path), "--device", "cpu",
                      *flags])
