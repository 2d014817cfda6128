"""Every cell, configuration, mix, metric and cost of BENCHMARK.json
resolves by name, the file keeps to the contract's shape, and a cell is
added from new files and new entries alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import bench
from portbench.lib import registry
from portbench.lib.smallcell import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = registry.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    cfg = registry.load_config(entry["name"], BENCH)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["source"]) <= 200
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def assert_cell_resolves(w, bench=BENCH, root=registry.ROOT) -> registry.Cell:
    """A cell's entry keeps to the contract's shape, its files resolve, its
    driver has the harness's five steps, its mix holds exactly the limits
    its driver's check compares against (``LIMITS``), and the driver's CPU
    size (``SMALL``) cuts only keys that the cell's configuration and mix
    hold."""
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    cell = registry.resolve(w["name"], bench, root)
    driver = registry.load_module("drivers", cell.mix["driver"], root)
    for fn in ("setup", "run_window", "release", "check", "cleanup"):
        assert callable(getattr(driver, fn))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert set(cell.mix["limits"]) == set(driver.LIMITS)
    assert hasattr(driver, "SMALL"), f"driver {cell.mix['driver']!r} declares no SMALL"
    assert set(driver.SMALL) == {"config", "mix"}
    assert set(driver.SMALL["config"]) <= set(cell.config), driver.SMALL["config"]
    assert set(driver.SMALL["mix"]) <= set(cell.mix), driver.SMALL["mix"]
    return cell


def assert_metric_resolves(m, bench=BENCH, root=registry.ROOT) -> None:
    """A metric's entry keeps to the contract's shape; a per-layer metric
    has its reader, moves an end-to-end metric its cells report, and a
    roofline or ``mfu`` share has its cost (``<kernel>_roofline...`` reads
    ``costs/<kernel>.py``, ``<model>.mfu...`` reads ``costs/<model>.py``'s
    ``flops``)."""
    assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        return
    assert callable(registry.load_module("metrics", m["name"], root).read)
    e2e = {e["name"]: e for e in bench["end_to_end"]}
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", [cell])
    if "roofline" in m["name"]:
        registry.load_module("costs", m["name"].split("_roofline")[0], root)
    if "mfu" in m["name"]:
        assert callable(registry.load_module("costs", m["name"].split(".mfu")[0], root).flops)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert_cell_resolves(w)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert_metric_resolves(m)


# the size every lexical cell is cut to on the CPU, and the rule it is laid
# over a cell by: each key that the cell's configuration or mix holds
LEXICAL_CONFIG = {"n_docs": 4096, "max_doc_len": 32, "vocab": 2048, "chunk_size": 512, "k": 50}
LEXICAL_MIX = {"rate_qps": 200, "check_requests": 1024, "keep_answers": 1.0}


@pytest.mark.parametrize("name", ["cw09b-serve-steady", "cw09b-serve-mqbatch"])
def test_a_lexical_small_cell_keeps_its_size(name):
    """Each lexical driver's ``SMALL`` cuts its cells to the lexical CPU
    size, dict for dict; nothing else of the cell changes."""
    cell = registry.resolve(name)
    cut = small(cell)
    assert cut.config == dict(cell.config, **{k: v for k, v in LEXICAL_CONFIG.items()
                                              if k in cell.config})
    assert cut.mix == dict(cell.mix, **{k: v for k, v in LEXICAL_MIX.items() if k in cell.mix})
    assert (cut.name, cut.chips, cut.end_to_end, cut.per_layer, cut.root) == (
        cell.name, cell.chips, cell.end_to_end, cell.per_layer, cell.root)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_check_reads_each_declared_limit(w):
    """The small cell's check returns one reading a name of its driver's
    ``LIMITS``, in that order, then ``unanswered``, each held to the mix's
    limit (``unanswered`` to 0)."""
    cell = small(registry.resolve(w["name"]))
    driver = registry.load_module("drivers", cell.mix["driver"])
    state = driver.setup(cell, 2**31 + 23, 0.3, torch.device("cpu"), {})
    try:
        win = driver.run_window(state, 0.3)
        driver.release(state)
        readings = driver.check(state, win)
    finally:
        driver.cleanup(state)
    assert [r.name for r in readings] == list(driver.LIMITS) + ["unanswered"]
    assert [r.limit for r in readings] == [cell.mix["limits"][n] for n in driver.LIMITS] + [0]
    assert all(r.ok for r in readings), readings


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_cell_added_from_new_files_alone(tmp_path):
    """A burst mix, a metric reading it and their entries, without a byte of
    an existing file changed; the new cell then runs and reports."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    mix = dict(registry.load_mix("serve-steady"), arrivals="burst", burst_factor=4.0, duty=0.25,
               why="bursts at 4x for a quarter of each second")
    (root / "mixes" / "serve-burst.json").write_text(json.dumps(mix))
    (root / "metrics" / "service.batches.burst.py").write_text(
        "def read(run):\n    return float(len(run.window.records)) or None\n")
    bench_json = json.loads(json.dumps(BENCH))
    bench_json["workloads"].append({"name": "cw09b-serve-burst", "config": "mirex-cw09b-anchor-serve",
                                    "traffic": "serve-burst", "chips": 1, "why": "bursts"})
    for m in bench_json["end_to_end"]:
        if "query_p95_ms" == m["name"] or "query_p50_ms" == m["name"]:
            m["workloads"].append("cw09b-serve-burst")
    bench_json["per_layer"].append({"name": "service.batches.burst", "unit": "blocks",
                                    "better": "lower", "source": "program_counter",
                                    "layer": "service", "moves": "query_p95_ms",
                                    "workloads": ["cw09b-serve-burst"]})
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    cell = small(registry.resolve("cw09b-serve-burst", bench_json, root))
    assert [m["name"] for m in cell.per_layer] == ["service.batches.burst"]
    for trace in (False, True):
        out = bench.run_cell(cell, seed=11, seconds=0.5, trace=trace,
                             device=torch.device("cpu"), t_start=time.monotonic())
        assert out.result["correct"], out.result
        want = {"query_p50_ms", "query_p95_ms", "setup_s"} if not trace else {
            "service.batches.burst"}
        assert set(out.result["metrics"]) == want


TOY_FILES = {
    "configs/toy-mlp.json": json.dumps({
        "name": "toy-mlp", "source": "https://example.org/toy-mlp", "reduced": [],
        "dtype": "fp32", "d_model": 16384, "d_hidden": 65536, "vocab": 262144}),
    "mixes/toy-decode.json": json.dumps({
        "driver": "toy_decode", "batch": 8, "limits": {"logit_gap": 1e-4}}),
    "costs/toy_mlp.py": (
        "def flops(*, batch, d_model, d_hidden, vocab):\n"
        "    return 2 * batch * (d_model * d_hidden + d_hidden * vocab)\n"),
    "metrics/toy_mlp.mfu.decode.py": (
        "from portbench.lib.readers import mfu_share\n\n\n"
        "def read(run):\n"
        "    return mfu_share(run, \"toy_mlp\", \"toy.step\")\n"),
    "reference/toy_mlp.py": (
        "import torch\n\n\n"
        "def logits(x, w1, w2):\n"
        "    x, w1, w2 = (t.double() for t in (x, w1, w2))\n"
        "    return torch.relu(x @ w1) @ w2\n"),
    "drivers/toy_decode.py": '''"""A decode step of a two-layer MLP, as many steps as the window holds;
the last step's logits are judged against `reference/toy_mlp.py`."""

import dataclasses
import time
from pathlib import Path

import torch

from portbench.bench import Window
from portbench.gen import generator
from portbench.lib import registry
from portbench.lib.judge import Reading
from repro_torch import obs

LIMITS = ("logit_gap",)
SMALL = {"config": {"d_model": 64, "d_hidden": 128, "vocab": 256}, "mix": {}}


@dataclasses.dataclass
class State:
    cfg: dict
    mix: dict
    x: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    logits: torch.Tensor | None = None


def setup(cell, seed, seconds, device, parts):
    cfg, mix = cell.config, cell.mix
    g = generator(seed, "weights", device)
    x = torch.randn(mix["batch"], cfg["d_model"], generator=g, device=device)
    w1 = torch.randn(cfg["d_model"], cfg["d_hidden"], generator=g, device=device)
    w2 = torch.randn(cfg["d_hidden"], cfg["vocab"], generator=g, device=device)
    return State(cfg, mix, x, w1 / cfg["d_model"] ** 0.5, w2 / cfg["d_hidden"] ** 0.5)


def decode_step(state):
    return torch.relu(state.x @ state.w1) @ state.w2


def run_window(state, seconds):
    end, steps = time.monotonic() + seconds, 0
    while steps == 0 or time.monotonic() < end:
        with obs.tracer().span("toy.step", "toy"):
            state.logits = decode_step(state)
        steps += 1
    cfg = state.cfg
    call = {"kernel": "toy_mlp", "batch": state.mix["batch"], "d_model": cfg["d_model"],
            "d_hidden": cfg["d_hidden"], "vocab": cfg["vocab"]}
    return Window({"toy_steps_per_s": steps / seconds}, attempted=steps, failed=0,
                  calls=[call] * steps)


def release(state):
    pass


def cleanup(state):
    pass


def check(state, win, *, control=False):
    ref = registry.load_module("reference", "toy_mlp", Path(__file__).resolve().parents[1])
    want = ref.logits(state.x, state.w1, state.w2)
    gap = float((state.logits.double() - want).abs().max() / want.abs().max())
    return [Reading("logit_gap", gap, state.mix["limits"]["logit_gap"]),
            Reading("unanswered", win.failed, 0)]
''',
}
TOY_CELL = {"name": "toy-mlp-decode", "config": "toy-mlp", "traffic": "toy-decode", "chips": 1,
            "why": "a two-layer MLP's decode step"}


def _with_toy_cell(root: Path) -> dict:
    """The toy cell's files written under ``root`` and its entries added to a
    copy of BENCHMARK.json, which is returned."""
    for rel, text in TOY_FILES.items():
        (root / rel).write_text(text)
    bench_json = json.loads(json.dumps(BENCH))
    bench_json["configs"].append({"name": "toy-mlp", "source": "https://example.org/toy-mlp",
                                  "file": "portbench/configs/toy-mlp.json", "reduced": [],
                                  "why": "a model cell's files"})
    bench_json["workloads"].append(TOY_CELL)
    bench_json["end_to_end"].append({"name": "toy_steps_per_s", "unit": "steps/s",
                                     "better": "higher", "bound": 0.05, "source": "host_clock",
                                     "workloads": [TOY_CELL["name"]]})
    bench_json["per_layer"].append({"name": "toy_mlp.mfu.decode", "unit": "%", "better": "higher",
                                    "source": "device_trace", "layer": "model step",
                                    "moves": "toy_steps_per_s", "workloads": [TOY_CELL["name"]]})
    return bench_json


def test_cell_of_another_driver_added_from_new_files_alone(tmp_path, monkeypatch):
    """A cell that is not lexical (its own driver, limits, CPU size,
    reference, cost and ``mfu`` reader), stated at a size that no CPU worker
    could build (73 GB of float32 weights), joins from new files and entries
    alone and passes the rules of `test_cell_resolves` and
    `test_metric_resolves`. Cut to its driver's ``SMALL`` it runs correct on
    the CPU untraced and traced, each run in under 5 s, and a planted fault
    fails its check. A copy whose driver declares no ``SMALL`` fails both
    ``small()`` and `assert_cell_resolves`."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    bench_json = _with_toy_cell(root)
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == set(TOY_FILES)
    stated = assert_cell_resolves(TOY_CELL, bench_json, root)
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        assert_metric_resolves(m, bench_json, root)
    assert [m["name"] for m in stated.per_layer] == ["toy_mlp.mfu.decode"]
    cfg = stated.config
    assert 4 * (cfg["d_model"] * cfg["d_hidden"] + cfg["d_hidden"] * cfg["vocab"]) > 73e9
    cell = small(stated)
    assert cell.config == dict(cfg, d_model=64, d_hidden=128, vocab=256) and cell.mix == stated.mix
    for trace in (False, True):
        t = time.monotonic()
        out = bench.run_cell(cell, seed=2**31 + 29, seconds=0.2, trace=trace,
                             device=torch.device("cpu"), t_start=t)
        assert time.monotonic() - t < 5.0
        assert out.result["correct"], out.result
        assert out.result["check"]["logit_gap"]["value"] < 1e-6
        # traced on the CPU the mfu reader has no device trace and is left out
        assert set(out.result["metrics"]) == (set() if trace else {"toy_steps_per_s", "setup_s"})
    driver = registry.load_module("drivers", "toy_decode", root)
    real = driver.decode_step
    monkeypatch.setattr(driver, "decode_step", lambda state: real(state) + 1e-2)
    out = bench.run_cell(cell, seed=2**31 + 29, seconds=0.2, trace=False,
                         device=torch.device("cpu"), t_start=time.monotonic())
    assert not out.result["correct"] and out.result["check"]["logit_gap"]["value"] > 1e-4

    bare = tmp_path / "bare" / "portbench"
    shutil.copytree(registry.ROOT, bare, ignore=shutil.ignore_patterns("__pycache__"))
    _with_toy_cell(bare)
    path = bare / "drivers" / "toy_decode.py"
    path.write_text(re.sub(r"\nSMALL = .*\n", "\n", path.read_text()))
    with pytest.raises(ValueError, match="declares no SMALL"):
        small(registry.resolve(TOY_CELL["name"], bench_json, bare))
    with pytest.raises(AssertionError, match="declares no SMALL"):
        assert_cell_resolves(TOY_CELL, bench_json, bare)


def test_mfu_share_by_hand(tmp_path):
    """``mfu_share`` and the toy's ``mfu`` reader on a hand-made run: three
    steps of the toy's flops over 2 ms of ``toy.step`` spans, at fp32's and
    bf16's peaks; None without a device trace, the spans or the calls."""
    from repro_torch.obs import SpanEvent

    from portbench.lib import devtrace, readers

    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    _with_toy_cell(root)
    call = {"kernel": "toy_mlp", "batch": 8, "d_model": 64, "d_hidden": 128, "vocab": 256}
    other = {"kernel": "lexical_scan", "n_models": 1, "n_q": 64, "l_q": 8, "n_d": 1, "l_d": 1,
             "k": 1}
    steps = [SpanEvent(name="toy.step", cat="toy", ph="X", ts=t, dur=d, tid=1, attrs={})
             for t, d in ((0.0, 0.5e-3), (1.0, 0.5e-3), (2.0, 1e-3))]
    other_span = SpanEvent(name="serve.dispatch", cat="", ph="X", ts=0.0, dur=9.0, tid=1,
                           attrs={})
    device = devtrace.DeviceRead(window_s=3.0, busy_s=1e-3, ops=[("k", 0.0, 1e-3)])
    peaks = registry.read_json(root / "peaks.json")

    def run(dtype, spans=steps + [other_span], calls=(call, call, call, other), dev=device):
        return bench.TracedRun({"dtype": dtype}, {}, bench.Window({}, 3, 0, calls=list(calls)),
                               spans, dev, peaks, root)

    flops = 3 * 2 * 8 * (64 * 128 + 128 * 256)  # three steps of 655,360
    assert readers.mfu_share(run("fp32"), "toy_mlp", "toy.step") == pytest.approx(
        100.0 * flops / (2e-3 * 128 * 2 * 132 * 1.98e9))
    assert readers.mfu_share(run("bf16"), "toy_mlp", "toy.step") == pytest.approx(
        100.0 * flops / (2e-3 * 989.4e12))
    reader = registry.load_module("metrics", "toy_mlp.mfu.decode", root)
    assert reader.read(run("tf32")) == pytest.approx(100.0 * flops / (2e-3 * 494.7e12))
    assert readers.mfu_share(run("fp32", dev=None), "toy_mlp", "toy.step") is None
    assert readers.mfu_share(run("fp32", spans=[other_span]), "toy_mlp", "toy.step") is None
    assert readers.mfu_share(run("fp32", calls=[other]), "toy_mlp", "toy.step") is None


@pytest.fixture(scope="module")
def traced():
    """The traced small run of a cell, by name, run once a module."""
    runs: dict = {}

    def get(name: str) -> dict:
        if name not in runs:
            cell = small(registry.resolve(name))
            runs[name] = bench.run_cell(cell, seed=2**31 + 5, seconds=0.5, trace=True,
                                        device=torch.device("cpu"),
                                        t_start=time.monotonic()).result
        return runs[name]

    return get


@pytest.mark.parametrize("m", [m for m in BENCH["per_layer"] if m["source"] != "device_trace"],
                         ids=lambda m: m["name"])
def test_a_traced_run_reads_each_host_metric(traced, m):
    """Without a card the device's readers find nothing and are left out;
    every other per-layer metric reads a number in each of its cells."""
    for name in m["workloads"]:
        got = traced(name)["metrics"]
        assert m["name"] in got and got[m["name"]]["value"] > 0, got
        assert not {n for n in got if n.startswith(("device.", "lexical_scan_roofline"))}
