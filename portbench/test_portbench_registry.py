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


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    cell = registry.resolve(w["name"])
    driver = registry.load_module("drivers", cell.mix["driver"])
    for fn in ("setup", "run_window", "release", "check", "cleanup"):
        assert callable(getattr(driver, fn))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert set(cell.mix["limits"]) >= {"stats_diff", "score_gap", "rank_gap"}


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert callable(registry.load_module("metrics", m["name"]).read)
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"]:
            registry.load_module("costs", m["name"].split("_roofline")[0])


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
                             device=torch.device("cpu"), t_start=time.monotonic(), root=root)
        assert out.result["correct"], out.result
        want = {"query_p50_ms", "query_p95_ms", "setup_s"} if not trace else {
            "service.batches.burst"}
        assert set(out.result["metrics"]) == want



@pytest.fixture(scope="module")
def traced_steady():
    cell = small(registry.resolve("cw09b-serve-steady"))
    return bench.run_cell(cell, seed=2**31 + 5, seconds=0.5, trace=True,
                          device=torch.device("cpu"), t_start=time.monotonic()).result


@pytest.mark.parametrize("m", [m for m in BENCH["per_layer"] if m["source"] != "device_trace"],
                         ids=lambda m: m["name"])
def test_a_traced_run_reads_each_host_metric(traced_steady, m):
    """Without a card the device's readers find nothing and are left out;
    every other per-layer metric reads a number."""
    got = traced_steady["metrics"]
    assert m["name"] in got and got[m["name"]]["value"] > 0, got
    assert not {n for n in got if n.startswith(("device.", "lexical_scan_roofline"))}
