"""Files found by name: a cell's configuration, mix, driver, metric readers
and kernel costs. Nothing here knows any particular cell."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # portbench/
CHECKOUT = ROOT.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: tuple  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: tuple  # ... and with --trace 1
    root: Path = ROOT  # the harness whose drivers, readers and costs the cell runs


def load_benchmark(path: Path | None = None) -> dict:
    with open(CHECKOUT / "BENCHMARK.json" if path is None else path) as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str, bench: dict, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(root.parent / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_mix(name: str, root: Path = ROOT) -> dict:
    return read_json(root / "mixes" / f"{name}.json")


def load_module(kind: str, name: str, root: Path = ROOT):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind[:-1]} {name!r} ({path})")
    mod_name = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}_{abs(hash(path))}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """A cell of ``BENCHMARK.json`` by name."""
    bench = load_benchmark() if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    e2e = tuple(m for m in bench["end_to_end"] if workload in m.get("workloads", [workload]))
    reported = {m["name"] for m in e2e}
    per_layer = tuple(
        m for m in bench["per_layer"]
        if workload in m.get("workloads", [workload] if m["moves"] in reported else []))
    return Cell(workload, load_config(w["config"], bench, root), load_mix(w["traffic"], root),
                int(w["chips"]), e2e, per_layer, root)
