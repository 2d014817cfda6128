"""Run one cell once: set-up, the measured window, the check, the result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's mix names its driver (``drivers/<driver>.py``), which makes the
inputs from the seed, builds and warms the program, drives the window and
judges what the window produced against the plain reference. This module
only sequences those steps and prints the line:

* ``--trace 0``: the cell's end-to-end metrics (``setup_s`` is from the
  start of the process to the start of the window);
* ``--trace 1``: the same window with the program's spans on and the card
  profiled; each per-layer metric's reader (``metrics/<name>.py``) reads
  the run, and a metric whose reader finds nothing is left out.

Standard error ends with each compared number beside its limit; the
result's last key, ``check``, holds the same.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

from portbench.lib import devtrace, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Window:
    """What a driver's window did."""

    e2e: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    calls: list = dataclasses.field(default_factory=list)  # kernel calls with their shapes
    records: list = dataclasses.field(default_factory=list)  # the program's per-block records
    info: dict = dataclasses.field(default_factory=dict)  # printed on stderr


@dataclasses.dataclass
class TracedRun:
    """What a per-layer reader reads."""

    config: dict
    mix: dict
    window: Window
    spans: list  # the program's spans (`repro_torch.obs.SpanEvent`), monotonic clock
    device: devtrace.DeviceRead | None
    peaks: dict
    root: Path = registry.ROOT  # where the readers find ``costs/``


@dataclasses.dataclass
class Outcome:
    result: dict
    readings: list
    info: list  # stderr lines before the readings


def _disk_io() -> dict:
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (line.split(": ") for line in f)}
    except OSError:
        return {}


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: registry.Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Outcome:
    import torch
    from repro_torch import obs

    root = cell.root
    driver = registry.load_module("drivers", cell.mix["driver"], root)
    io0 = _disk_io()
    parts: dict = {}
    state = driver.setup(cell, seed, seconds, device, parts)
    try:
        _sync(device)
        setup_s = time.monotonic() - t_start
        tracer = obs.Tracer(max_events=2_000_000) if trace else None
        prev = obs.install(tracer, obs.Metrics()) if trace else None
        tid = threading.get_ident()
        try:
            with devtrace.DeviceWindow(trace and device.type == "cuda") as dw:
                win = driver.run_window(state, seconds)
        finally:
            if prev is not None:
                obs.install(*prev)
        cuda = device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        dev = dw.read()
        driver.release(state)
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.monotonic()
        readings = driver.check(state, win)
        check_s = time.monotonic() - t_check
    finally:
        driver.cleanup(state)
    io1 = _disk_io()

    metrics = {}
    if not trace:
        values = dict(win.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        run = TracedRun(cell.config, cell.mix, win, tracer.events(), dev,
                        registry.read_json(root / "peaks.json"), root)
        for m in cell.per_layer:
            value = registry.load_module("metrics", m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_block = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    if dev is not None:
        device_block["busy_s"] = dev.busy_s
        device_block["window_s"] = dev.window_s
    correct = win.failed == 0 and all(r.ok for r in readings)
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": device_block}
    if dev is not None:
        ops = sorted(dev.op_seconds().items(), key=lambda kv: -kv[1])[:10]
        busy = devtrace.union((a, b) for _, a, b in dev.ops)
        gaps = devtrace.idle_gaps(busy, dw.t0, dw.t1)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": devtrace.name_gaps(gaps, run.spans, tid),
        }
    result["check"] = {r.name: r.as_json() for r in readings}

    info = [f"setup {k} {v!r}" for k, v in parts.items()]
    info.append(f"setup total {setup_s!r}")
    info += [f"info {k} {v!r}" for k, v in win.info.items()]
    info.append(f"info check_s {check_s!r}")
    info.append(f"info window_s {dw.t1 - dw.t0!r}")
    for key in ("write_bytes", "wchar"):
        if key in io0 and key in io1:
            info.append(f"info disk_{key} {io1[key] - io0[key]}")
    if device.type == "cuda":
        info.append(f"info card {_power_limit()}")
    return Outcome(result, readings, info)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run must not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (args.seconds > 0 and math.isfinite(args.seconds)):
        ap.error("--seconds must be positive")
    cell = registry.resolve(args.workload)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device=device, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for line in out.info:
        print(line, file=sys.stderr)
    for r in out.readings:
        print(r.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0
