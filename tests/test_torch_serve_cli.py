"""The port's serve CLI end to end on the CPU, at its defaults.

``python -m repro_torch.launch.serve --mode search --device cpu`` streams
four waves of 256 queries through a `RetrievalService` over the reduced
``mirex`` config (8,192 docs), runs the batch-size sweep and writes its
benchmark JSON, all through the kernels' plain versions. It is the slowest
of the port's CPU tests (about half a minute on one core), so it has a file
of its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_serve_cli_runs_at_its_defaults_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "search", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("== streaming 4 request waves of 256 queries (corpus: 8192 docs on cpu")
    assert sum(line.startswith("wave ") and "top-1 of q0" in line for line in lines) == 4
    assert "== service summary: 1024 requests over 8 blocks ==" in lines
    with open(tmp_path / "BENCH_serve.json") as f:
        bench = json.load(f)
    assert [pt["batch"] for pt in bench["curve"]] == [32, 128, 512]
    assert bench["kind"] == "lexical" and bench["n_docs"] == 8192 and bench["k"] == 16
    assert bench["provenance"]["backend"] in ("cpu", "cuda")
    decode = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "decode"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert decode.returncode != 0 and "models slice" in decode.stderr
