"""The port's serve CLI end to end on the CPU, at its defaults.

``python -m repro_torch.launch.serve --mode search --device cpu`` streams
four waves of 256 queries through a `RetrievalService` over the reduced
``mirex`` config (8,192 docs), runs the batch-size sweep and writes its
benchmark JSON, all through the kernels' plain versions. It is the slowest
of the port's CPU tests (about half a minute on one core), so it has a file
of its own; LM decode (``--mode decode``) runs here as well.
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
    # without a card and without --device cpu, decode raises too
    assert decode.returncode != 0 and "no CUDA device" in decode.stderr


def test_serve_cli_decode_on_the_cpu(tmp_path):
    """``--mode decode --device cpu`` decodes greedily as the reference's
    ``serve_decode`` does and prints its line; the tokens are the port's own
    step run directly (the reference's weights come from a JAX key, so its
    tokens differ)."""
    import re

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tfm

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "decode", "--device", "cpu",
         "--tokens", "12", "--arch", "h2o-danube-1.8b"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    m = re.fullmatch(r"decoded 12 tokens × 4 sequences in \S+s \(\S+ ms/token\); seq0: \[(.*)\]",
                     line)
    assert m, line
    seq0 = [int(x) for x in m.group(1).split(", ")]
    cfg = reduced_config("h2o-danube-1.8b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    step = tfm.make_serve_step(cfg, batch=4)
    cache = tfm.init_cache(cfg, 4, 20)
    tok, want = torch.ones(4, dtype=torch.int64), []
    for t in range(12):
        logits, cache = step(params, cache, tok, t)
        tok = torch.argmax(logits, dim=-1)
        want.append(int(tok[0]))
    assert seq0 == want
