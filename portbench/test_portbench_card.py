"""On the card only (each test decides inside and skips without one): a
short run of each cell is correct, and a checkout that holds only
BENCHMARK.json and the harness gives no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench.lib import registry


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("w", registry.load_benchmark()["workloads"], ids=lambda w: w["name"])
def test_short_run_on_the_card(w):
    _card()
    out = subprocess.run([sys.executable, str(registry.ROOT / "run.py"), "--workload", w["name"],
                          "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=registry.CHECKOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result


def test_harness_alone_gives_no_result(tmp_path):
    _card()
    shutil.copy(registry.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "cw09b-serve-steady", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
