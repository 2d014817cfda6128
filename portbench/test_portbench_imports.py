"""No module of the harness imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is the program, ``repro`` is not),
and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from portbench.lib import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in registry.ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(registry.ROOT).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (registry.ROOT / "reference").rglob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path


def test_the_check_compares_whole_names(monkeypatch):
    import types

    from portbench import bench

    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("repro_torch_probe"))
    assert "repro_torch_probe" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.probe", types.ModuleType("repro.probe"))
    assert "repro" in bench.forbidden_modules()


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(registry.ROOT / "run.py"), "--workload",
                          "cw09b-serve-steady", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=registry.CHECKOUT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr
