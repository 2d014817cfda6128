"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
fallback to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = _port_files()
    assert len(files) > 20
    names = {str(p.relative_to(PORT)) for p in files if PORT in p.parents}
    for module in ("models/transformer.py", "models/attention.py", "models/common.py",
                   "kernels/flash_attn.py", "kernels/flash_decode.py",
                   "configs/archs/gemma2_2b.py", "core/packing.py", "cluster/scheduler.py",
                   "core/invindex.py", "tune/search.py", "tune/cache.py", "tune/targets.py",
                   "experiments/bench.py", "distributed/sharding.py", "launch/mesh.py",
                   "models/moe.py", "configs/archs/qwen3_moe_30b_a3b.py",
                   "configs/archs/dbrx_132b.py", "optim/adamw.py", "optim/compress.py",
                   "data/loader.py", "launch/train.py", "models/embedding.py",
                   "models/recsys.py", "configs/archs/fm.py", "configs/archs/dcn_v2.py",
                   "configs/archs/mind.py", "configs/archs/sasrec.py", "models/gnn.py",
                   "models/segment.py", "data/graph_prep.py", "data/sampler.py",
                   "configs/archs/pna.py", "configs/shapes.py", "launch/cells.py",
                   "launch/dryrun.py", "launch/opcount.py", "launch/roofline.py",
                   "obs/counting.py"):
        assert module in names
    examples = {p.name for p in files if p.parent == ROOT / "examples"}
    assert {"torch_quickstart.py", "torch_train_lm.py",
            "torch_candidate_retrieval.py"} <= examples
    offenders = {
        str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN) for p in files
    }
    assert {k: v for k, v in offenders.items() if v} == {}


def test_layers_below_launch_import_nothing_of_it():
    """The kernels, the cross-shard merges and the models report to an op
    counter through `repro_torch.obs.counting`, never through the launch
    layer (the drivers and CLIs), so no import of theirs can cycle back."""
    low = ("kernels", "core", "distributed", "models", "obs", "optim", "configs")
    offenders = {}
    for pkg in low:
        for path in sorted((PORT / pkg).rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                bad = [n for n in names if n.startswith("repro_torch.launch")]
                if bad:
                    offenders.setdefault(str(path.relative_to(PORT)), []).extend(bad)
    assert offenders == {}


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.launch.experiment, repro_torch.launch.mesh\n"
        "import repro_torch.distributed.sharding, repro_torch.models.moe\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.models.recsys\n"
        "import repro_torch.models.gnn, repro_torch.data.sampler, repro_torch.data.graph_prep\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_to_run_on_the_cpu_unasked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch import resolve_device
    from repro_torch.experiments import grid, runner

    smoke = grid.get_experiment("smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_experiment(smoke, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.prepare_collection(smoke)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import DenseSession, LexicalSession

    tokens, lens = np.zeros((64, 4), np.int32), np.full(64, 4, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LexicalSession(tokens, lens, "ql_lm", k=2, chunk_size=64, vocab=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseSession(np.zeros((64, 4), np.float32), k=2, chunk_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--mode", "search", "--bench-out", str(tmp_path / "b.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--mode", "decode", "--tokens", "2"])
    from repro_torch.launch import train as train_cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "fm", "--steps", "1", "--ckpt-dir", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.train("gemma2-2b", steps=1)
    import runpy

    for name in ("torch_train_lm.py", "torch_candidate_retrieval.py"):
        example = runpy.run_path(str(ROOT / "examples" / name))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example["main"](["--ckpt-dir", str(tmp_path / "e")] if "train" in name else [])
    assert not os.listdir(tmp_path)  # nothing ran
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
