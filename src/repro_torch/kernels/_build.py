"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and builds into its own
shared library under ``build/repro_torch/`` at the root of the checkout, at
first use. The library's file name carries a hash of the source, of the
shared ``csrc/*.cuh`` headers and of the flags, so an edited source or
header is rebuilt and a built one is reused. Nothing is built when a module
is imported: the CPU tests import every module.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v [per-source flags] -o lib<name>-<hash>.so <name>.cu

Each source has its own flags (:func:`flags`), and they enter its
library's hash. ``lexical_scan`` builds with ``--fmad=false``: every product
and sum of its epilogues rounds on its own, as its plain PyTorch version's
do, which its bit-exact contract rests on. ``score_topk`` scores on the
tensor cores and has no multiply and add for nvcc to contract (its TF32
split is a subtraction alone), so it needs no such flag; the flash kernels,
held to tolerances and not to bits, let nvcc contract multiplies and adds
into FMAs. Fast math is never on.

Each source's C interface is two functions, ``<name>_launch`` (its
parameters, the stream last; returns 0 or a CUDA error code) and
``<name>_error_string``. :class:`Entry` types them from the kernel module's
spec string (``LAUNCH_ARGS``) and calls the launch on the device's current
stream; :func:`check_aligned` and :func:`sm_count` are the other checks and
facts every launch asks for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.device import canonical_device

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# flags of one source, after NVCC_FLAGS (none for a source not named here)
SOURCE_FLAGS: dict[str, tuple[str, ...]] = {
    "lexical_scan": ("--fmad=false",),
    "score_topk": (),
    "flash_attn": (),
    "flash_decode": (),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_SMS: dict[torch.device, int] = {}
_C_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
# name -> {"seconds": nvcc wall time (0.0 when reused), "ptxas": its report}
BUILD_LOG: dict[str, dict] = {}


def nvcc() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin/nvcc``, then PATH, then
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where library ``name`` builds to: the name hashes its source, every
    ``csrc/*.cuh`` header (a source may include any of them) and its flags,
    so an edited shared header rebuilds every kernel and a change of one
    source's flags rebuilds that one."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None, Path | None]:
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, proc, tmp


def build_all(names) -> dict[str, Path]:
    """Build every named source, one nvcc each, all started together.
    Raises with nvcc's output when any build fails."""
    with _LOCK:
        t0 = time.monotonic()
        started = {n: _start(n) for n in names}
        paths = {}
        for name, (out, proc, tmp) in started.items():
            if proc is None:
                BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "(reused)"})
                paths[name] = out
                continue
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{stdout}{stderr}")
            os.replace(tmp, out)
            BUILD_LOG[name] = {"seconds": time.monotonic() - t0, "ptxas": stderr + stdout}
            paths[name] = out
        return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(path)))
    return lib


class Entry:
    """The C entry point ``<name>_launch`` of ``csrc/<name>.cu``, its
    parameters typed from ``spec`` (one letter each, in order: ``p`` a
    pointer, ``i`` an int, ``f`` a float; the last is the stream). The
    library is loaded, and built first if need be, at the first call."""

    def __init__(self, name: str, spec: str):
        self.name = name
        self.spec = spec
        self._fns = None

    def _bind(self):
        if self._fns is None:
            lib = load(self.name)
            launch = getattr(lib, f"{self.name}_launch")
            launch.argtypes = [_C_TYPES[c] for c in self.spec]
            launch.restype = ctypes.c_int
            error_string = getattr(lib, f"{self.name}_error_string")
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            self._fns = (launch, error_string)
        return self._fns

    def __call__(self, device, *args) -> None:
        """Launch with ``args`` and ``device``'s current stream after them;
        raises RuntimeError with the kernel's own error string on a nonzero
        return."""
        launch, error_string = self._bind()
        rc = launch(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            msg = error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} ({msg})")


def check_aligned(what: str, **tensors) -> None:
    """Raise ValueError for a tensor whose data does not start 16-byte
    aligned (the kernels load 16 bytes at a time)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start 16-byte aligned")


def sm_count(device) -> int:
    """The card's SM count, asked of the driver once a card."""
    dev = canonical_device(device)
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n
