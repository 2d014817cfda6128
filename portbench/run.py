"""One run of one benchmark cell of the PyTorch/CUDA port (`repro_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Puts the checkout and its ``src`` on ``sys.path`` and keeps every build and
kernel cache in fixed directories inside the checkout; see `portbench.bench`.
"""

import time

T_START = time.monotonic()


def prepare() -> None:
    """The checkout and its ``src`` on ``sys.path``; the program's build and
    kernel caches under ``build/portbench`` in the checkout. The harness's
    other commands (`control.py`, `sweep.py`) call this too."""
    import os
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    checkout = os.path.dirname(here)
    sys.path[:] = [checkout, os.path.join(checkout, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    cache = os.path.join(checkout, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")


def main() -> int:
    import sys

    prepare()
    from portbench import bench

    return bench.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    raise SystemExit(main())
