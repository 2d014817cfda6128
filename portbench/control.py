"""The readings that the limits of a cell's check are set from, on the chip
at the cell's own size, in one process (the kernel built once):

* the program's readings on each seed of ``--seeds`` (a short window at
  the cell's own load, then the check as a run makes it);
* the control's readings on the first ``--control-seeds`` of them: the
  plain reference in the precision below the configuration's (scores in
  bfloat16) put in the program's place, judged by the same check.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --control-seeds 3 --seconds 2 [--out chiprun_out/control.jsonl]

One JSON line a seed and side. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time


def main(argv) -> int:
    import torch

    from portbench.lib import registry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = registry.resolve(args.workload)
    device = torch.device("cuda")
    driver = registry.load_module("drivers", cell.mix["driver"])
    with open(args.out or os.devnull, "a") as out:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            _seed(cell, driver, device, seed, i < args.control_seeds, args.seconds, out)
    return 0


def _seed(cell, driver, device, seed: int, with_control: bool, seconds: float, out) -> None:
    """The program's readings on ``seed``, and the control's."""
    import torch

    state = driver.setup(cell, seed, seconds, device, {})
    try:
        win = driver.run_window(state, seconds)
        driver.release(state)
        torch.cuda.empty_cache()
        sides = [("program", False)] + ([("control", True)] if with_control else [])
        for side, control in sides:
            t = time.monotonic()
            readings = driver.check(state, win, control=control)
            line = json.dumps({"workload": cell.name, "seed": seed, "side": side,
                               "attempted": win.attempted, "failed": win.failed,
                               "check_s": time.monotonic() - t,
                               "readings": {r.name: r.value for r in readings}})
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
    finally:
        driver.cleanup(state)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    import run

    run.prepare()
    sys.exit(main(sys.argv[1:]))
