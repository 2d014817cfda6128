"""The knee of an open-loop serving cell, on the chip: one set-up, then the
cell's traffic at each rate of ``--rates`` for ``--seconds`` each, and for
each rate the backlog (requests due but not answered) at the middle and at
the end of its window. The knee is the highest rate whose backlog does not
grow: at the end no more than ``--slack`` requests above the middle's.

    python3 portbench/sweep.py --workload cw09b-serve-steady --seed 7 \\
        --rates 600,1200,1800 --seconds 8 [--slack 64]

One JSON line a rate, then one with the knee. The benchmark's own runs
never run this; a mix's ``rate_qps`` is written from its result.
"""

import argparse
import json
import sys


def backlog(served, t: float) -> int:
    import numpy as np

    answered = (~np.isnan(served.reply)) & (served.reply <= t)
    return int((served.due <= t).sum() - answered.sum())


def main(argv) -> int:
    import numpy as np
    import torch

    from portbench.gen import arrivals, queries as gqueries
    from portbench.lib import registry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--slack", type=int, default=64)
    args = ap.parse_args(argv)
    cell = registry.resolve(args.workload)
    driver = registry.load_module("drivers", cell.mix["driver"])
    device = torch.device("cuda")
    state = driver.setup(cell, args.seed, args.seconds, device, {})
    knee = None
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix = dict(cell.mix, rate_qps=rate)
            due = arrivals.schedule(mix, args.seconds, args.seed + i)
            queries = gqueries.make_queries(
                state.tokens, state.lengths, n=len(due), hist=state.cfg["query_len_hist"],
                max_q_len=state.cfg["max_q_len"], seed=args.seed + i).cpu().numpy()
            state.service.metrics.clear()
            served = driver.drive(state.service, queries, due, close_s=args.seconds,
                                  wait_s=mix["answer_wait_s"])
            lat = driver.latencies_ms(served, args.seconds, mix["answer_wait_s"])
            recs = state.service.metrics
            mid, end = backlog(served, args.seconds / 2), backlog(served, args.seconds)
            row = {"rate_qps": rate, "requests": len(due), "backlog_mid": mid,
                   "backlog_end": end, "grows": end > mid + args.slack,
                   "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                   "mean_block": float(np.mean([r.n_real for r in recs])),
                   "block_ms_p50": float(np.median([r.latency_s for r in recs])) * 1e3,
                   "unanswered": int(np.isnan(served.reply).sum())}
            print(json.dumps(row), flush=True)
            if not row["grows"] and row["unanswered"] == 0:
                knee = rate
    finally:
        driver.cleanup(state)
    print(json.dumps({"knee_qps": knee, "steady_qps": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    import run

    run.prepare()
    sys.exit(main(sys.argv[1:]))
