"""MIREX as a recsys retrieval service on the PyTorch port: score users
against 200k candidates with MIND's multi-interest model, served through
``repro_torch.serve``.

    PYTHONPATH=src python examples/torch_candidate_retrieval.py               # on the card
    PYTHONPATH=src python examples/torch_candidate_retrieval.py --device cpu  # plain versions

The same flow as ``examples/candidate_retrieval.py``: the candidate corpus
is the "document collection" held resident by a :class:`DenseSession`, each
user's interest capsule is a "query" admitted to the
:class:`RetrievalService`, and the microbatcher forms the query blocks that
the dense score+top-k scans (on the card, the CUDA ``score_topk`` kernel).
Multi-interest scoring stays model-side: each interest is submitted as its
own query and a user's per-interest lists are max-merged on the client. The
service's answers for the first interest are checked against the scan
engine called directly.
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import scan
from repro_torch.device import resolve_device
from repro_torch.models import recsys
from repro_torch.serve import DenseSession, RetrievalService

N_CANDIDATES = 200_000
K = 50


def merge_interests(results, rids_u, k: int):
    """A user's per-interest lists max-merged: each candidate at its best
    score, the top ``k`` (score descending, first seen first on a tie)."""
    flat_s = np.concatenate([results[r].scores for r in rids_u])
    flat_i = np.concatenate([results[r].ids for r in rids_u])
    order = np.argsort(-flat_s, kind="stable")
    seen, merged = set(), []
    for j in order:
        if flat_i[j] not in seen:
            seen.add(flat_i[j])
            merged.append(j)
        if len(merged) == k:
            break
    return flat_s[merged], flat_i[merged]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-users", type=int, default=4)
    ap.add_argument("--n-candidates", type=int, default=N_CANDIDATES)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config("mind")
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0))
    # fake users with 12-item histories
    history = torch.as_tensor(
        np.random.default_rng(1).integers(1, cfg.n_items, (args.n_users, 12)), dtype=torch.int32)
    caps = recsys.mind_interests(params, history, cfg).detach().numpy()  # [U, I, d]
    n_users, n_interests, dim = caps.shape
    print(f"user interests: {caps.shape}")

    cand = np.random.default_rng(2).standard_normal(
        (args.n_candidates, cfg.embed_dim)).astype(np.float32)
    # resident candidate corpus + service; dense blocks go to the score_topk kernel
    session = DenseSession(cand, "dense_dot", k=args.k, chunk_size=1000, device=dev)
    service = RetrievalService({"dense": session}, max_batch=64, max_delay=2e-3)

    t0 = time.perf_counter()
    rids = np.empty((n_users, n_interests), np.int64)
    for u in range(n_users):
        for i in range(n_interests):  # one query per interest capsule
            rids[u, i] = service.submit(caps[u, i], "dense")
    results = service.poll()
    results.update(service.drain())
    dt = time.perf_counter() - t0
    rec = service.metrics[-1]
    print(f"served {n_users * n_interests} interest queries in {dt:.3f}s "
          f"(last block: {rec.n_real} queries, {rec.us_per_query:.0f} µs/query)")

    merged = [merge_interests(results, rids[u], args.k) for u in range(n_users)]
    for u in range(min(n_users, 2)):
        print(f"user {u}: best candidate {merged[u][1][0]} score {merged[u][0][0]:.3e}")

    # cross-check the service's dense dispatch against the scan engine
    ref = scan.search_local(torch.as_tensor(caps[:, 0], device=dev),
                            torch.as_tensor(cand, device=dev), session.scorer, k=args.k,
                            chunk_size=1000)
    got_s = np.stack([results[rids[u, 0]].scores for u in range(n_users)])
    got_i = np.stack([results[rids[u, 0]].ids for u in range(n_users)])
    np.testing.assert_allclose(got_s, ref.scores.cpu().numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got_i, ref.ids.cpu().numpy())
    print(f"service ({'score_topk kernel' if dev.type == 'cuda' else 'plain version'}) "
          "== scan engine ✓")
    out = {"device": str(dev), "users": n_users, "interests": n_interests, "dim": dim,
           "serve_s": dt, "first_interest": {"scores": got_s.tolist(), "ids": got_i.tolist()},
           "merged": [{"scores": s.tolist(), "ids": i.tolist()} for s, i in merged]}
    print(json.dumps({"served": n_users * n_interests, "serve_s": dt}))
    return out


if __name__ == "__main__":
    main()
