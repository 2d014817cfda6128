"""What the lexical serving drivers share: the resident session behind the
service, warmed on the mix's buckets; the statistics the program handed the
session; and the check of answered requests against `reference/`.

The check compares the mix's ``limits`` named in `LIMITS`, plus
``unanswered`` (limit 0): ``stats_diff`` over the collection statistics,
``score_gap`` and ``rank_gap`` over the top k of ``check_requests`` answered
requests drawn from the seed (`lib/judge.py`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.gen import queries as gqueries, sub_seed
from portbench.lib.judge import Reading, stats_diff, topk_gaps
from portbench.reference import lexical as ref

LIMITS = ("stats_diff", "score_gap", "rank_gap")
# the size the CPU tests cut a lexical cell to: a few thousand short
# documents, and up to 1,024 answers checked, every one that the plain scan
# answers there, so that a fault in one answer of a block shows
SMALL = {"config": {"n_docs": 4096, "max_doc_len": 32, "vocab": 2048, "chunk_size": 512, "k": 50},
         "mix": {"check_requests": 1024}}


def warm_queries(tokens, lengths, cfg: dict, mix: dict, seed: int) -> torch.Tensor:
    """One block's queries for each bucket of the mix's ``warm_buckets``."""
    return gqueries.make_queries(tokens, lengths, n=sum(mix["warm_buckets"]),
                                 hist=cfg["query_len_hist"], max_q_len=cfg["max_q_len"],
                                 seed=seed, stream="warm")


def resident_service(cfg: dict, mix: dict, tokens, lengths, warm, device, parts: dict):
    """``(service, stats)``: the program's statistics job over the
    collection, a `LexicalSession` on it behind a `RetrievalService` at the
    configuration's knobs, and one block of each warm bucket served."""
    from repro_torch.core import anchors
    from repro_torch.serve.service import RetrievalService
    from repro_torch.serve.session import LexicalSession

    t = time.monotonic()
    stats = anchors.collection_stats(tokens, lengths, vocab=cfg["vocab"],
                                     chunk_size=min(cfg["chunk_size"], cfg["n_docs"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["stats_s"] = time.monotonic() - t
    t = time.monotonic()
    session = LexicalSession(tokens, lengths, "ql_lm", k=cfg["k"], chunk_size=cfg["chunk_size"],
                             stats=stats, vocab=cfg["vocab"], token_pack="none", device=device)
    service = RetrievalService({"lexical": session}, max_batch=cfg["serve_max_batch"],
                               max_delay=cfg["serve_max_delay_s"])
    warm = warm.cpu().numpy()
    at = 0
    for size in mix["warm_buckets"]:  # one block of each padding bucket
        for row in warm[at:at + size]:
            service.submit(row)
        at += size
        service.drain()
    service.metrics.clear()
    parts["warmup_s"] = time.monotonic() - t
    return service, stats


def kept_answers(seed: int, share: float) -> np.ndarray:
    """Which of the first 2^22 request indices keep their answers for the
    check, each with probability ``share``, drawn from the seed. Holding
    every answer of a long window would grow the objects that Python's
    cyclic collector walks, and its passes would stall the loop."""
    return np.random.default_rng(sub_seed(seed, "kept")).random(1 << 22) < share


def program_stats(stats) -> dict:
    """The statistics the program handed the session, on the host."""
    return {"cf": stats.cf.cpu().numpy(), "df": stats.df.cpu().numpy(),
            "total": int(stats.total_terms), "n_docs": int(stats.n_docs),
            "avg": float(stats.avg_doc_len)}


def check(*, cfg: dict, mix: dict, seed: int, tokens, lengths, answers: dict, query_of,
          prog_stats: dict, failed: int, control: bool = False) -> list:
    """The readings, in the order of `LIMITS`, then ``unanswered``.

    ``answers`` maps a request's index to its `SearchResult`; ``query_of``
    maps an int64 array of request indices to their queries (on the
    corpus's device). ``control``: the reference in bfloat16 takes the
    program's place."""
    limits = mix["limits"]
    device = tokens.device
    answered = np.array(sorted(answers), np.int64)
    rng = np.random.default_rng(sub_seed(seed, "check"))
    pick = np.sort(rng.choice(answered, min(mix["check_requests"], len(answered)),
                              replace=False))
    queries = query_of(pick)
    ql = cfg["ql_lm"]
    models = [ref.Model("ql", lam=ql["lam"], length_prior=ql["length_prior"])]
    st = ref.collection_stats(tokens, lengths, cfg["vocab"])
    want_stats = {"cf": st.cf.cpu().numpy(), "df": st.df.cpu().numpy(), "total": st.total,
                  "n_docs": st.n_docs, "avg": float(st.avg)}
    if control:
        cst = ref.collection_stats(tokens, lengths, cfg["vocab"], dtype=torch.bfloat16)
        got_stats = {"cf": cst.cf.cpu().numpy(), "df": cst.df.cpu().numpy(),
                     "total": cst.total, "n_docs": cst.n_docs, "avg": float(cst.avg)}
        s, ids = ref.topk(tokens, lengths, queries, models, cst, cfg["k"], dtype=torch.bfloat16)
        got_ids, got_s = ids.cpu().numpy(), s.cpu().numpy().astype(np.float64)
    else:
        got_stats = prog_stats
        got_ids = np.stack([answers[j].ids for j in pick])[None].astype(np.int64)
        got_s = np.stack([answers[j].scores for j in pick])[None].astype(np.float64)
    want_s, _ = ref.topk(tokens, lengths, queries, models, st, cfg["k"])
    want_of_got = ref.score_docs(tokens, lengths, queries, models, st,
                                 torch.as_tensor(got_ids, device=device))
    score_gap, rank_gap = topk_gaps(got_ids, got_s, want_s.cpu().numpy(),
                                    want_of_got.cpu().numpy(), cfg["n_docs"])
    return [
        Reading("stats_diff", stats_diff(got_stats, want_stats), limits["stats_diff"]),
        Reading("score_gap", score_gap, limits["score_gap"]),
        Reading("rank_gap", rank_gap, limits["rank_gap"]),
        Reading("unanswered", failed, 0),
    ]
