"""Closed loop: a fixed number of queries outstanding, each reply followed
at once by the next query, as a batch of topics run through the scan.

Set-up makes the collection from the seed on the card, draws a pool of
``pool`` queries (`gen/queries.py`, the configuration's length histogram),
and builds the resident session behind the service as the lexical drivers
share it (`lib/lexserve.py`), warmed on the mix's ``warm_buckets``.

The window is one thread, as the service's event loop is: it submits the
first ``outstanding`` queries of the pool, then dispatches one block at a
time (``poll(limit=1)``) and, while the window is open, submits as many
queries as the block answered, the pool taken in order and wrapping
around. With ``outstanding`` a multiple of the service's block size, every
block closes full on its size trigger and none waits on a deadline. Once
the window has closed the loop submits nothing more and answers what is
outstanding, at most ``answer_wait_s`` past the close; what is still
unanswered has failed.

``served_qps`` is the requests answered inside the window over its
seconds. Only the answers of a share ``keep_answers`` of the requests,
drawn from the seed, are kept; the check (`lib/lexserve.py`) draws
``check_requests`` of them and judges each one's top k against
`reference/`, and the statistics the program handed the session, by the
mix's `LIMITS`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.bench import Window
from portbench.gen import corpus as gcorpus, queries as gqueries
from portbench.lib import lexserve

LIMITS = lexserve.LIMITS
# every answer kept for the check
SMALL = {"config": lexserve.SMALL["config"], "mix": dict(lexserve.SMALL["mix"], keep_answers=1.0)}


@dataclasses.dataclass
class Served:
    """One window's requests, by index (request i asks pool row i % pool):
    submit and reply times (s from the window's start; reply NaN if none),
    each answer, and the requests outstanding at each dispatch."""

    submit: np.ndarray
    reply: np.ndarray
    answers: dict
    in_flight: list

    def answered_by(self, t: float) -> int:
        return int((self.reply <= t).sum())


def drive(service, pool: np.ndarray, *, outstanding: int, close_s: float, wait_s: float,
          keep: np.ndarray | None = None, clock=time.monotonic, sleep=time.sleep) -> Served:
    """``keep``: which request indices keep their answers (all if None)."""
    submit: list = []
    reply: list = []
    answers: dict = {}
    waiting: dict = {}  # rid -> request index
    in_flight: list = []
    t0 = clock()

    def send(n: int, now: float) -> None:
        for _ in range(n):
            i = len(submit)
            waiting[service.submit(pool[i % len(pool)])] = i
            submit.append(now - t0)
            reply.append(np.nan)

    send(outstanding, t0)
    while waiting and clock() - t0 <= close_s + wait_s:
        in_flight.append(len(waiting))
        got = service.poll(limit=1)
        if got:
            now = clock()
            for rid, res in got.items():
                j = waiting.pop(rid)
                reply[j] = now - t0
                if keep is None or (j < len(keep) and keep[j]):
                    answers[j] = res
            if now - t0 < close_s:
                send(len(got), now)
            continue
        in_flight.pop()
        now = clock()
        dt = service.ready_at(now) - now
        if dt > 0:
            sleep(dt)
    return Served(np.asarray(submit), np.asarray(reply), answers, in_flight)


@dataclasses.dataclass
class State:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    tokens: torch.Tensor
    lengths: torch.Tensor
    pool: torch.Tensor  # the queries, on the device; request i asks row i % len(pool)
    pool_host: np.ndarray  # the same, on the host
    keep: np.ndarray  # which requests keep their answers for the check
    service: object = None
    stats: object = None
    prog_stats: dict | None = None
    served: Served | None = None


def setup(cell, seed: int, seconds: float, device, parts: dict) -> State:
    cfg, mix = cell.config, cell.mix
    t = time.monotonic()
    tokens, lengths = gcorpus.make_corpus(cfg, seed=seed, device=device)
    pool = gqueries.make_queries(tokens, lengths, n=mix["pool"], hist=cfg["query_len_hist"],
                                 max_q_len=cfg["max_q_len"], seed=seed)
    warm = lexserve.warm_queries(tokens, lengths, cfg, mix, seed)
    keep = lexserve.kept_answers(seed, mix["keep_answers"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["data_s"] = time.monotonic() - t
    service, stats = lexserve.resident_service(cfg, mix, tokens, lengths, warm, device, parts)
    return State(cfg, mix, seed, device, tokens, lengths, pool, pool.cpu().numpy(), keep,
                 service=service, stats=stats)


def run_window(state: State, seconds: float) -> Window:
    mix, cfg = state.mix, state.cfg
    served = drive(state.service, state.pool_host, outstanding=mix["outstanding"],
                   close_s=seconds, wait_s=mix["answer_wait_s"], keep=state.keep)
    state.served = served
    records = list(state.service.metrics)
    calls = [{"kernel": "lexical_scan", "n_models": 1, "n_q": r.n_padded, "l_q": cfg["max_q_len"],
              "n_d": cfg["n_docs"], "l_d": cfg["max_doc_len"], "k": cfg["k"]} for r in records]
    answered = served.answered_by(seconds)
    info = {"requests": len(served.submit), "answered_in_window": answered,
            "blocks": len(records),
            "mean_block": float(np.mean([r.n_real for r in records])) if records else 0.0,
            "full_blocks": sum(r.n_real == r.n_padded == cfg["serve_max_batch"] for r in records),
            "pool_passes": len(served.submit) / len(state.pool)}
    return Window({"served_qps": answered / seconds}, attempted=len(served.submit),
                  failed=int(np.isnan(served.reply).sum()), calls=calls, records=records,
                  info=info)


def release(state: State) -> None:
    state.prog_stats = lexserve.program_stats(state.stats)
    state.service = state.stats = None


def cleanup(state: State) -> None:
    state.service = None


def check(state: State, win: Window, *, control: bool = False) -> list:
    """The readings (`lib/lexserve.check`). ``control``: the reference in
    bfloat16 takes the program's place."""
    n = len(state.pool)
    return lexserve.check(
        cfg=state.cfg, mix=state.mix, seed=state.seed, tokens=state.tokens,
        lengths=state.lengths, answers=state.served.answers,
        query_of=lambda pick: state.pool[torch.as_tensor(pick % n, device=state.device)],
        prog_stats=state.prog_stats, failed=win.failed, control=control)
