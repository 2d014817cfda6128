"""Open loop on the wall clock: independent users' queries at their due
times, whatever the service is doing.

Set-up makes the collection from the seed on the card, runs the program's
statistics job, builds a resident `repro_torch.serve.session.LexicalSession`
behind a `repro_torch.serve.service.RetrievalService` at the
configuration's knobs, draws the arrivals (`gen/arrivals.py`, the mix's
``arrivals`` at ``rate_qps``) and one query a request, and warms every
padding bucket the traffic uses (the mix's ``warm_buckets``).

The window is one thread, as the service's event loop is: it submits every
request whose due time has passed (``try_submit``), dispatches at most one
block (``poll(limit=1)``), stamps the block's replies, and otherwise sleeps
until the next due time or the service's next trigger. A request's latency
runs from its due time to its reply, so a stall counts against every
request it delays. A request that falls due while a block runs is
submitted when the block is done: that lateness (due time to
``try_submit``) is read apart from the microbatcher's queue wait
(admission to the block's close). After the last due time the loop keeps polling until
every admitted request is answered, at most ``answer_wait_s`` past the
close; what is still unanswered, or was refused, has failed.

The check (`lib/lexserve.py`) draws ``check_requests`` answered requests
from the seed and judges each one's top k against `reference/`, and the
statistics the program handed the session, by the mix's `LIMITS`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.bench import Window
from portbench.gen import arrivals, corpus as gcorpus, queries as gqueries
from portbench.lib import lexserve

LIMITS = lexserve.LIMITS
# at the CPU's size, a rate that one thread answers
SMALL = {"config": lexserve.SMALL["config"], "mix": dict(lexserve.SMALL["mix"], rate_qps=200)}


@dataclasses.dataclass
class Served:
    """One window's requests: due, submit and reply times (s from the
    window's start; reply NaN if none) and each answer by request index."""

    due: np.ndarray
    submit: np.ndarray
    reply: np.ndarray
    answers: dict
    refused: int


def drive(service, queries: np.ndarray, due: np.ndarray, *, close_s: float, wait_s: float,
          clock=time.monotonic, sleep=time.sleep) -> Served:
    n = len(due)
    submit = np.full(n, np.nan)
    reply = np.full(n, np.nan)
    answers: dict = {}
    waiting: dict = {}  # rid -> request index
    refused = 0
    t0 = clock()
    at = t0 + np.asarray(due)  # due times on the clock: one expression for waking and submitting
    i = 0
    while True:
        now = clock()
        while i < n and at[i] <= now:
            out = service.try_submit(queries[i])
            submit[i] = now - t0
            if out.admitted:
                waiting[out.rid] = i
            else:
                refused += 1
            i += 1
        got = service.poll(limit=1)
        if got:
            t = clock() - t0
            for rid, res in got.items():
                j = waiting.pop(rid)
                reply[j] = t
                answers[j] = res
            continue
        if i >= n and (not waiting or now - t0 > close_s + wait_s):
            break
        wake = [at[i]] if i < n else []
        ready = service.ready_at(clock())
        if ready is not None:
            wake.append(ready)
        if not wake:
            break
        dt = min(wake) - clock()
        if dt > 0:
            sleep(dt)
    return Served(due, submit, reply, answers, refused)


def late_ms(served: Served) -> np.ndarray:
    """Each request's due time to its ``try_submit``, in ms."""
    return (served.submit - served.due) * 1e3


def queue_wait_mean_ms(records):
    """Mean over the blocks of `BatchRecord.queue_wait_s` (the oldest
    request's admission to the block's close), in ms; None without a block."""
    return float(np.mean([r.queue_wait_s for r in records])) * 1e3 if records else None


def latencies_ms(served: Served, close_s: float, wait_s: float) -> np.ndarray:
    """Each request's due-to-reply time; one never answered counts as
    answered when the loop gave up."""
    reply = np.where(np.isnan(served.reply), close_s + wait_s, served.reply)
    return (reply - served.due) * 1e3


@dataclasses.dataclass
class State:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    tokens: torch.Tensor
    lengths: torch.Tensor
    queries: torch.Tensor  # one a request of the window, on the device
    due: np.ndarray
    service: object = None
    stats: object = None
    prog_stats: dict | None = None
    served: Served | None = None


def setup(cell, seed: int, seconds: float, device, parts: dict) -> State:
    cfg, mix = cell.config, cell.mix
    t = time.monotonic()
    tokens, lengths = gcorpus.make_corpus(cfg, seed=seed, device=device)
    due = arrivals.schedule(mix, seconds, seed)
    queries = gqueries.make_queries(tokens, lengths, n=len(due), hist=cfg["query_len_hist"],
                                    max_q_len=cfg["max_q_len"], seed=seed)
    warm = lexserve.warm_queries(tokens, lengths, cfg, mix, seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["data_s"] = time.monotonic() - t
    service, stats = lexserve.resident_service(cfg, mix, tokens, lengths, warm, device, parts)
    return State(cfg, mix, seed, device, tokens, lengths, queries, due, service=service,
                 stats=stats)


def run_window(state: State, seconds: float) -> Window:
    mix, cfg = state.mix, state.cfg
    served = drive(state.service, state.queries.cpu().numpy(), state.due, close_s=seconds,
                   wait_s=mix["answer_wait_s"])
    state.served = served
    lat = latencies_ms(served, seconds, mix["answer_wait_s"])
    failed = int(np.isnan(served.reply).sum())
    records = list(state.service.metrics)
    calls = [{"kernel": "lexical_scan", "n_models": 1, "n_q": r.n_padded, "l_q": cfg["max_q_len"],
              "n_d": cfg["n_docs"], "l_d": cfg["max_doc_len"], "k": cfg["k"]} for r in records]
    late = late_ms(served)
    info = {"requests": len(served.due), "blocks": len(records),
            "mean_block": float(np.mean([r.n_real for r in records])) if records else 0.0,
            "queue_wait_mean_ms": queue_wait_mean_ms(records),
            "late_mean_ms": float(late.mean()) if len(late) else None,
            "late_p95_ms": float(np.percentile(late, 95)) if len(late) else None,
            "late_max_ms": float(late.max()) if len(late) else None,
            "refused": served.refused}
    e2e = {"query_p50_ms": float(np.percentile(lat, 50)),
           "query_p95_ms": float(np.percentile(lat, 95))}
    return Window(e2e, attempted=len(served.due), failed=failed, calls=calls,
                  records=records, info=info)


def release(state: State) -> None:
    state.prog_stats = lexserve.program_stats(state.stats)
    state.service = state.stats = None


def cleanup(state: State) -> None:
    state.service = None


def check(state: State, win: Window, *, control: bool = False) -> list:
    """The readings (`lib/lexserve.check`). ``control``: the reference in
    bfloat16 takes the program's place."""
    return lexserve.check(
        cfg=state.cfg, mix=state.mix, seed=state.seed, tokens=state.tokens,
        lengths=state.lengths, answers=state.served.answers,
        query_of=lambda pick: state.queries[torch.as_tensor(pick, device=state.device)],
        prog_stats=state.prog_stats, failed=win.failed, control=control)
