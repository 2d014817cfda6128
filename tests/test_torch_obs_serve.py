"""The serving path's spans, on the CPU: a small `LexicalSession` behind a
`RetrievalService` under `obs.session()`.

A block is ``serve.batch_wait`` (oldest admission to close), then
``serve.dispatch`` holding ``session.search``, which holds
``session.upload``, ``scan.epilogue``, ``scan.launch`` and
``session.to_host`` in that order, then ``serve.reply``; all carry the
block's number, as does each request's ``serve.request``, which lies on a
lane of its own. Tracing changes no reply, and a disabled tracer records
nothing.
"""

import threading

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core.scoring import PAD_TOKEN
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.serve.service import RetrievalService
from repro_torch.serve.session import LexicalSession

INNER = ("session.upload", "scan.epilogue", "scan.launch", "session.to_host")


def _corpus(seed=0, n_docs=256, l_d=16, vocab=64):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l_d + 1, size=n_docs).astype(np.int32)
    toks = rng.integers(0, vocab, size=(n_docs, l_d)).astype(np.int32)
    toks[np.arange(l_d)[None, :] >= lens[:, None]] = PAD_TOKEN
    queries = rng.integers(0, vocab, size=(11, 3)).astype(np.int32)
    queries[::3, 2] = PAD_TOKEN
    return toks, lens, queries


def _serve(queries, toks, lens):
    """Every query through a fresh service (blocks of at most 4); the
    replies and the service's block records."""
    session = LexicalSession(toks, lens, "ql_lm", k=5, chunk_size=64, vocab=64,
                             token_pack="none", device="cpu")
    service = RetrievalService({"lexical": session}, max_batch=4, max_delay=60.0)
    rids = [service.submit(q) for q in queries]
    out = service.poll()
    out.update(service.drain())
    assert sorted(out) == rids
    return out, service.metrics


@pytest.fixture(scope="module")
def traced():
    toks, lens, queries = _corpus()
    with obs.session() as (tr, _):
        replies, records = _serve(queries, toks, lens)
    return tr, replies, records


def _end(s):
    return s.ts + s.dur


def test_each_block_gives_the_span_tree_in_order(traced):
    tr, _, records = traced
    dispatches = tr.spans("serve.dispatch")
    assert [d.attrs["block"] for d in dispatches] == list(range(len(records))) == [0, 1, 2]
    for d in dispatches:
        n = d.attrs["block"]
        one = {name: [s for s in tr.spans(name) if s.attrs.get("block") == n]
               for name in ("session.search", "serve.reply") + INNER}
        assert all(len(v) == 1 for v in one.values()), one
        search, reply = one["session.search"][0], one["serve.reply"][0]
        assert d.ts <= search.ts and _end(search) <= _end(d)
        at = search.ts
        for name in INNER:  # in order, inside the search, without overlap
            s = one[name][0]
            assert at <= s.ts and _end(s) <= _end(search), name
            at = _end(s)
        assert _end(d) <= reply.ts
        assert {s.tid for v in one.values() for s in v} == {d.tid}


def test_each_batch_wait_is_its_blocks_queue_wait(traced):
    tr, _, records = traced
    waits = tr.spans("serve.batch_wait")
    dispatches = tr.spans("serve.dispatch")
    assert [w.attrs["block"] for w in waits] == [0, 1, 2]
    for w, d, r in zip(waits, dispatches, records):
        assert w.dur == r.queue_wait_s
        assert (w.attrs["trigger"], w.attrs["n_real"]) == (r.trigger, r.n_real)
        assert _end(w) <= d.ts < _end(w) + 0.5
        assert w.tid == d.tid


def test_requests_lie_off_the_service_threads_lane(traced):
    tr, replies, records = traced
    requests = tr.spans("serve.request")
    assert sorted(s.attrs["rid"] for s in requests) == sorted(replies)
    assert all(s.tid != threading.get_ident() for s in requests)
    replies_at = {s.attrs["block"]: s for s in tr.spans("serve.reply")}
    per_block = {}
    for s in requests:
        per_block[s.attrs["block"]] = per_block.get(s.attrs["block"], 0) + 1
        reply = replies_at[s.attrs["block"]]
        assert reply.ts <= _end(s) <= _end(reply)
    assert per_block == {n: r.n_real for n, r in enumerate(records)}


def test_replies_are_the_same_bytes_traced_and_not(traced):
    _, replies, _ = traced
    toks, lens, queries = _corpus()
    plain, _ = _serve(queries, toks, lens)
    assert sorted(plain) == sorted(replies)
    for rid, r in plain.items():
        assert r.scores.tobytes() == replies[rid].scores.tobytes()
        assert r.ids.tobytes() == replies[rid].ids.tobytes()


def test_a_disabled_tracer_records_nothing():
    toks, lens, queries = _corpus(1)
    tr = Tracer(enabled=False)
    with obs.session(tracer=tr):
        _serve(queries, toks, lens)
    assert len(tr) == 0
    assert tr.tags(block=1) is NULL_SPAN


def test_tags_nest_and_yield_to_a_spans_own_attributes():
    tr = Tracer()
    with tr.tags(block=3, kind="a"):
        with tr.span("outer", kind="b"):
            with tr.tags(step=1):
                tr.instant("mark")
        tr.record("late", 0.0, 1.0, tid=7)
    tr.instant("after")
    got = {e.name: dict(e.attrs) for e in tr.events()}
    assert got == {"mark": {"block": 3, "kind": "a", "step": 1},
                   "outer": {"block": 3, "kind": "b"},
                   "late": {"block": 3, "kind": "a"}, "after": {}}
    seen = []
    t = threading.Thread(target=lambda: seen.append(tr.span("other").attrs))
    with tr.tags(block=4):
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [{}]  # tags belong to their thread
