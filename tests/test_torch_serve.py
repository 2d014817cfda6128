"""The port's serving layer against the JAX reference's, on the CPU.

The control plane (bucket ladder, padding, size and deadline triggers,
oversize splits, admission, the adaptive policy, the open-loop generator)
is driven through both packages with the same clock and inputs, and must
make the same decisions. The sessions are held against the reference's
sessions under the parity rule (`_torch_parity`): scores within 1e-5, ids
equal except at float near-ties. Within the port, completed requests are
byte-identical under shedding and QoS lanes to an uncapped oracle.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as ref_serve
import repro_torch.serve as port_serve
from _torch_parity import assert_rankings_close
from repro.core import anchors as ref_anchors
from repro.data import synthetic as ref_synthetic
from repro.obs.metrics import Histogram as RefHistogram
from repro.obs.metrics import Metrics as RefMetrics
from repro.serve import microbatch as ref_mb
from repro_torch import convert, obs
from repro_torch.data import synthetic
from repro_torch.obs.metrics import Histogram, Metrics
from repro_torch.serve import bench
from repro_torch.serve import microbatch as port_mb

PKGS = {
    "ref": (ref_serve, ref_mb, types.SimpleNamespace(Histogram=RefHistogram, Metrics=RefMetrics)),
    "port": (port_serve, port_mb, types.SimpleNamespace(Histogram=Histogram, Metrics=Metrics)),
}
DEEPER = 8


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class StubSession:
    """Deterministic per-row 'scan': result row j = f(query row j) only."""

    kind = "stub"
    pad_value = 0
    k = 4
    chunk_size = 64
    n_docs = 128
    scorer = type("S", (), {"name": "stub"})()

    def __init__(self):
        self.block_sizes = []

    def search(self, q):
        self.block_sizes.append(q.shape[0])
        state = type("State", (), {})()
        state.scores = q[:, :1].astype(np.float32) + np.arange(self.k, 0, -1, np.float32)
        state.ids = (q[:, :1].astype(np.int32) * 10 + np.arange(self.k, dtype=np.int32)).copy()
        return state


def _both(scenario):
    out = {name: scenario(*mods) for name, mods in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


# ----------------------------------------------------------- control plane


def test_bucket_ladder_and_padding():
    def scenario(serve, mb, met):
        sizes = [mb.bucket_size(n, min_bucket=lo, max_bucket=hi)
                 for n in (1, 7, 8, 9, 33, 65, 128, 200)
                 for lo, hi in ((8, 128), (8, 64), (8, None), (16, 32))]
        rows = np.arange(15, dtype=np.float32).reshape(5, 3)
        padded = mb.pad_rows(rows, mb.bucket_size(5, min_bucket=8, max_bucket=128), 0.0)
        return sizes, padded.tobytes(), mb.unpad_results(padded, 5).tobytes()

    sizes, padded, unpadded = _both(scenario)
    assert sizes[:4] == [8, 8, 8, 16] and unpadded == np.arange(15, dtype=np.float32).tobytes()
    with pytest.raises(ValueError):
        port_mb.pad_rows(np.zeros((9, 2)), 8, 0)


def test_microbatch_triggers_and_oversize_splits():
    def scenario(serve, mb, met):
        log = []
        b = mb.Microbatcher(max_batch=4, max_delay=0.5, min_bucket=8, pad_value=-1)
        for rid in range(3):
            b.submit(rid, np.full(4, rid, np.int32), now=0.1 * rid)
        log.append((b.ready(0.2), b.next_deadline(), b.pop_block(0.49)))
        blk = b.pop_block(0.5)
        log.append((blk.trigger, blk.rids, blk.n_real, blk.n_padded, blk.queries.tobytes(),
                    blk.closed_at, blk.oldest_arrival, blk.arrivals))
        for rid in range(3, 13):
            b.submit(rid, np.full(4, rid, np.int32), now=1.0)
        blk = b.pop_block(1.0)
        log.append((blk.trigger, blk.rids))
        log.append([(x.trigger, x.rids, x.n_padded) for x in b.drain(1.1)])
        capped = mb.Microbatcher(max_batch=512, max_delay=0.0, min_bucket=8, max_bucket=128)
        for rid in range(300):
            capped.submit(rid, np.zeros(3, np.int32), now=0.0)
        blocks = []
        while (x := capped.pop_block(0.0)) is not None:
            blocks.append((x.n_real, x.n_padded, x.trigger))
        log.append(blocks)
        log.append(capped.retune(max_batch=32, max_delay=0.001))
        log.append(capped.retune(max_bucket=None))
        log.append(capped.retune(max_batch=16))
        for arrival in (0.1234567, 17.77777, 1e6 + 0.333):
            capped.submit(0, np.zeros(2, np.int32), now=arrival)
            log.append(capped.pop_block(capped.next_deadline()) is not None)
        return log

    log = _both(scenario)
    assert log[0][0] is False and log[0][2] is None
    assert log[1][0] == "deadline" and log[1][2:4] == (3, 8)
    assert log[2] == ("size", (3, 4, 5, 6))
    assert [b[0] for b in log[4]] == [128, 128, 44]


def test_admission_decisions():
    def scenario(serve, mb, met):
        def rec(x):
            return None if x is None else (type(x).__name__, x.reason, x.lane, x.tenant,
                                           getattr(x, "retry_at", None))

        log = []
        for on_full in ("shed", "block"):
            ctl = serve.AdmissionController(queue_limit=4, batch_watermark=0.5, on_full=on_full)
            ctl.set_rate("alice", "interactive", rate=1.0, burst=1.0)
            ctl.set_rate("*", "batch", rate=2.0, burst=1.0)
            for t, tenant, lane, depth in [
                (0.0, "alice", "interactive", 0), (0.0, "alice", "interactive", 0),
                (0.0, "bob", "interactive", 3), (0.0, "bob", "interactive", 4),
                (0.0, "bob", "batch", 1), (0.0, "carol", "batch", 2), (0.1, "bob", "batch", 0),
                (1.1, "alice", "interactive", 0), (2.0, "dan", "batch", 0),
            ]:
                log.append(rec(ctl.admit(tenant=tenant, lane=lane, now=t, queue_depth=depth)))
            ctl.set_pressure(True)
            log.append(rec(ctl.admit(tenant="eve", lane="batch", now=3.0, queue_depth=0)))
            log.append(ctl.describe())
        tb = serve.TokenBucket(rate=10.0, burst=2.0)
        log.append([tb.take(0.0), tb.take(0.0), tb.take(0.0), tb.peek(0.05),
                    tb.next_token_at(0.05), tb.take(0.1), tb.peek(100.0)])
        return log

    log = _both(scenario)
    assert log[1] == ("Shed", "rate_limited", "interactive", "alice", None)
    assert log[3] == ("Shed", "queue_full", "interactive", "bob", None)


def test_policy_decisions_on_one_clock():
    def scenario(serve, mb, met):
        clock = ManualClock()
        policy = serve.AdaptiveBatchPolicy(slo_p99_s=0.1, interval_s=1.0, min_samples=1,
                                           cooldown_intervals=2)
        batcher = mb.Microbatcher(max_batch=64, max_delay=0.005, min_bucket=8, max_bucket=128)
        hist = met.Histogram("serve.recent.request_s", window_s=policy.window_s, n_windows=4,
                             clock=clock)
        metrics = met.Metrics()
        admission = serve.AdmissionController(queue_limit=16)
        policy.bind(batchers=[batcher], request_hist=hist, metrics=lambda: metrics,
                    admission=admission)
        log = []
        for t, value, n in [(0.0, 0.5, 8), (20.0, 0.01, 8), (21.0, 0.5, 64), (23.0, 0.5, 1),
                            (40.0, 0.1, 8), (60.0, 0.01, 8), (61.0, 0.01, 1), (62.0, 0.01, 1),
                            (63.0, 0.01, 1), (64.0, 0.01, 1), (64.5, 0.01, 1)]:
            clock.t = t
            for _ in range(n):
                hist.observe(value)
            log.append((policy.tick(t), batcher.max_batch, batcher.max_delay, admission.pressure))
        log.append(policy.describe())
        log.append(metrics.summary()["counters"])
        return log

    log = _both(scenario)
    assert [x[0] for x in log[:4]] == ["tighten", "relax", "damped", "tighten"]
    assert log[-2]["oscillation_violations"] == 0


def test_service_with_stub_session_on_one_clock():
    def scenario(serve, mb, met):
        clock = ManualClock()
        session = StubSession()
        registry = met.Metrics()
        policy = serve.AdaptiveBatchPolicy(slo_p99_s=0.05, interval_s=0.5, min_samples=4)
        service = serve.RetrievalService(
            {"stub": session}, max_batch=8, max_delay=0.01, min_bucket=8, clock=clock,
            registry=registry, policy=policy,
            admission=serve.AdmissionController(queue_limit=12, batch_watermark=0.25),
        )
        log = [service.ready_at(0.0)]
        for step in range(6):
            clock.t = step * 1.0
            for i in range(5):
                out = service.try_submit(np.full(3, 10 * step + i, np.int32),
                                         lane="batch" if i == 4 else "interactive")
                log.append((type(out).__name__, getattr(out, "rid", None),
                            getattr(out, "reason", None)))
            log.append(service.ready_at(clock.t))
            clock.t = step * 1.0 + 0.9
            got = service.poll(limit=1 if step % 2 else None)
            log.append(sorted((rid, r.scores.tobytes(), r.ids.tobytes()) for rid, r in got.items()))
        log.append(sorted(service.drain()))
        log.append([(r.kind, r.n_real, r.n_padded, r.trigger, r.queue_wait_s)
                    for r in service.metrics])
        log.append((session.block_sizes, policy.describe()["effective"]))
        summary = registry.summary()
        log.append(summary["counters"])
        log.append(summary["histograms"]["serve.queue_wait_s"]["count"])
        return log

    log = _both(scenario)
    assert log[-2]["serve.requests"] > 0


def test_open_loop_generator_replays_the_same_run():
    def scenario(serve, mb, met):
        log = [serve.poisson_schedule(100.0, 50, seed=7).tobytes(),
               serve.burst_schedule(100.0, 50, seed=7, burst_factor=4.0, duty=0.25).tobytes()]
        clock = serve.VirtualClock()
        session = StubSession()
        service = serve.RetrievalService(
            {"stub": session}, max_batch=8, max_delay=0.002, min_bucket=8, clock=clock,
            registry=met.Metrics(),
            admission=serve.AdmissionController(queue_limit=4, on_full="shed"),
        )
        queries = np.arange(60, dtype=np.int32).reshape(60, 1) * np.ones((1, 3), np.int32)
        res = serve.run_open_loop(service, clock, serve.poisson_schedule(5000.0, 60, seed=3),
                                  queries, kind="stub")
        log.append((res.n_offered, res.n_completed, res.shed_rate, sorted(res.rid_of.items()),
                    sorted(res.completions.items()), [(i, s.reason) for i, s in res.shed],
                    res.duration_s, res.latency_quantiles()))
        metered = serve.MeteredSession(StubSession(), clock)
        t0 = clock.t
        metered.search(np.zeros((4, 3), np.int32))
        log.append((metered.kind, metered.k, clock.t > t0))
        return log

    log = _both(scenario)
    assert log[2][1] + len(log[2][5]) == 60


# ---------------------------------------------------------------- sessions


def _lexical(k, device="cpu", vocab=256, n_docs=512, chunk=64):
    corpus = ref_synthetic.make_corpus(n_docs=n_docs, vocab=vocab, max_len=24, seed=0)
    stats = ref_anchors.collection_stats(jnp.asarray(corpus.tokens), jnp.asarray(corpus.lengths),
                                         vocab=vocab, chunk_size=chunk)
    ref = ref_serve.LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", k=k + DEEPER,
                                   chunk_size=chunk, stats=stats)
    port = port_serve.LexicalSession(
        corpus.tokens, corpus.lengths, "ql_lm", k=k, chunk_size=chunk,
        stats=convert.stats_from_numpy([np.asarray(x) for x in stats]), device=device,
    )
    return corpus, ref, port


@pytest.mark.parametrize("token_pack", ["auto", "16", "bitpack"])
def test_packed_lexical_session_answers_as_the_unpacked_one(token_pack):
    """A packed resident corpus gives the unpacked session's answers bit for
    bit and the reference's packed session's under the parity rule; its
    resolved mode and resident bytes are the reference's."""
    k, chunk, vocab = 10, 64, 3000
    corpus = ref_synthetic.make_corpus(n_docs=512, vocab=vocab, max_len=24, seed=1)
    stats = ref_anchors.collection_stats(jnp.asarray(corpus.tokens), jnp.asarray(corpus.lengths),
                                         vocab=vocab, chunk_size=chunk)
    ref = ref_serve.LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", k=k + DEEPER,
                                   chunk_size=chunk, stats=stats, token_pack=token_pack)
    port_stats = convert.stats_from_numpy([np.asarray(x) for x in stats])
    packed = port_serve.LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", k=k,
                                       chunk_size=chunk, stats=port_stats,
                                       token_pack=token_pack, device="cpu")
    plain = port_serve.LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", k=k,
                                      chunk_size=chunk, stats=port_stats, device="cpu")
    assert packed.pack_mode == ref.pack_mode == ("bitpack" if token_pack == "bitpack" else "u16")
    assert packed.resident_corpus_bytes == ref.resident_corpus_bytes
    assert packed.resident_corpus_bytes < plain.resident_corpus_bytes == 512 * 24 * 4 + 512 * 4
    queries = ref_mb.pad_rows(synthetic.make_queries(corpus, n_queries=13, seed=3), 16,
                              plain.pad_value)
    got, base = packed.search(queries), plain.search(queries)
    assert torch.equal(got.ids, base.ids)
    assert torch.equal(got.scores.view(torch.int32), base.scores.view(torch.int32))
    want = ref.search(queries)
    assert_rankings_close(got.scores, got.ids, np.asarray(want.scores), np.asarray(want.ids),
                          what=f"packed lexical session {token_pack}")


def _serve(session, kind, queries, **kw):
    clock = ManualClock()
    service = port_serve.RetrievalService({kind: session}, clock=clock, **kw)
    rids = [service.submit(q, kind) for q in queries]
    out = service.poll()
    clock.t += 1.0
    out.update(service.poll())
    out.update(service.drain())
    assert sorted(out) == rids
    return service, np.stack([out[r].scores for r in rids]), np.stack([out[r].ids for r in rids])


def test_lexical_session_dispatch_matches_reference_session():
    corpus, ref, port = _lexical(k=10)
    queries = synthetic.make_queries(corpus, n_queries=13, seed=3)
    service, s, i = _serve(port, "lexical", queries, max_batch=64, max_delay=0.01)
    want = ref.search(ref_mb.pad_rows(queries, 16, ref.pad_value))
    assert_rankings_close(s, i, np.asarray(want.scores)[:13], np.asarray(want.ids)[:13],
                          what="lexical session")
    rec = service.metrics[-1]
    assert rec.trigger == "deadline" and rec.n_real == 13 and rec.n_padded == 16
    assert port.n_docs == 512 and port.pack_mode == "none"
    assert port.resident_corpus_bytes == 512 * 24 * 4 + 512 * 4
    # search returns host tensors
    st = port.search(ref_mb.pad_rows(queries, 16, port.pad_value))
    assert st.scores.device.type == "cpu" and st.ids.dtype == torch.int32


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["dense_dot", "dense_cosine"])
def test_dense_session_dispatch_matches_reference_session(use_kernel, name):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((512, 64)).astype(np.float32)
    queries = rng.standard_normal((11, 64)).astype(np.float32)
    port = port_serve.DenseSession(vecs, name, k=9, chunk_size=128, use_kernel=use_kernel,
                                   device="cpu")
    _, s, i = _serve(port, "dense", queries, max_batch=11, max_delay=10.0)
    # the reference's kernel path drops the cosine row map (test_torch_scan_dense):
    # cosine is held against its host fold
    ref = ref_serve.DenseSession(vecs, name, k=9 + DEEPER, chunk_size=128,
                                 use_kernel=use_kernel and name == "dense_dot")
    want = ref.search(queries)
    assert_rankings_close(s, i, want.scores, want.ids, what=f"{name} use_kernel={use_kernel}")
    oracle = port_serve.DenseSession(vecs, name, k=9, chunk_size=128, device="cpu")
    st = oracle.search(queries)
    assert np.array_equal(st.ids.numpy(), i) and np.array_equal(st.scores.numpy(), s)
    assert port.n_docs == 512 and port.dim == 64


def test_every_query_answered_exactly_once_across_waves():
    rng = np.random.default_rng(1)
    session = port_serve.DenseSession(rng.standard_normal((256, 32)).astype(np.float32),
                                      "dense_dot", k=5, chunk_size=64, device="cpu")
    clock = ManualClock()
    service = port_serve.RetrievalService({"dense": session}, max_batch=8, max_delay=0.1,
                                          clock=clock)
    answered, submitted = {}, []
    for _ in range(3):
        for _ in range(11):  # 11 per wave: one size-triggered block + remainder
            submitted.append(service.submit(rng.standard_normal(32).astype(np.float32)))
        answered.update(service.poll())
        clock.t += 0.2
    answered.update(service.poll())
    answered.update(service.drain())
    assert sorted(answered) == sorted(submitted)
    assert all(len(r.scores) == 5 for r in answered.values())


def test_completed_requests_byte_identical_under_shedding_and_qos():
    """Policy, admission and QoS shedding change which requests complete and
    when, never the bytes of any that do."""
    corpus, _, session = _lexical(k=8, vocab=512, n_docs=256)
    queries = synthetic.make_queries(corpus, n_queries=48, seed=9)
    oracle_service = port_serve.RetrievalService({"lexical": session}, max_batch=64,
                                                 max_delay=60.0)
    for q in queries:
        oracle_service.submit(q, "lexical")
    oracle = oracle_service.drain()
    clock = ManualClock()
    policy = port_serve.AdaptiveBatchPolicy(slo_p99_s=0.01, interval_s=0.01, min_samples=2)
    service = port_serve.RetrievalService(
        {"lexical": session}, max_batch=8, max_delay=0.005, min_bucket=8, clock=clock,
        registry=Metrics(), policy=policy,
        admission=port_serve.AdmissionController(queue_limit=6, batch_watermark=0.5),
    )
    completed, rid_to_qidx, n_shed = {}, {}, 0
    for i, q in enumerate(queries):
        out = service.try_submit(q, "lexical", lane="batch" if i % 4 == 3 else "interactive",
                                 tenant=f"t{i % 2}")
        if out.admitted:
            rid_to_qidx[out.rid] = i
        else:
            n_shed += 1
        clock.t += 0.002
        if i % 4 == 3:
            completed.update(service.poll())
    clock.t += 1.0
    completed.update(service.poll())
    completed.update(service.drain())
    assert n_shed > 0 and len(completed) == len(rid_to_qidx)
    for rid, res in completed.items():
        want = oracle[rid_to_qidx[rid]]
        assert (res.scores.tobytes(), res.ids.tobytes()) == (want.scores.tobytes(),
                                                             want.ids.tobytes())
    assert policy.oscillation_violations == 0


def test_sweep_and_bench_json_name_the_device(tmp_path):
    corpus, _, session = _lexical(k=4, n_docs=256)
    payload = bench.sweep_batch_sizes(
        session, lambda n, seed: synthetic.make_queries(corpus, n_queries=n, seed=seed),
        (2, 8), repeats=1, warmup=0,
    )
    assert [pt["batch"] for pt in payload["curve"]] == [2, 8]
    assert payload["kind"] == "lexical" and payload["n_docs"] == 256 and "amortization_x" in payload
    path = bench.write_bench_json(payload, str(tmp_path / "b.json"))
    with open(path) as f:
        data = json.load(f)
    assert data["provenance"]["torch_version"] == torch.__version__
    assert data["provenance"]["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert set(data["tuning"]) == {"config_hash", "source", "cache_hit"}  # the reference's keys


def test_what_waits_for_later_slices_says_so():
    # the sharded session runs now (the mesh slice): it validates as the
    # reference's does
    tokens = np.zeros((64, 4), np.int32)
    lens = np.full(64, 4, np.int32)
    with pytest.raises(ValueError, match="need stats or vocab"):
        port_serve.ShardedLexicalSession(_mesh((1,), ("data",)), tokens, lens, "ql_lm", k=1,
                                         chunk_size=64)
    # packed resident corpora run now (the packing slice), from the argument
    # or from the active tuning's knob
    packed = port_serve.LexicalSession(tokens, lens, "ql_lm", k=2, chunk_size=64, vocab=8,
                                       token_pack="auto", device="cpu")
    assert packed.pack_mode == "u8" and packed.resident_corpus_bytes == 64 * 4 + 64 * 4
    from repro_torch import tune

    with tune.use(tune.TuningConfig(token_pack="16")):
        tuned = port_serve.LexicalSession(tokens, lens, "ql_lm", k=2, chunk_size=64, vocab=8,
                                          device="cpu")
    assert tuned.pack_mode == "u16" and tuned.resident_corpus_bytes == 64 * 4 * 2 + 64 * 4
    with pytest.raises(ValueError, match="not dense"):
        port_serve.DenseSession(np.zeros((64, 4), np.float32), "bm25", k=2, chunk_size=64,
                                device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        port_serve.DenseSession(np.zeros((60, 4), np.float32), k=2, chunk_size=64, device="cpu")


# ------------------------------------------ sharded sessions (the mesh)


def _mesh(shape, names):
    from repro_torch.distributed.sharding import Mesh

    arr = np.empty(shape, dtype=object)
    arr.fill(torch.device("cpu"))
    return Mesh(arr, names)


SHARDED_MESHES = [((1, 1), ("data", "model")), ((4,), ("data",)), ((2, 2), ("data", "model"))]


@pytest.mark.parametrize("token_pack", ["none", "auto"])
@pytest.mark.parametrize("shape,names", SHARDED_MESHES)
def test_sharded_session_matches_resident_session(shape, names, token_pack):
    """The counterpart of the reference's test_cluster.py sharded-session
    test: rows bit-identical to the resident single-device session's, packed
    or not, at every mesh shape; a shard is a view of the one resident
    corpus, so the resident bytes are the single session's."""
    corpus, _, base = _lexical(k=10)
    stats = base._stats
    sharded = port_serve.ShardedLexicalSession(
        _mesh(shape, names), corpus.tokens, corpus.lengths, "ql_lm", k=10, chunk_size=64,
        stats=stats, token_pack=token_pack)
    plain = port_serve.LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", k=10,
                                      chunk_size=64, stats=stats, token_pack=token_pack,
                                      device="cpu")
    assert sharded.n_docs == base.n_docs and sharded.pack_mode == plain.pack_mode
    assert sharded.resident_corpus_bytes == plain.resident_corpus_bytes
    assert sharded.plan.n_shards == int(np.prod(shape))
    q = ref_mb.pad_rows(synthetic.make_queries(corpus, n_queries=13, seed=3), 16, PAD)
    a, b = base.search(q), sharded.search(q)
    assert b.ids.shape == (16, 10) and b.scores.device.type == "cpu"
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.scores.view(torch.int32), b.scores.view(torch.int32))
    # the statistics derived over the mesh from the vocab are the given ones
    derived = port_serve.ShardedLexicalSession(
        _mesh(shape, names), corpus.tokens, corpus.lengths, "ql_lm", k=10, chunk_size=64,
        vocab=256, token_pack=token_pack)
    c = derived.search(q)
    assert torch.equal(c.ids, a.ids) and torch.equal(c.scores, a.scores)


PAD = port_serve.LexicalSession.pad_value


def test_sharded_session_serves_through_dispatcher():
    from repro_torch.core import scan
    from repro_torch.core.scoring import get_scorer

    corpus, _, base = _lexical(k=10)
    session = port_serve.ShardedLexicalSession(
        _mesh((2, 2), ("data", "model")), corpus.tokens, corpus.lengths, "bm25", k=10,
        chunk_size=64, stats=base._stats)
    svc = port_serve.RetrievalService({"lexical": session}, max_batch=4, max_delay=0.0)
    queries = synthetic.make_queries(corpus, n_queries=4, seed=5)
    rids = [svc.submit(q) for q in queries]
    results = svc.poll() or svc.drain()
    want = scan.search_local_multi(
        torch.tensor(queries), (torch.tensor(corpus.tokens), torch.tensor(corpus.lengths)),
        [get_scorer("bm25")], k=10, chunk_size=64, stats=base._stats)
    for row, rid in enumerate(rids):
        np.testing.assert_array_equal(results[rid].ids, want.ids[0, row].numpy())


def test_sharded_session_validates():
    corpus, _, _ = _lexical(k=4)
    mesh = _mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="not lexical"):
        port_serve.ShardedLexicalSession(mesh, corpus.tokens, corpus.lengths, "dense_dot",
                                         k=4, chunk_size=64, vocab=256)
    with pytest.raises(ValueError, match="need stats or vocab"):
        port_serve.ShardedLexicalSession(mesh, corpus.tokens, corpus.lengths, "ql_lm", k=4,
                                         chunk_size=64)
    with pytest.raises(ValueError, match="not a multiple"):
        port_serve.ShardedLexicalSession(_mesh((16,), ("data",)), corpus.tokens,
                                         corpus.lengths, "ql_lm", k=4, chunk_size=64,
                                         vocab=256)


@pytest.mark.parametrize("token_pack", ["none", "auto"])
def test_sharded_session_behind_admission_byte_identical(token_pack):
    """The counterpart of the reference's sharded-session script
    (tests/test_serve_policy.py): a 4-shard session behind admission, the
    adaptive policy, QoS lanes and forced shedding returns, for every
    admitted request, the bytes of the unthrottled single-device oracle."""
    corpus = synthetic.make_corpus(n_docs=512, vocab=512, max_len=24, seed=0)
    sharded = port_serve.ShardedLexicalSession(
        _mesh((4,), ("data",)), corpus.tokens, corpus.lengths, "ql_lm", k=8, chunk_size=64,
        vocab=512, token_pack=token_pack)
    single = port_serve.LexicalSession(corpus.tokens, corpus.lengths, "ql_lm", k=8,
                                       chunk_size=64, vocab=512, device="cpu")
    queries = synthetic.make_queries(corpus, n_queries=40, seed=4)
    oracle_service = port_serve.RetrievalService({"lexical": single}, max_batch=64,
                                                 max_delay=60.0)
    for q in queries:
        oracle_service.submit(q, "lexical")
    oracle = oracle_service.drain()
    clock = ManualClock()
    policy = port_serve.AdaptiveBatchPolicy(slo_p99_s=0.01, interval_s=0.01, min_samples=2)
    admission = port_serve.AdmissionController(queue_limit=5, batch_watermark=0.4,
                                               on_full="shed")
    service = port_serve.RetrievalService(
        {"lexical": sharded}, max_batch=8, max_delay=0.005, min_bucket=8, clock=clock,
        registry=Metrics(), admission=admission, policy=policy)
    completed, rid_to_qidx, n_shed = {}, {}, 0
    for i, q in enumerate(queries):
        out = service.try_submit(q, "lexical", lane="batch" if i % 4 == 0 else "interactive")
        if out.admitted:
            rid_to_qidx[out.rid] = i
        else:
            n_shed += 1
        clock.t += 0.002
        completed.update(service.poll())
    clock.t += 1.0
    completed.update(service.poll())
    completed.update(service.drain())
    assert n_shed > 0 and len(completed) == len(rid_to_qidx)
    for rid, res in completed.items():
        want = oracle[rid_to_qidx[rid]]
        assert (res.scores.tobytes(), res.ids.tobytes()) == (want.scores.tobytes(),
                                                             want.ids.tobytes())
    assert policy.oscillation_violations == 0


# ------------------------------------------------------- blocks in flight


class Launch:
    """A launched block whose completion the test sets."""

    def __init__(self, state):
        self.state, self.finished = state, False

    def done(self):
        return self.finished


class LaunchingSession(StubSession):
    """`StubSession`'s rows, with ``launch``/``collect``: a launch returns at
    once, ``done`` turns true when the test finishes it, and ``collect``
    waits (here: finishes it) as a card's session does."""

    def __init__(self):
        super().__init__()
        self.launched = []

    def launch(self, q):
        handle = Launch(self.search(q))
        self.launched.append(handle)
        return handle

    def collect(self, handle):
        handle.finished = True
        return handle.state

    def finish(self, n=None):
        for h in self.launched if n is None else self.launched[:n]:
            h.finished = True


def _in_flight_service(**kw):
    clock = ManualClock()
    session = LaunchingSession()
    registry = Metrics()
    service = port_serve.RetrievalService(
        {"stub": session}, max_batch=4, max_delay=0.005, min_bucket=4, clock=clock,
        registry=registry, **kw)
    return service, session, clock, registry


def _submit(service, n, start=0):
    return [service.submit(np.full(3, start + i, np.int32)) for i in range(n)]


def test_poll_returns_while_a_block_is_in_flight_and_admits_meanwhile():
    service, session, clock, _ = _in_flight_service()
    rids = _submit(service, 4)
    assert service.poll() == {} and len(session.launched) == 1
    assert service.ready_at(clock.t) == clock.t  # never None while a block is in flight
    clock.t += 0.001
    out = service.try_submit(np.full(3, 9, np.int32))
    assert out.admitted and service.pending() == 1
    assert service.ready_at(clock.t) == clock.t and service.poll(limit=1) == {}
    session.finish()
    got = service.poll(limit=1)
    assert sorted(got) == rids and len(session.launched) == 1
    # nothing is in flight now: the lone request waits for its deadline
    assert service.ready_at(clock.t) == pytest.approx(0.006)


def test_a_full_block_launches_behind_the_running_one_never_a_second():
    service, session, clock, registry = _in_flight_service()
    rids = _submit(service, 12)
    assert service.poll() == {}
    assert len(session.launched) == 2 and service.pending() == 4
    clock.t += 1.0
    assert service.poll() == {} and len(session.launched) == 2
    session.finish(1)
    got = service.poll(limit=1)
    assert sorted(got) == rids[:4] and len(session.launched) == 2
    # the next poll gives the answered block's slot to the queued full
    # block, behind the second
    assert service.poll() == {}
    assert len(session.launched) == 3 and service.pending() == 0
    assert registry.summary()["counters"]["serve.launched_behind"] == 2
    session.finish()
    got = service.poll()
    assert sorted(got) == rids[4:]
    assert [r.trigger for r in service.metrics] == ["size"] * 3


def test_a_partial_block_past_its_deadline_waits_for_the_running_block():
    service, session, clock, _ = _in_flight_service()
    _submit(service, 4)
    service.poll()
    late = _submit(service, 2, start=4)
    clock.t += 0.010  # the partial block's deadline passes while block 0 runs
    assert service.ready_at(clock.t) == clock.t
    assert service.poll() == {} and len(session.launched) == 1
    late += _submit(service, 1, start=6)  # it stays open and gathers
    session.finish()
    got = service.poll()
    # block 0 answered, then the partial block launched at once
    assert len(got) == 4 and len(session.launched) == 2
    assert session.block_sizes[-1] == 4 and service.pending() == 0
    session.finish()
    assert sorted(service.poll()) == late
    rec = service.metrics[-1]
    assert (rec.n_real, rec.trigger) == (3, "deadline")


def test_a_partial_block_that_fills_behind_the_running_block_launches_behind_it():
    service, session, clock, _ = _in_flight_service()
    _submit(service, 4)
    service.poll()
    _submit(service, 3, start=4)
    clock.t += 0.010
    service.poll()
    assert len(session.launched) == 1
    _submit(service, 1, start=7)
    service.poll()
    assert len(session.launched) == 2 and service.metrics == []


def test_drain_returns_every_in_flight_reply():
    service, session, clock, _ = _in_flight_service()
    rids = _submit(service, 10)
    assert service.poll() == {} and len(session.launched) == 2
    got = service.drain()
    assert sorted(got) == rids and len(session.launched) == 3
    assert all(h.finished for h in session.launched)
    assert service.ready_at(clock.t) is None
    assert [r.n_real for r in service.metrics] == [4, 4, 2]


def test_in_flight_replies_are_the_synchronous_paths_bytes():
    """Requests admitted and blocks finished in a seeded order give, request
    by request, the bytes the synchronous path gives for the same queries;
    the dispatch spans say which blocks launched behind another."""
    rng = np.random.default_rng(5)
    queries = rng.integers(0, 1000, size=(60, 3)).astype(np.int32)
    sync = port_serve.RetrievalService({"stub": StubSession()}, max_batch=64, max_delay=60.0)
    for q in queries:
        sync.submit(q)
    want = sync.drain()
    service, session, clock, registry = _in_flight_service()
    got, rid_of = {}, {}
    with obs.session() as (tr, _):
        for i, q in enumerate(queries):
            rid_of[service.submit(q)] = i
            clock.t += 0.002
            if rng.random() < 0.3:
                session.finish(int(rng.integers(0, len(session.launched) + 1)))
            got.update(service.poll(limit=int(rng.integers(1, 3))))
        got.update(service.drain())
    assert sorted(got) == sorted(rid_of)
    for rid, res in got.items():
        w = want[rid_of[rid]]
        assert (res.scores.tobytes(), res.ids.tobytes()) == (w.scores.tobytes(), w.ids.tobytes())
    dispatches = tr.spans("serve.dispatch")
    behind = sum(d.attrs["behind"] for d in dispatches)
    assert len(dispatches) == len(service.metrics) == len(session.launched)
    assert 0 < behind == registry.summary()["counters"]["serve.launched_behind"]


def test_a_metered_lexical_session_stays_synchronous():
    """`loadgen.MeteredSession` delegates every attribute, the wrapped
    session's ``launch`` too; the service still searches through it, so the
    virtual clock advances on every block, and a CPU session's own launches
    complete within the poll that makes them."""
    corpus, _, session = _lexical(k=4, n_docs=256)
    queries = synthetic.make_queries(corpus, n_queries=16, seed=2)
    clock = port_serve.VirtualClock()
    metered = port_serve.MeteredSession(session, clock)
    assert callable(metered.launch)
    service = port_serve.RetrievalService({"lexical": metered}, max_batch=8, max_delay=1.0,
                                          min_bucket=8, clock=clock, registry=Metrics())
    for q in queries:
        service.submit(q)
    for block in range(2):
        t = clock.t
        got = service.poll(limit=1)
        assert len(got) == 8 and clock.t > t, block
    assert all(r.latency_s > 0 for r in service.metrics) and len(service.metrics) == 2
    plain = port_serve.RetrievalService({"lexical": session}, max_batch=8, registry=Metrics())
    for q in queries:
        plain.submit(q)
    assert len(plain.poll(limit=1)) == 8 and len(plain.poll(limit=1)) == 8
    assert plain.ready_at(0.0) is None
