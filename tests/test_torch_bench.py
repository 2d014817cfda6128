"""The models-per-pass amortization curve of the port and its CLI, on the CPU.

The payload has the reference's keys (timings are the CPU's plain versions
here, so only their structure is compared), ``speedup_vs_independent`` is 1
at size 1, and a grid's pass is free: each model's ranking in one 4-model
pass equals its own single-model pass bit for bit (tolerance: none). The
CLI's ``--bench`` writes the curve with the provenance block.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anchors as ref_anchors
from repro.core import scoring as ref_scoring
from repro.experiments import bench as ref_bench
from repro_torch.core import anchors, scan, scoring
from repro_torch.data import synthetic
from repro_torch.experiments import bench
from repro_torch.launch import experiment as cli

N_DOCS, VOCAB, CHUNK, K = 1024, 4096, 256, 20
LAMS = (0.05, 0.15, 0.3, 0.5)


@pytest.fixture(scope="module")
def collection():
    corpus = synthetic.make_corpus(n_docs=N_DOCS, vocab=VOCAB, max_len=64, seed=11)
    queries = synthetic.make_queries(corpus, n_queries=16, seed=12)
    return corpus, queries


def _port_inputs(corpus, queries):
    docs = (torch.as_tensor(corpus.tokens), torch.as_tensor(corpus.lengths))
    stats = anchors.collection_stats(*docs, vocab=VOCAB, chunk_size=CHUNK)
    return torch.as_tensor(queries), docs, stats


def test_curve_has_the_references_keys(collection):
    corpus, queries = collection
    q, docs, stats = _port_inputs(corpus, queries)
    scorers = [scoring.make_variant("ql_lm", lam=lam) for lam in LAMS]
    got = bench.amortization_curve(q, docs, scorers, k=K, chunk_size=CHUNK, stats=stats,
                                   sizes=(4, 1, 2), repeats=1)
    rdocs = (jnp.asarray(corpus.tokens), jnp.asarray(corpus.lengths))
    rstats = ref_anchors.collection_stats(*rdocs, vocab=VOCAB, chunk_size=CHUNK)
    want = ref_bench.amortization_curve(
        jnp.asarray(queries), rdocs, [ref_scoring.make_variant("ql_lm", lam=lam) for lam in LAMS],
        k=K, chunk_size=CHUNK, stats=rstats, sizes=(4, 1, 2), repeats=1,
    )
    assert set(got) == set(want)
    for key in ("benchmark", "kind", "models", "n_docs", "n_queries", "k", "chunk_size", "sizes"):
        assert got[key] == want[key], key
    assert [set(p) for p in got["curve"]] == [set(p) for p in want["curve"]]
    assert [p["models"] for p in got["curve"]] == [1, 2, 4]
    assert got["curve"][0]["speedup_vs_independent"] == 1.0
    assert all(p["wall_s"] > 0 for p in got["curve"])
    assert got["amortization_x"] == got["curve"][0]["s_per_model"] / got["curve"][-1]["s_per_model"]


def test_curve_needs_enough_scorers(collection):
    q, docs, stats = _port_inputs(*collection)
    with pytest.raises(ValueError, match="need 8 scorer variants"):
        bench.amortization_curve(q, docs, [scoring.get_scorer("ql_lm")], k=K, chunk_size=CHUNK,
                                 stats=stats, sizes=(1, 8))


def test_a_grid_pass_is_the_single_passes(collection):
    """The amortization is free: each model's ranking in one 4-model pass is
    its own single-model pass's, bit for bit."""
    q, docs, stats = _port_inputs(*collection)
    scorers = [scoring.make_variant("ql_lm", lam=lam) for lam in LAMS[:2]] + [
        scoring.make_variant("bm25"), scoring.make_variant("tfidf")]
    multi = scan.search_local_multi(q, docs, tuple(scorers), k=K, chunk_size=CHUNK, stats=stats)
    for m, s in enumerate(scorers):
        single = scan.search_local(q, docs, s, k=K, chunk_size=CHUNK, stats=stats)
        assert torch.equal(multi.ids[m], single.ids), s.name
        assert multi.scores[m].numpy().tobytes() == single.scores.numpy().tobytes(), s.name


def test_cli_bench_writes_the_curve(tmp_path, capsys):
    bench_out = tmp_path / "BENCH_experiments.json"
    cli.main(["--experiment", "smoke", "--out", str(tmp_path / "out"), "--device", "cpu",
              "--no-trace", "--bench", "--bench-sizes", "1", "2", "4",
              "--bench-out", str(bench_out)])
    printed = capsys.readouterr().out
    assert "4 models/pass" in printed and "amortization" in printed
    payload = json.loads(bench_out.read_text())
    assert payload["benchmark"] == "experiments_amortization"
    assert payload["sizes"] == [1, 2, 4] and payload["n_docs"] == 512
    # the CLI's grid: QL-LM smoothing points spread over the largest size
    lams = [0.05 + 0.9 * i / 4 for i in range(4)]
    assert payload["models"] == [scoring.make_variant("ql_lm", lam=round(x, 4)).name
                                 for x in lams]
    assert payload["provenance"]["backend"] in ("cpu", "cuda")
    assert payload["tuning"]["cache_hit"] is False
    assert payload["curve"][0]["speedup_vs_independent"] == 1.0
