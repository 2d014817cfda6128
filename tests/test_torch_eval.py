"""The port's TREC metrics against the reference's on the same runs and
qrels: every per-query vector and aggregate the same bits."""

import numpy as np
import pytest

from repro.eval import metrics as ref
from repro_torch.eval import metrics as port


def _case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        qrels = np.zeros((16, 4096), bool)
        for i in range(1, 16):  # query 0 has no relevant document
            qrels[i, rng.choice(4096, int(rng.integers(1, 40)), replace=False)] = True
        ids = rng.integers(-1, 4096, (16, 100))
        ids[2, :10] = np.nonzero(qrels[2])[0][:10]
    elif kind == "graded":
        qrels = np.zeros((12, 2048), np.int32)
        for i in range(12):
            qrels[i, rng.choice(2048, 30, replace=False)] = rng.integers(-1, 4, 30)
        ids = rng.integers(-1, 2048, (12, 64))
    else:  # "dense": rows short of zero grades, so the ideal takes a partition
        qrels = rng.integers(-2, 4, (8, 40))
        ids = rng.integers(-1, 40, (8, 30))
    return ids, qrels


@pytest.mark.parametrize("kind, ks", [("binary", (5, 10, 20, 100)), ("graded", (5, 10, 64)),
                                      ("dense", (5, 10, 20, 30))])
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_run_is_the_references(kind, ks, seed):
    ids, qrels = _case(kind, seed)
    got, want = port.evaluate_run(ids, qrels, ks=ks), ref.evaluate_run(ids, qrels, ks=ks)
    assert list(got["per_query"]) == list(want["per_query"])
    for name, v in want["per_query"].items():
        assert got["per_query"][name].tobytes() == np.asarray(v).tobytes(), name
    assert got["aggregate"] == want["aggregate"]
    for k in ks:
        assert port.ndcg_at_k(ids, qrels, k).tobytes() == np.asarray(
            ref.ndcg_at_k(ids, qrels, k)).tobytes()
        assert port.recall_at_k(ids, qrels, k).tobytes() == np.asarray(
            ref.recall_at_k(ids, qrels, k)).tobytes()
