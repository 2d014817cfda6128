"""The check on the CPU at a small size: a sound run is correct; the
control (the reference in bfloat16) and each fault planted under the timed
path make ``correct`` false."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import bench
from portbench.lib import registry
from portbench.lib.smallcell import small

SERVE = "cw09b-serve-steady"
CELLS = [SERVE, "cw09b-serve-mqbatch"]


def run(name: str, seed: int = 2**31 + 17, seconds: float = 0.3):
    cell = small(registry.resolve(name))
    out = bench.run_cell(cell, seed=seed, seconds=seconds, trace=False,
                         device=torch.device("cpu"), t_start=time.monotonic())
    return out.result


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_fails(name, seed):
    cell = small(registry.resolve(name))
    driver = registry.load_module("drivers", cell.mix["driver"])
    state = driver.setup(cell, seed, 0.3, torch.device("cpu"), {})
    try:
        win = driver.run_window(state, 0.3)
        driver.release(state)
        sound = driver.check(state, win)
        control = driver.check(state, win, control=True)
    finally:
        driver.cleanup(state)
    assert all(r.ok for r in sound)
    failed = [r.name for r in control if not r.ok]
    assert {"stats_diff", "score_gap"} <= set(failed), control


def _wrap_kernel(monkeypatch, alter):
    from repro_torch.kernels import ops

    real = ops.lexical_scan_topk

    def broken(*args, **kw):
        scores, ids = real(*args, **kw)
        return alter(scores.clone(), ids.clone())

    monkeypatch.setattr(ops, "lexical_scan_topk", broken)


def _half_left_out(scores, ids):
    """The first half of a call's queries (rounded up) get no answer: the
    rows of real queries come first, so every block loses one or more."""
    half = (scores.shape[1] + 1) // 2
    scores[:, :half] = float("-inf")
    ids[:, :half] = -1
    return scores, ids


def _answer_altered(scores, ids):
    scores[..., 0, 0] += 1.0
    return scores, ids


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("alter", [_half_left_out, _answer_altered])
def test_kernel_fault_fails(monkeypatch, name, alter):
    _wrap_kernel(monkeypatch, alter)
    assert not run(name)["correct"]



@pytest.mark.parametrize("name", CELLS)
def test_serve_block_returning_its_state_fails(monkeypatch, name):
    from repro_torch.core import topk
    from repro_torch.serve import session

    def unchanged(self, q_block):
        n, k = len(q_block), self.k
        return topk.TopKState(scores=torch.full((n, k), float("-inf")),
                              ids=torch.full((n, k), -1, dtype=torch.int32))

    monkeypatch.setattr(session.LexicalSession, "search", unchanged)
    r = run(name)
    assert not r["correct"]



@pytest.mark.parametrize("name", CELLS)
def test_stats_altered_fails(monkeypatch, name):
    from repro_torch.core import anchors

    real = anchors.collection_stats

    def altered(*args, **kw):
        st = real(*args, **kw)
        cf = st.cf.clone()
        cf[0] += 1
        return st._replace(cf=cf)

    monkeypatch.setattr(anchors, "collection_stats", altered)
    r = run(name)
    assert not r["correct"] and r["check"]["stats_diff"]["value"] >= 1
