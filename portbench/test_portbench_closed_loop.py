"""The closed loop on the small cell and on a fake clock: exactly
``outstanding`` requests in flight until the close, every block full, and
``served_qps`` the requests answered inside the window over its seconds."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from portbench.lib import registry
from portbench.lib.smallcell import small
from portbench.test_portbench_open_loop import Clock, Session

drv = registry.load_module("drivers", "closed_loop")
CELL = "cw09b-serve-mqbatch"


class Timed:
    """The small cell's real session, each block taking ``block_s`` on the
    fake clock, so that how many blocks a window holds is the same on any
    CPU, however loaded."""

    def __init__(self, session, clock, block_s):
        self.session, self.clock, self.block_s = session, clock, block_s
        self.pad_value = session.pad_value

    def search(self, q_block):
        out = self.session.search(q_block)
        self.clock.t += self.block_s
        return out


def test_the_small_cell_keeps_its_blocks_full(monkeypatch):
    from repro_torch.serve.service import RetrievalService

    cell = small(registry.resolve(CELL))
    cfg, mix, seconds = cell.config, cell.mix, 0.8
    state = drv.setup(cell, 2**31 + 31, seconds, torch.device("cpu"), {})
    try:
        # the service at the configuration's knobs, over the set-up's session
        # on a fake clock: blocks of 0.25 s, three answered inside the window
        clock = Clock()
        state.service = RetrievalService(
            {"lexical": Timed(state.service.sessions["lexical"], clock, 0.25)},
            max_batch=cfg["serve_max_batch"], max_delay=cfg["serve_max_delay_s"], clock=clock)
        monkeypatch.setattr(drv, "drive", functools.partial(drv.drive, clock=clock,
                                                            sleep=clock.sleep))
        win = drv.run_window(state, seconds)
    finally:
        drv.cleanup(state)
    served, n, block = state.served, mix["outstanding"], cfg["serve_max_batch"]
    records = win.records
    assert n == 256 and n % block == 0
    assert all(r.n_real == r.n_padded == block and r.trigger == "size" for r in records)
    assert win.info["full_blocks"] == len(records)
    # each block answered inside the window found all 256 in flight and was
    # followed by 64 more; so did the block that crossed the close; then
    # the three outstanding blocks drain
    inside, rem = divmod(served.answered_by(seconds), block)
    assert rem == 0 and inside >= 2 and len(records) == inside + n // block
    assert served.in_flight == [n] * (inside + 1) + [n - block * i for i in (1, 2, 3)]
    assert len(served.submit) == n + block * inside and win.failed == 0
    assert win.e2e["served_qps"] == served.answered_by(seconds) / seconds
    assert inside == 3 and len(served.answers) == len(served.submit)


def serve(n_pool, *, outstanding=4, block_s=0.010, close_s=0.1, wait_s=1.0, max_batch=2):
    from repro_torch.serve.service import RetrievalService

    clock = Clock()
    session = Session(clock, block_s)
    service = RetrievalService({"lexical": session}, max_batch=max_batch, max_delay=0.005,
                               min_bucket=1, clock=clock)
    pool = np.arange(n_pool, dtype=np.int32)[:, None].repeat(2, 1)
    served = drv.drive(service, pool, outstanding=outstanding, close_s=close_s, wait_s=wait_s,
                       clock=clock, sleep=clock.sleep)
    return served, session


def test_each_reply_is_followed_by_the_next_query_of_the_pool():
    served, session = serve(5, close_s=0.095)
    # blocks of 2 take 10 ms: nine answer inside the 95 ms window, each
    # followed by two new requests; the close then drains two more blocks
    assert session.blocks == [2] * 11
    assert len(served.submit) == 4 + 2 * 9 and served.answered_by(0.095) == 18
    np.testing.assert_allclose(served.reply[:4], [0.01, 0.01, 0.02, 0.02])
    np.testing.assert_allclose(served.submit[4:6], [0.01, 0.01])
    # request i asks pool row i % 5: the fake session echoes the query
    assert [int(served.answers[i].ids[0]) for i in range(22)] == [i % 5 for i in range(22)]
    assert served.in_flight == [4] * 10 + [2]


def test_an_outstanding_count_off_the_block_closes_on_the_deadline():
    served, session = serve(7, outstanding=3, close_s=0.015)
    # 3 in flight, blocks of 2: once the window has closed, the one left
    # over closes on its deadline
    assert session.blocks == [2, 2, 1] and not np.isnan(served.reply).any()
    assert served.in_flight == [3, 3, 1]


def test_unanswered_requests_fail_at_the_wait():
    served, session = serve(5, block_s=2.0, close_s=0.5, wait_s=1.0)
    # the first block replies at 2.0 s, past the close and its 1 s wait:
    # the loop dispatches no more
    assert session.blocks == [2] and served.answered_by(0.5) == 0
    assert np.isnan(served.reply).sum() == 2 and served.in_flight == [4]
    assert served.reply[:2] == pytest.approx([2.0, 2.0])
