"""The wall-clock open loop's due-time accounting, on a fake clock: the
real service and microbatcher, a session that takes a fixed time a block."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.lib import registry

drv = registry.load_module("drivers", "open_loop")


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        assert dt > 0
        self.t += dt


class Session:
    kind = "lexical"
    pad_value = -1
    k = 3

    def __init__(self, clock, block_s):
        self.clock, self.block_s, self.blocks = clock, block_s, []

    def search(self, q_block):
        from repro_torch.core import topk

        self.blocks.append(len(q_block))
        self.clock.t += self.block_s
        n = len(q_block)
        ids = torch.as_tensor(np.asarray(q_block)[:, :1].repeat(self.k, 1), dtype=torch.int32)
        return topk.TopKState(scores=torch.zeros((n, self.k)), ids=ids)


def serve(due, *, max_batch=2, delay=0.005, block_s=0.010, close_s=1.0, wait_s=1.0):
    from repro_torch.serve.service import RetrievalService

    clock = Clock()
    session = Session(clock, block_s)
    service = RetrievalService({"lexical": session}, max_batch=max_batch, max_delay=delay,
                               min_bucket=1, clock=clock)
    queries = np.arange(len(due), dtype=np.int32)[:, None].repeat(2, 1)
    served = drv.drive(service, queries, np.asarray(due), close_s=close_s, wait_s=wait_s,
                       clock=clock, sleep=clock.sleep)
    return served, session, service


def test_latency_runs_from_the_due_time():
    served, session, _ = serve([0.0, 0.001, 0.002, 0.1])
    # r0, r1 fill a block at 0.001 (size trigger) and reply at 0.011; r2 is
    # submitted at 0.011, 9 ms late, waits out its 5 ms deadline and replies
    # at 0.026; r3 arrives alone at 0.1 and replies at 0.115
    np.testing.assert_allclose(served.reply, [0.011, 0.011, 0.026, 0.115], atol=1e-9)
    np.testing.assert_allclose(served.submit, [0.0, 0.001, 0.011, 0.1], atol=1e-9)
    lat = drv.latencies_ms(served, 1.0, 1.0)
    np.testing.assert_allclose(lat, [11.0, 10.0, 24.0, 15.0], atol=1e-6)
    assert session.blocks == [2, 1, 1]
    # each answer is its own request's: the fake session echoes the query
    assert [int(served.answers[i].ids[0]) for i in range(4)] == [0, 1, 2, 3]


def test_a_stall_counts_against_every_request_it_delays():
    due = np.arange(10) * 0.001  # 1 a ms; blocks of 2 take 50 ms each
    served, _, _ = serve(due, block_s=0.050)
    lat = drv.latencies_ms(served, 1.0, 1.0)
    assert np.all(np.diff(served.reply) >= 0)
    assert lat[-1] == pytest.approx((served.reply[-1] - 0.009) * 1e3)
    assert lat.max() > 150  # the last requests wait behind four blocks


def test_unanswered_requests_fail_at_the_wait():
    served, _, _ = serve([0.0, 0.5], block_s=2.0, close_s=1.0, wait_s=0.5)
    assert np.isnan(served.reply[1])
    lat = drv.latencies_ms(served, 1.0, 0.5)
    assert lat[1] == pytest.approx((1.5 - 0.5) * 1e3)


def test_queue_wait_and_lateness_are_read_apart():
    served, _, service = serve([0.0, 0.001, 0.002, 0.1])
    # the blocks close 1, 5 and 5 ms after their oldest admission; r2 falls
    # due during the first block and is submitted 9 ms late
    assert drv.queue_wait_mean_ms(service.metrics) == pytest.approx((1 + 5 + 5) / 3)
    np.testing.assert_allclose(drv.late_ms(served), [0.0, 0.0, 9.0, 0.0], atol=1e-6)
    assert drv.queue_wait_mean_ms([]) is None


def test_burst_arrivals_keep_each_phase_at_its_rate():
    """A burst schedule at 1,120/s, factor 4, duty 0.25: 4,480/s in the
    first quarter of each second and 56/s in the rest, each burst starting
    on time (its first arrival 1/4,480 s in on average, not a floor-rate
    gap late), sorted, and a longer draw of one seed beginning with the
    shorter one."""
    from portbench.gen import arrivals

    t = arrivals.burst_schedule(1120.0, 120_000, seed=2**31 + 41, burst_factor=4.0, duty=0.25)
    periods = int(t[-1])
    t = t[t < periods]
    phase = t % 1.0
    assert np.all(np.diff(t) >= 0)
    assert (phase < 0.25).sum() / periods == pytest.approx(4480 * 0.25, rel=0.02)
    assert (phase >= 0.25).sum() / periods == pytest.approx(56 * 0.75, rel=0.06)
    first = [phase[(t >= k) & (t < k + 0.25)].min() for k in range(periods)]
    assert np.mean(first) < 1e-3
    short = arrivals.burst_schedule(1120.0, 1000, seed=2**31 + 41)
    np.testing.assert_array_equal(short, t[:1000])
    mix = dict(registry.load_mix("serve-steady"), arrivals="burst", burst_factor=4, duty=0.25,
               period_s=1.0)
    due = arrivals.schedule(mix, 51.0, 2**31 + 43)
    assert due.max() < 51.0 and len(due) / 51.0 == pytest.approx(1162.0, rel=0.02)
