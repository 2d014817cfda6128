"""The readers of the program's block spans and kernel counters, and
`lib/spans.py`, on hand-built spans and device intervals with the overlaps
worked by hand; each reader returns None where its spans, attributes or
device trace are absent."""

from __future__ import annotations

import pytest

from portbench.bench import TracedRun, Window
from portbench.lib import devtrace, registry
from portbench.lib import spans as sp
from repro_torch.obs import SpanEvent

# the card busy over [1, 4] and [6, 6.5] of a 10 s window
DEVICE = devtrace.DeviceRead(window_s=10.0, busy_s=3.5,
                             ops=[("k", 1.0, 3.0), ("k", 2.5, 4.0), ("c", 6.0, 6.5)])
NEW = ("session.host_ms.steady", "device.idle_dispatch.steady", "device.idle_batch_wait.steady",
       "lexical_scan.flush_share.steady", "lexical_scan.candidates.steady")


def span(name, a, b, **attrs):
    return SpanEvent(name=name, cat="", ph="X", ts=a, dur=b - a, tid=1, attrs=attrs)


def blocks():
    """Blocks 0 and 1 dispatched; block 1's wait overlaps block 0's dispatch
    (a remainder block) and block 2's wait overlaps block 1's; block 2's
    search has no copy to the host."""
    return [
        span("serve.batch_wait", 0.0, 0.5, block=0),
        span("serve.dispatch", 0.5, 5.0, block=0),
        span("session.search", 0.6, 4.9, block=0, flush_cycles=30, loop_cycles=100,
             candidates=1000),
        span("session.to_host", 3.0, 4.8, block=0),
        span("serve.batch_wait", 4.0, 7.0, block=1),
        span("serve.batch_wait", 4.5, 7.5, block=2),
        span("serve.dispatch", 7.0, 9.0, block=1),
        span("session.search", 7.1, 8.9, block=1, flush_cycles=10, loop_cycles=100,
             candidates=3000),
        span("session.to_host", 8.5, 8.8, block=1),
        span("session.search", 9.1, 9.2, block=2),
    ]


def run_of(spans, device=DEVICE):
    return TracedRun({}, {}, Window({}, 0, 0), spans, device, {})


def read(name, run):
    return registry.load_module("metrics", name).read(run)


def test_covered_and_uncovered_seconds():
    s = [span("a", 0.0, 2.0), span("a", 1.0, 3.0), span("a", 5.0, 6.0)]
    merged = [(0.5, 1.5), (2.5, 5.5)]
    # the spans' union [0, 3] and [5, 6]: covered 1.0 + 0.5 and 0.5
    assert sp.covered_s(s, merged) == pytest.approx(2.0)
    assert sp.uncovered_s(s, merged) == pytest.approx(2.0)
    assert sp.busy(run_of([])) == [(1.0, 4.0), (6.0, 6.5)]
    assert sp.covered_s([], merged) == 0.0
    assert sp.by_block([span("a", 0, 1, block=4), span("a", 1, 2)]).keys() == {4}


def test_each_reader_on_blocks_worked_by_hand():
    run = run_of(blocks())
    # search less its copy: 4.3 - 1.8 and 1.8 - 0.3 s; block 2 has no copy
    assert read("session.host_ms.steady", run) == pytest.approx(2000.0)
    # dispatches [0.5, 5] and [7, 9] outside [1, 4]: 1.5 + 2.0 s of 10
    assert read("device.idle_dispatch.steady", run) == pytest.approx(35.0)
    # waits [0, 0.5] and [4, 7.5] outside the card and the dispatches
    # ([0.5, 5], [6, 6.5], [7, 9]): 0.5 + (3.5 - 1.0 - 0.5 - 0.5) s of 10
    assert read("device.idle_batch_wait.steady", run) == pytest.approx(20.0)
    # the two add up to no more than the idle share, 65%
    assert read("device.idle.steady", run) == pytest.approx(65.0)
    assert read("lexical_scan.flush_share.steady", run) == pytest.approx(20.0)
    assert read("lexical_scan.candidates.steady", run) == pytest.approx(2000.0)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_its_spans(name):
    assert read(name, run_of([])) is None


def test_without_a_card_or_the_new_spans():
    """On the CPU (no device trace, no kernel counters on the spans) only the
    session's host time reads; a program without the session's spans and
    counters (the dispatch alone, untagged) gives only the dispatch's idle
    share."""
    cpu = [span(s.name, s.ts, s.ts + s.dur, **{k: v for k, v in s.attrs.items() if k == "block"})
           for s in blocks()]
    got = {n: read(n, run_of(cpu, device=None)) for n in NEW}
    assert got.pop("session.host_ms.steady") == pytest.approx(2000.0)
    assert set(got.values()) == {None}
    plain = [span(s.name, s.ts, s.ts + s.dur) for s in blocks() if s.name == "serve.dispatch"]
    got = {n: read(n, run_of(plain)) for n in NEW}
    assert got.pop("device.idle_dispatch.steady") == pytest.approx(35.0)
    assert set(got.values()) == {None}
