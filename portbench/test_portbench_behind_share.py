"""The readers of the blocks launched behind a running block
(`service.behind_share.batch`, `.steady`) on hand-built ``serve.dispatch``
spans: the share is read from their ``behind`` tags, and each reader finds
nothing without dispatch spans that carry the tag (as on a program that
does not launch behind) or without a device trace (the CPU)."""

from __future__ import annotations

import pytest

from portbench.test_portbench_spans import DEVICE, read, run_of, span

READERS = ("service.behind_share.batch", "service.behind_share.steady")


def dispatches(behind):
    return [span("serve.dispatch", i, i + 1.5, block=i, behind=b) for i, b in enumerate(behind)]


@pytest.mark.parametrize("name", READERS)
def test_the_share_of_blocks_launched_behind(name):
    assert read(name, run_of(dispatches([0, 1, 1, 1]))) == pytest.approx(75.0)
    assert read(name, run_of(dispatches([0, 0]))) == 0.0
    # other spans, and dispatches of a program that does not tag them, are not read
    mixed = dispatches([1, 0]) + [span("serve.dispatch", 5, 6, block=2),
                                  span("serve.reply", 6, 7, block=2, behind=1)]
    assert read(name, run_of(mixed)) == pytest.approx(50.0)


@pytest.mark.parametrize("name", READERS)
def test_a_behind_reader_finds_nothing_without_its_spans(name):
    assert read(name, run_of([])) is None
    assert read(name, run_of([span("serve.dispatch", 0, 1, block=0)])) is None
    assert read(name, run_of(dispatches([1, 1]), device=None)) is None
    assert read(name, run_of(dispatches([1]), device=DEVICE)) == 100.0
