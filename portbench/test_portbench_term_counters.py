"""The readers of the lexical kernel's term-score counters
(`lexical_scan.term_sharing.steady`, `lexical_scan.epilogue_share.steady`)
on hand-built ``session.search`` spans; each returns None where the spans or
their counters are absent, as on a kernel that does not count term scores."""

from __future__ import annotations

import pytest

from portbench.test_portbench_spans import blocks, read, run_of, span

READERS = ("lexical_scan.term_sharing.steady", "lexical_scan.epilogue_share.steady")
# block -> the counters its session.search span carries beyond the first eight
TERMS = {0: dict(term_scores=40, term_uses=150, epilogue_cycles=45),
         1: dict(term_scores=60, term_uses=250, epilogue_cycles=55)}


def counted():
    """`blocks()` with the term counters on the searches of blocks 0 and 1
    (block 2's search carries no counters)."""
    return [span(s.name, s.ts, s.ts + s.dur, **s.attrs, **TERMS[s.attrs["block"]])
            if s.name == "session.search" and "loop_cycles" in s.attrs else s
            for s in blocks()]


def test_the_term_readers_on_blocks_worked_by_hand():
    run = run_of(counted())
    # (150 + 250) uses of (40 + 60) scores; (45 + 55) of 200 loop cycles
    assert read("lexical_scan.term_sharing.steady", run) == pytest.approx(4.0)
    assert read("lexical_scan.epilogue_share.steady", run) == pytest.approx(50.0)
    # the readers that were there read the same spans as before
    assert read("lexical_scan.flush_share.steady", run) == pytest.approx(20.0)


@pytest.mark.parametrize("name", READERS)
def test_a_term_reader_finds_nothing_without_its_spans(name):
    assert read(name, run_of([])) is None


@pytest.mark.parametrize("name", READERS)
def test_a_term_reader_needs_its_counters(name):
    """Spans that carry only the kernel's first eight counters (a kernel that
    does not count its term scores or epilogue cycles), or no counters at all
    (the CPU), give no reading."""
    assert read(name, run_of(blocks())) is None
    cpu = [span(s.name, s.ts, s.ts + s.dur, **{k: v for k, v in s.attrs.items() if k == "block"})
           for s in counted()]
    assert read(name, run_of(cpu, device=None)) is None


def test_a_window_in_which_no_term_matched():
    unmatched = [span("session.search", 0.0, 1.0, loop_cycles=100, epilogue_cycles=20,
                      term_scores=0, term_uses=0)]
    assert read("lexical_scan.term_sharing.steady", run_of(unmatched)) is None
    assert read("lexical_scan.epilogue_share.steady", run_of(unmatched)) == pytest.approx(20.0)
