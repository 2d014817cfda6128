"""Mean candidates the lexical scan kernel flushed a block into its CTAs'
lists: the ``candidates`` counter on the window's ``session.search`` spans
(`repro_torch.kernels.lexical_scan.COUNTERS`). The counters exist on the
card only."""

from portbench.lib.readers import spans


def read(run):
    c = [x.attrs["candidates"] for x in spans(run, "session.search") if "candidates" in x.attrs]
    return sum(c) / len(c) if c else None
