"""Median ms a block spends in the session on the host: the
``session.search`` span of `repro_torch.serve.session.LexicalSession` less
its ``session.to_host`` (the wait for the card and the copy back), paired
by the block's number: the query upload, the epilogue's build and the
kernel's launch."""

from portbench.lib.readers import percentile, spans
from portbench.lib.spans import by_block


def read(run):
    to_host = by_block(spans(run, "session.to_host"))
    d = [(s.dur - to_host[b].dur) * 1e3
         for b, s in by_block(spans(run, "session.search")).items() if b in to_host]
    return percentile(d, 50) if d else None
