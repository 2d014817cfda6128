"""Median ms of one block's dispatch into the session (the
``serve.dispatch`` span of `repro_torch.serve.service`: the scan and the
copy of the top k to the host)."""

from portbench.lib.readers import percentile, spans


def read(run):
    d = [s.dur * 1e3 for s in spans(run, "serve.dispatch")]
    return percentile(d, 50) if d else None
