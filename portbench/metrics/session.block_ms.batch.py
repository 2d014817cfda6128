"""Median ms of one full block's dispatch into the session (the
``serve.dispatch`` span of `repro_torch.serve.service`: the scan and the
copy of the top k to the host), under the closed loop."""

from portbench.lib.readers import span_median_ms


def read(run):
    return span_median_ms(run, "serve.dispatch")
