"""Share of the traced window, in %, in which a block was waiting to close
(``serve.batch_wait``: its oldest admission to its close), no block was in
dispatch and no operation ran on the card: the card idle on the
microbatcher. Time inside a dispatch counts under
`device.idle_dispatch.steady` alone, so the two add up to at most
`device.idle.steady`."""

from portbench.lib import devtrace
from portbench.lib import spans as sp
from portbench.lib.readers import spans


def read(run):
    w = spans(run, "serve.batch_wait")
    if run.device is None or run.device.window_s <= 0 or not w:
        return None
    taken = devtrace.union(sp.busy(run) + sp.intervals(spans(run, "serve.dispatch")))
    return 100.0 * sp.uncovered_s(w, taken) / run.device.window_s
