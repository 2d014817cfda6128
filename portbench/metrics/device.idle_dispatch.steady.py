"""Share of the traced window, in %, in which a block was in dispatch
(``serve.dispatch`` spans of `repro_torch.serve.service`) and no operation
ran on the card: the host's part of a block."""

from portbench.lib import spans as sp
from portbench.lib.readers import spans


def read(run):
    d = spans(run, "serve.dispatch")
    if run.device is None or run.device.window_s <= 0 or not d:
        return None
    return 100.0 * sp.uncovered_s(d, sp.busy(run)) / run.device.window_s
