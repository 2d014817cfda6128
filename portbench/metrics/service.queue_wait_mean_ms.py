"""Mean ms of a block's queue wait (its oldest request's admission to the
block's close): `repro_torch.serve.service.BatchRecord` ``queue_wait_s``
over the window's blocks. The mean, not a tail: near the knee a tail of
these waits sits where blocks turn from deadline- to size-closed, and swings
from run to run between the deadline and a whole block."""


def read(run):
    return run.window.info.get("queue_wait_mean_ms")
