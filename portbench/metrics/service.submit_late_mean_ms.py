"""Mean ms by which a request is submitted after its due time, over every
request of the window (the driver's clock): a request that falls due while
the service's one thread runs a block waits for it before ``try_submit``.
It is part of every request's latency and of no span of the program."""


def read(run):
    return run.window.info.get("late_mean_ms")
