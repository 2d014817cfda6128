"""Share of the traced window, in %, in which no operation ran on the
card (the window less the union of the profiler's device intervals), under
the closed loop."""

from portbench.lib.readers import idle_share


def read(run):
    return idle_share(run)
