"""The lexical scan kernel's share of its roofline, in %, under the closed
loop: the least time of the window's calls (`costs/lexical_scan.py`, one
H100's peaks) over the device time of the operations named
``lexical_scan*`` in the profiler's trace (the scan and its merge)."""

from portbench.lib.readers import roofline_share


def read(run):
    return roofline_share(run, "lexical_scan")
