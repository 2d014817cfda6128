"""Share, in %, of the lexical scan kernel's tile loop spent in the rows'
epilogues (term scores, per-list sums and offers): the kernel's counters on
the window's ``session.search`` spans, 100 x the epilogue cycles over the
loop cycles (thread 0 of each CTA, `repro_torch.kernels.lexical_scan.COUNTERS`).
The counters exist on the card only."""

from portbench.lib.readers import spans


def read(run):
    s = [x.attrs for x in spans(run, "session.search") if "epilogue_cycles" in x.attrs]
    loop = sum(a["loop_cycles"] for a in s)
    return 100.0 * sum(a["epilogue_cycles"] for a in s) / loop if loop > 0 else None
