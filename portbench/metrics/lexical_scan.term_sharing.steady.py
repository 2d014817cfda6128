"""Uses per score of the lexical scan kernel's matched-term scores: the
kernel's counters on the window's ``session.search`` spans, the (row, list,
slot) reads of a term score with tf > 0 over the term scores computed
(`repro_torch.kernels.lexical_scan.COUNTERS`). 1 where no two slots share a
term. The counters exist on the card only."""

from portbench.lib.readers import spans


def read(run):
    s = [x.attrs for x in spans(run, "session.search") if "term_scores" in x.attrs]
    scores = sum(a["term_scores"] for a in s)
    return sum(a["term_uses"] for a in s) / scores if scores > 0 else None
