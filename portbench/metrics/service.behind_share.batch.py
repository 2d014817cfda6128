"""Share, in %, of the window's blocks that launched while another block
was still on the card, under the closed loop: the ``serve.dispatch`` spans
of `repro_torch.serve.service` whose ``behind`` is 1, over those that carry
``behind``. Only a traced card can launch behind a running block (a CPU
session's launch completes at once), so the reading needs the device trace;
None without one, or without dispatch spans that carry ``behind``."""

from portbench.lib.readers import spans


def read(run):
    d = [s.attrs["behind"] for s in spans(run, "serve.dispatch") if "behind" in s.attrs]
    if run.device is None or not d:
        return None
    return 100.0 * sum(d) / len(d)
