"""Share of the traced window, in %, in which a block was in dispatch
(``serve.dispatch`` spans of `repro_torch.serve.service`) and no operation
ran on the card, under the closed loop: the host's part of a full block."""

from portbench.lib.readers import idle_in_spans


def read(run):
    return idle_in_spans(run, "serve.dispatch")
