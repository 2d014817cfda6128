"""One module per architecture; the port holds the paper's own, ``mirex``."""
