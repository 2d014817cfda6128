"""repro_torch.tune — the autotuning subsystem of the port.

Four pieces, as in `repro.tune`:

* :mod:`repro_torch.tune.config` — the frozen :class:`TuningConfig` with
  every knob the port reads, threaded through the kernels, scan, executor
  and serving with defaults that reproduce the hand-picked values.
  **Tuning changes speed, never bytes.**
* :mod:`repro_torch.tune.search` — the async model-based search over a
  legal knob space (the reference's, copied).
* :mod:`repro_torch.tune.cache` — the persistent winner cache, keyed kind ×
  backend × shape signature × knob-space version, with :func:`best_config`
  lookup that degrades to the defaults.
* :mod:`repro_torch.tune.targets` — the scan job's knob space and its
  measurement, which checks every trial's bytes against the default's.

The shape-signature helpers here are the *shared vocabulary* between the
recorder and the readers (the experiment runner's ``--tune``): both build
the signature from the same fields, so a recorded winner is found by
construction, not by string luck. The strings are the reference's.
"""

from repro_torch.tune import cache, config, search  # noqa: F401
from repro_torch.tune.cache import TuneCache, backend_sig, best_config  # noqa: F401
from repro_torch.tune.config import (  # noqa: F401
    DEFAULT,
    SPACE_VERSION,
    ActiveTuning,
    TuningConfig,
    active,
    load,
    provenance,
    resolve,
    save,
    set_active,
    use,
)
from repro_torch.tune.search import Knob, KnobSpace, SearchResult, Surrogate, Trial  # noqa: F401
from repro_torch.tune.search import search as run_search  # noqa: F401


def scan_shape_sig(
    *,
    n_docs: int,
    n_queries: int,
    k: int,
    n_shards: int,
    n_models: int,
    max_doc_len: int,
) -> str:
    """Shape signature of a sharded scan job — what a scan-tuning winner is
    keyed on. Chunk size is deliberately *absent*: it is a knob, not a
    shape (the tuned chunk replaces the declared one)."""
    return (
        f"scan:d{n_docs}:q{n_queries}:L{max_doc_len}:k{k}"
        f":s{n_shards}:m{n_models}"
    )


def scan_shape_sig_for(spec) -> str:
    """The scan signature of a `repro_torch.experiments.grid.ExperimentSpec`
    — the runner's ``--tune`` lookup and the recorder both call this, which
    makes the write → reload → hit round trip structural."""
    return scan_shape_sig(
        n_docs=spec.n_docs,
        n_queries=spec.n_queries,
        k=spec.k,
        n_shards=spec.n_shards,
        n_models=len(spec.scorers()),
        max_doc_len=spec.max_doc_len,
    )


def serve_shape_sig(*, n_docs: int, k: int, chunk_size: int, kind: str) -> str:
    """Shape signature of a serve session (microbatch-trigger tuning)."""
    return f"serve:{kind}:d{n_docs}:k{k}:c{chunk_size}"
