"""repro_torch.tune — the tuning config of the port.

Only :mod:`repro_torch.tune.config` is ported in this slice: the frozen
:class:`TuningConfig` and its active-config helpers. The knob search and the
winner cache (``repro.tune.search`` / ``repro.tune.cache``) wait for the
autotune slice.
"""

from repro_torch.tune import config  # noqa: F401
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
    use,
)
