from repro_torch.optim import compress
from repro_torch.optim.adamw import (
    AdamWState, adamw_init, adamw_state_shapes, adamw_update, clip_by_global_norm,
    cosine_schedule, opt_state_specs,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_state_shapes",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "opt_state_specs",
    "compress",
]
