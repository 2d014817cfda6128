from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    Snapshot,
    all_steps,
    latest_step,
    prune,
    replace_dir,
    restore,
    save,
    snapshot,
)

__all__ = [
    "AsyncCheckpointer", "Snapshot", "save", "snapshot", "replace_dir", "restore",
    "latest_step", "all_steps", "prune",
]
