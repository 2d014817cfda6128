from repro_torch.checkpoint.checkpoint import (
    all_steps,
    latest_step,
    prune,
    replace_dir,
    restore,
    save,
)

__all__ = ["save", "replace_dir", "restore", "latest_step", "all_steps", "prune"]
