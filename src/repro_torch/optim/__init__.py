"""AdamW for the port (``adamw``): the counterpart of ``repro.optim``."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "lr_schedule",
]
