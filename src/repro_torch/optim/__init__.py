"""AdamW and EF-int8 gradient compression (counterpart of ``repro.optim``)."""

from .adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
    lr_schedule,
)
from .compress import ef_int8_compress, ef_int8_state  # noqa: F401
