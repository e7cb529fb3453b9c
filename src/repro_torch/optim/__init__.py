"""The optimizer; port of `repro.optim` (AdamW, the lr schedule, int8
gradient compression with error feedback)."""
from repro_torch.optim.adamw import adamw_init_defs, adamw_update  # noqa: F401
from repro_torch.optim.schedule import lr_schedule  # noqa: F401
