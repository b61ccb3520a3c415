"""Optimizer and schedules of the port (port of `repro.optim`)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
