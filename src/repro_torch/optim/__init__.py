"""AdamW and the learning-rate schedule (the port of `repro.optim`)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm, init_opt_state
from repro_torch.optim.schedule import cosine_schedule
