"""The port's optimizer: AdamW and the learning-rate schedules."""
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "cosine_schedule",
           "linear_warmup_cosine"]
