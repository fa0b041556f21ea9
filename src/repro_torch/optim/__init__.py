from .optimizers import Optimizer, adafactor, adamw, make_optimizer
from .schedules import cosine_schedule, make_schedule, wsd_schedule

__all__ = ["adamw", "adafactor", "make_optimizer", "Optimizer",
           "cosine_schedule", "wsd_schedule", "make_schedule"]
