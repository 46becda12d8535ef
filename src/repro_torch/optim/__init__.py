from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.schedule import (cosine_schedule, get_schedule,
                                        wsd_schedule)

__all__ = ["AdamW", "OptState", "cosine_schedule", "wsd_schedule",
           "get_schedule"]
