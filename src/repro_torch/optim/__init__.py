from repro_torch.optim.optimizers import (
    LeafGroup,
    Optimizer,
    adamw,
    clip_by_global_norm,
    lamb,
    leaf_groups,
    make_optimizer,
)
from repro_torch.optim.schedule import make_schedule

__all__ = ["LeafGroup", "Optimizer", "adamw", "clip_by_global_norm", "lamb",
           "leaf_groups", "make_optimizer", "make_schedule"]
