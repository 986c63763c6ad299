from repro_torch.optim.adamw import (AdafactorState, AdamWState,
                                     adafactor_init, adafactor_update,
                                     adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     tree_leaves, tree_map)
from repro_torch.optim.schedule import cosine_schedule, warmup_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "AdafactorState",
           "adafactor_init", "adafactor_update", "clip_by_global_norm",
           "global_norm", "warmup_schedule", "cosine_schedule",
           "tree_leaves", "tree_map"]
