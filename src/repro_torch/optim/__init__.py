from repro_torch.optim.optimizers import (AdamState, Optimizer, adamw,
                                          apply_l2, clip_by_global_norm,
                                          global_norm, sgd, sgd_step,
                                          tree_leaves, tree_map,
                                          tree_unflatten, value_and_grad)
from repro_torch.optim.schedule import (constant, cosine_decay, step_decay,
                                        warmup_cosine)

__all__ = ["AdamState", "Optimizer", "adamw", "apply_l2",
           "clip_by_global_norm", "constant", "cosine_decay", "global_norm",
           "sgd", "sgd_step", "step_decay", "tree_leaves", "tree_map",
           "tree_unflatten", "value_and_grad", "warmup_cosine"]
