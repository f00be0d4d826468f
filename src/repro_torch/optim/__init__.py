from repro_torch.optim.optimizers import (Optimizer, apply_l2, sgd, sgd_step,
                                          tree_leaves, tree_map,
                                          tree_unflatten, value_and_grad)

__all__ = ["Optimizer", "apply_l2", "sgd", "sgd_step", "tree_leaves",
           "tree_map", "tree_unflatten", "value_and_grad"]
