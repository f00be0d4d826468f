from repro_torch.optim.optimizers import apply_l2, sgd_step, value_and_grad

__all__ = ["apply_l2", "sgd_step", "value_and_grad"]
