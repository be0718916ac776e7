"""Optimizers and learning-rate schedules of the port (counterpart of the
JAX package's ``optim``): functional ``(init, update)`` pairs over the
parameter tree."""
from repro_torch.optim.adam import adam
from repro_torch.optim.schedule import make_schedule  # noqa: F401


def make_optimizer(tc):
    """tc: TrainConfig -> (init_fn, update_fn) pair."""
    if tc.optimizer == "adam":
        return adam(tc.betas[0], tc.betas[1], tc.eps, tc.weight_decay)
    if tc.optimizer == "adafactor":
        raise NotImplementedError(
            "the port has no adafactor yet (rt-pg19's optimizer); the "
            "paper's other models train with adam")
    raise ValueError(f"unknown optimizer {tc.optimizer}")
