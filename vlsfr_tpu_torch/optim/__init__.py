from vlsfr_tpu_torch.optim.optimizers import make_optimizer, set_learning_rate
from vlsfr_tpu_torch.optim.schedules import PlateauController, make_schedule

__all__ = ["PlateauController", "make_optimizer", "make_schedule", "set_learning_rate"]
