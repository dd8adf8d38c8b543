from desenet_tpu_torch.train.schedule import linear_lr, one_cycle, warmup_interp
from desenet_tpu_torch.train.state import TrainState, create_train_state
from desenet_tpu_torch.train.step import make_train_step

__all__ = [
    "one_cycle",
    "linear_lr",
    "warmup_interp",
    "TrainState",
    "create_train_state",
    "make_train_step",
]
