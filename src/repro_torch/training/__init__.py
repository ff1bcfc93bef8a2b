"""Training substrate: optimizer, train step, loop."""
from repro_torch.training.optimizer import AdamWConfig, AdamWState, init, update
from repro_torch.training.loop import TrainLoop, TrainState, init_state, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "TrainLoop", "TrainState", "init",
           "init_state", "make_train_step", "update"]
