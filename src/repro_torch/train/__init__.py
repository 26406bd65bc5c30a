"""The train step of the port (``step``); the reference's sharding
rules (``train/sharding.py``) wait for more than one card (ROADMAP)."""
from .step import TrainConfig, make_eval_step, make_loss_fn, make_train_step

__all__ = ["TrainConfig", "make_eval_step", "make_loss_fn",
           "make_train_step"]
