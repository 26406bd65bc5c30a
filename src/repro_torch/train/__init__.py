"""The train step of the port (``step``) and the sharding rules
(``sharding``: logical axes -> DTensor placements), which the dry-run
(``launch/dryrun.py``) applies on a fake process group."""
from .step import TrainConfig, make_eval_step, make_loss_fn, make_train_step

__all__ = ["TrainConfig", "make_eval_step", "make_loss_fn",
           "make_train_step"]
