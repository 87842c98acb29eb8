"""Training: state, steps, checkpoints and the `Trainer` (JAX
`train/__init__.py`'s names: `make_train_step`/`make_eval_step` are the
steps themselves here, `train_step`/`eval_step`)."""

from .state import TrainState, create_train_state
from .steps import eval_step, make_sharded_forward, train_step
from .trainer import Trainer

__all__ = ["TrainState", "Trainer", "create_train_state", "eval_step",
           "make_sharded_forward", "train_step"]
