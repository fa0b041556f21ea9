"""Training and serving steps of the port (the JAX package's `train/`)."""
from . import serve
from .coded_step import StragglerInjector, make_straggler_train_step
from .state import TrainState, abstract_state, init_state, make_train_setup
from .train_loop import make_eval_step, make_train_step

__all__ = ["TrainState", "init_state", "abstract_state", "make_train_setup",
           "make_train_step", "make_eval_step", "make_straggler_train_step",
           "StragglerInjector", "serve"]
