from .loop import LoopConfig, train_loop
from .state import GANTrainState, create_state
from .step import GANSpec, make_train_step

__all__ = ["GANSpec", "GANTrainState", "LoopConfig", "create_state",
           "make_train_step", "train_loop"]
