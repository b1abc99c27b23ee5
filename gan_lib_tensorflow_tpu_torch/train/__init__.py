from .checkpoint import CheckpointManager
from .loop import LoopConfig, train_loop
from .state import (EvalState, GANTrainState, create_state, eval_state_from_raw,
                    load_checkpoint, to_checkpoint)
from .step import GANSpec, make_train_step

__all__ = ["CheckpointManager", "EvalState", "GANSpec", "GANTrainState",
           "LoopConfig", "create_state", "eval_state_from_raw", "load_checkpoint",
           "make_train_step", "to_checkpoint", "train_loop"]
