from .checkpoint import (AsyncTrainStateSaver, CheckpointCorruptError,
                         load_checkpoint, restore_train_state,
                         save_checkpoint, save_train_state)
from .jit_cache import compiled_run_cache
from ..runtime.resilience import (BadStepGuard, CheckpointManager,
                                  TrainingDivergedError)

__all__ = ["AsyncTrainStateSaver", "BadStepGuard", "CheckpointCorruptError",
           "CheckpointManager", "TrainingDivergedError", "compiled_run_cache",
           "load_checkpoint", "restore_train_state", "save_checkpoint",
           "save_train_state"]
