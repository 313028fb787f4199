from .gan import GanStepState, GanTrainStep, make_gan_train_step
from .step import StepState, TrainStep, make_train_step

__all__ = ["GanStepState", "GanTrainStep", "StepState", "TrainStep",
           "make_gan_train_step", "make_train_step"]
