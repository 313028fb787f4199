from .step import StepState, TrainStep, make_train_step

__all__ = ["StepState", "TrainStep", "make_train_step"]
