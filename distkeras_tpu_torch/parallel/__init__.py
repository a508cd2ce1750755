"""Training orchestration of the port: the train step and epoch loop
(``worker``) and the trainers (``trainers``)."""

from distkeras_tpu_torch.parallel.trainers import SingleTrainer, Trainer
from distkeras_tpu_torch.parallel.worker import (TrainCarry, make_train_step,
                                                 run_epoch, shard_epoch_data,
                                                 stack_batches,
                                                 value_and_grad)

__all__ = ["SingleTrainer", "Trainer", "TrainCarry", "make_train_step",
           "run_epoch", "shard_epoch_data", "stack_batches",
           "value_and_grad"]
