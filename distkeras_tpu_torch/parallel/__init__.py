"""Training orchestration of the port: the train step and epoch loop
(``worker``), the trainers (``trainers``: ``SingleTrainer``,
``EnsembleTrainer``), the stacked-worker engine of the distributed-SGD
family (``engine``, ``distributed``), and the host parameter-server
path (``parameter_servers``, ``networking``, ``async_host``)."""

from distkeras_tpu_torch.parallel.async_host import HostAsyncTrainer
from distkeras_tpu_torch.parallel.distributed import (ADAG, AEASGD, DOWNPOUR,
                                                      AveragingTrainer,
                                                      DistributedTrainer,
                                                      DynSGD, EASGD)
from distkeras_tpu_torch.parallel.engine import (DistributedEngine,
                                                 EngineConfig, host_fetch)
from distkeras_tpu_torch.parallel.parameter_servers import (
    ADAGParameterServer, DeltaParameterServer, DynSGDParameterServer,
    EASGDParameterServer, ParameterServer, PSClient)
from distkeras_tpu_torch.parallel.trainers import (EnsembleTrainer,
                                                   SingleTrainer, Trainer)
from distkeras_tpu_torch.parallel.worker import (TrainCarry, make_train_step,
                                                 run_epoch, shard_epoch_data,
                                                 stack_batches,
                                                 value_and_grad)

__all__ = ["ADAG", "ADAGParameterServer", "AEASGD", "AveragingTrainer",
           "DOWNPOUR", "DeltaParameterServer", "DistributedEngine",
           "DistributedTrainer", "DynSGD", "DynSGDParameterServer", "EASGD",
           "EASGDParameterServer", "EngineConfig", "EnsembleTrainer",
           "HostAsyncTrainer", "PSClient", "ParameterServer",
           "SingleTrainer", "Trainer", "TrainCarry", "host_fetch",
           "make_train_step", "run_epoch", "shard_epoch_data",
           "stack_batches", "value_and_grad"]
