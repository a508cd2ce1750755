"""Training orchestration of the port: the train step and epoch loop
(``worker``), the trainers (``trainers``: ``SingleTrainer``,
``EnsembleTrainer``), the stacked-worker engine of the distributed-SGD
family (``engine``, ``distributed``), the host parameter-server
path (``parameter_servers``, ``networking``, ``async_host``), and the
mesh of processes: ``mesh`` (named axes over a ``torch.distributed``
world), ``collectives`` (the named-axis collectives and ``shard_map``)
and ``launch`` (``World``: a world of processes on this machine); the
SPMD trainer over that mesh (``spmd``) and its sharding rules
(``sharding``). Pipeline parallelism (``pipeline``) raises, naming its
ROADMAP item."""

from distkeras_tpu_torch.parallel.async_host import HostAsyncTrainer
from distkeras_tpu_torch.parallel.collectives import shard_map
from distkeras_tpu_torch.parallel.distributed import (ADAG, AEASGD, DOWNPOUR,
                                                      AveragingTrainer,
                                                      DistributedTrainer,
                                                      DynSGD, EASGD)
from distkeras_tpu_torch.parallel.engine import (DistributedEngine,
                                                 EngineConfig, host_fetch)
from distkeras_tpu_torch.parallel.launch import World
from distkeras_tpu_torch.parallel.mesh import (Mesh, NamedSharding,
                                               PartitionSpec, make_mesh,
                                               make_mesh_2d, replicated,
                                               worker_sharded)
from distkeras_tpu_torch.parallel.pipeline import (PipelinedLM,
                                                   PipelineTrainer,
                                                   init_stacked_blocks,
                                                   make_pipeline_fn)
from distkeras_tpu_torch.parallel.sharding import (ShardingRules,
                                                   named_shardings,
                                                   param_specs,
                                                   shard_params)
from distkeras_tpu_torch.parallel.spmd import SPMDTrainer
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
           "HostAsyncTrainer", "Mesh", "NamedSharding", "PSClient",
           "ParameterServer", "PartitionSpec", "PipelineTrainer",
           "PipelinedLM", "SPMDTrainer", "ShardingRules", "SingleTrainer",
           "Trainer", "TrainCarry", "World", "host_fetch",
           "init_stacked_blocks", "make_mesh", "make_mesh_2d",
           "make_pipeline_fn", "make_train_step", "named_shardings",
           "param_specs", "replicated", "run_epoch", "shard_epoch_data",
           "shard_map", "shard_params", "stack_batches", "value_and_grad",
           "worker_sharded"]
