"""Host-side utilities of the port: parameter-tree helpers, the
training ``History``, checkpoints (``checkpoint``), Keras-style
callbacks (``callbacks``), background prefetching (``prefetch``) and
profiling (``profiling``)."""

from distkeras_tpu_torch.utils import profiling
from distkeras_tpu_torch.utils.callbacks import (Callback, CSVLogger,
                                                 EarlyStopping, EMAWeights,
                                                 LambdaCallback,
                                                 ModelCheckpoint,
                                                 TensorBoardLogger,
                                                 TerminateOnNaN)
from distkeras_tpu_torch.utils.checkpoint import CheckpointManager
from distkeras_tpu_torch.utils.history import History
from distkeras_tpu_torch.utils.prefetch import Prefetcher, device_stager
from distkeras_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["CSVLogger", "Callback", "CheckpointManager", "EMAWeights",
           "EarlyStopping", "History", "LambdaCallback", "ModelCheckpoint",
           "Prefetcher", "TensorBoardLogger", "TerminateOnNaN",
           "device_stager", "profiling", "tree_leaves", "tree_map"]
