"""Host-side utilities of the port: parameter-tree helpers and the
training ``History``."""

from distkeras_tpu_torch.utils.history import History
from distkeras_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["History", "tree_leaves", "tree_map"]
