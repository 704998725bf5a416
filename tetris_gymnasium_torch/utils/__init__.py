"""Shared utilities: per-env select, checkpointing, profiling.

The JAX package's ``utils/compilation.py`` (XLA's persistent compile cache)
has no counterpart: the port's compiled code is its kernels, and their
build cache is ``kernels.build()`` with its libraries under
``build/torch_kernels/``, reused across processes.
"""
from tetris_gymnasium_torch.utils import profiling
from tetris_gymnasium_torch.utils.checkpoint import restore, save
from tetris_gymnasium_torch.utils.tree import select_tree

__all__ = ["profiling", "restore", "save", "select_tree"]
