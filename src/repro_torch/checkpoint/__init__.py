"""Fault-tolerant checkpoints in the JAX package's file format."""
from .manager import CheckpointManager, tree_paths  # noqa: F401
