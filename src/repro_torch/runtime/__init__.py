"""Serving runtime: the batch-aggregating SparseEngine."""
