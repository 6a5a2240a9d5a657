"""Tensor-level numerics: polynomial bases, cost/mapping tables, kernels."""
