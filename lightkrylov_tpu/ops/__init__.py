"""Sparse operator kernels (plain XLA)."""

from .bell import (BellMatrix, BellOperator, bell_from_scipy, bell_rspmv,
                   bell_spmv)

__all__ = ["BellMatrix", "BellOperator", "bell_from_scipy", "bell_rspmv",
           "bell_spmv"]
