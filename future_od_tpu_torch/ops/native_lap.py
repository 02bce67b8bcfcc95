"""The exact linear-sum-assignment solver (port of
future_od_tpu/ops/native_lap.py): the Jonker-Volgenant solver of
`csrc/lap.cpp`, built with g++ at first use into the build directory
(`ops/_kernels.py::host_library`) and called through ctypes.

A failed build raises: there is no quiet scipy path in its place. Where the
solver itself reports a failure (no finite assignment), scipy solves the
problem, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from future_od_tpu_torch.ops._kernels import host_library


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the min-cost assignment of an (M, N) matrix in float64.

    Returns (row_ind, col_ind) of the min(M, N) optimal pairs, sorted by
    row_ind (scipy's contract)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    lib = host_library("lap")
    M, N = cost.shape
    transposed = False
    if M > N:  # the solver takes rows <= cols
        cost = np.ascontiguousarray(cost.T)
        M, N = N, M
        transposed = True
    col_of_row = np.full((M,), -1, dtype=np.int32)
    ret = lib.lap_solve(M, N, cost.ctypes.data, col_of_row.ctypes.data)
    if ret != 0:  # the solver reported a failure
        import scipy.optimize

        rows, cols = scipy.optimize.linear_sum_assignment(cost)
    else:
        rows = np.arange(M, dtype=np.int64)
        cols = col_of_row.astype(np.int64)
    if transposed:
        rows, cols = cols, rows
        order = np.argsort(rows)
        rows, cols = rows[order], cols[order]
    return rows, cols
