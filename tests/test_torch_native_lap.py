"""The port's exact assignment solver (`ops/native_lap.py` over
`csrc/lap.cpp`, built with g++) against the JAX package's
`future_od_tpu.ops.native_lap.linear_sum_assignment` and scipy, and the
matcher's exact arm and the tracker that use it against JAX's.

The JAX module loads `native/_lap.so` when it is built and else falls back
to scipy: it is held both ways here, as it is found and with its library
handle set to a ctypes load of the port's build of the same solver, so its
own transposition and ordering run over the C++ solver too. On seeded random
costs (square, M < N, M > N, with and without inactive columns) the optimum
is unique, so every solver must give the same indices exactly. About 7 s
alone (one eager JAX callback compile).
"""
import ctypes

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp

from future_od_tpu.ops import matching as jax_matching
from future_od_tpu.ops import native_lap as jax_native_lap

from future_od_tpu_torch.ops import _kernels, native_lap
from future_od_tpu_torch.ops.matching import hungarian_assignment, hungarian_host

SHAPES = [(6, 6), (4, 9), (9, 4), (1, 5), (5, 1), (32, 12), (12, 32), (0, 3), (3, 0)]


def costs(shape, seed):
    return np.random.default_rng(seed).normal(size=shape) * 3.0


@pytest.fixture
def jax_lap_over_port_solver(monkeypatch):
    """The JAX module with its library handle set to the port's build."""
    native_lap.linear_sum_assignment(np.zeros((1, 1)))  # build it
    lib = ctypes.CDLL(str(_kernels.host_library_path("lap")))
    lib.lap_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.lap_solve.restype = ctypes.c_int
    monkeypatch.setattr(jax_native_lap, "_LIB", lib)
    monkeypatch.setattr(jax_native_lap, "_TRIED", True)
    return jax_native_lap.linear_sum_assignment


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_solver_equals_jax_and_scipy(shape, seed, jax_lap_over_port_solver):
    cost = costs(shape, seed)
    rows, cols = native_lap.linear_sum_assignment(cost)
    assert rows.dtype == np.int64 and cols.dtype == np.int64
    for name, (ref_rows, ref_cols) in (
            ("scipy", scipy.optimize.linear_sum_assignment(cost)),
            ("JAX over the C++ solver", jax_lap_over_port_solver(cost)),
            ("JAX as found", jax_native_lap.__dict__["linear_sum_assignment"](cost))):
        np.testing.assert_array_equal(rows, ref_rows, err_msg=name)
        np.testing.assert_array_equal(cols, ref_cols, err_msg=name)


def test_solver_takes_f32_and_strided_costs():
    cost = costs((8, 10), 3).astype(np.float32)
    ref = scipy.optimize.linear_sum_assignment(cost.astype(np.float64))
    for view in (cost, cost.T.copy().T, np.asfortranarray(cost)):
        out = native_lap.linear_sum_assignment(view)
        np.testing.assert_array_equal(out[1], ref[1])


def test_solver_failure_falls_back_as_jax_does():
    """No finite assignment: the C++ solver returns 2, and scipy answers
    (here by refusing the infeasible matrix), as in the JAX module."""
    cost = np.full((2, 3), np.inf)
    cost[0, 0] = cost[1, 0] = 1.0
    with pytest.raises(ValueError, match="infeasible"):
        native_lap.linear_sum_assignment(cost)
    with pytest.raises(ValueError, match="infeasible"):
        scipy.optimize.linear_sum_assignment(cost)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A solver that does not build raises; no scipy path takes its place."""
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    (tmp_path / "lap.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_libs", {})
    with pytest.raises(RuntimeError, match="lap build failed"):
        native_lap.linear_sum_assignment(np.zeros((2, 2)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_assignment_equals_jax_exact_arm(seed):
    rng = np.random.default_rng(seed)
    B, M, N = 4, 12, 10
    cost = rng.normal(size=(B, M, N)).astype(np.float32) * 4
    active = rng.uniform(size=(B, N)) < 0.6
    active[0] = False  # an image without targets
    active[1] = True
    ref = np.asarray(jax_matching.hungarian_assignment(jnp.asarray(cost), jnp.asarray(active)))
    idx, rounds = hungarian_assignment(torch.from_numpy(cost), torch.from_numpy(active),
                                       return_rounds=True)
    assert idx.dtype == torch.int64 and rounds.tolist() == [0] * B
    np.testing.assert_array_equal(idx.numpy(), ref)
    np.testing.assert_array_equal(hungarian_host(cost, active),
                                  jax_matching._hungarian_host(cost, active))
