"""Schur-complement distributed direct solve (parallel/schur.py).

Oracle: scipy.sparse.linalg.spsolve on the same matrix.  The SPMD path
runs on the virtual 8-device CPU mesh (conftest forces the cpu platform
with xla_force_host_platform_device_count).
"""

import jax
import numpy as np
import pytest
import scipy.sparse.linalg as spla
from jax.sharding import Mesh

import csparse3_jax as cst
from csparse3_jax.linalg.ordering import rcm
from csparse3_jax.models.grids import synthetic_grid
from csparse3_jax.parallel import SchurLU


def _grid_matrix(n, seed=2):
    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = cst.from_triplets(rows, cols, vals, (n, n))
    A = cst.add(B, cst.diags(np.full(n, 3.0)))
    p = rcm(A)
    return A[p, p]


class TestSchurLU:
    def test_host_solve_matches_scipy(self):
        n = 1200
        A = _grid_matrix(n)
        slu = SchurLU(A, S=4)
        assert not slu.is_singular
        assert 0 < slu.n_interface < n // 4
        b = np.random.RandomState(0).randn(n)
        ref = spla.spsolve(A.to_scipy().tocsc(), b)
        np.testing.assert_allclose(slu.solve_host(b), ref, rtol=1e-9,
                                   atol=1e-11)

    def test_device_plan_single_and_multi_rhs(self):
        n = 1200
        A = _grid_matrix(n)
        plan = SchurLU(A, S=4).device_plan()
        b = np.random.RandomState(1).randn(n)
        ref = spla.spsolve(A.to_scipy().tocsc(), b)
        np.testing.assert_allclose(np.asarray(jax.jit(plan)(b)), ref,
                                   rtol=1e-9, atol=1e-11)
        B = np.random.RandomState(2).randn(n, 7)
        refB = spla.spsolve(A.to_scipy().tocsc(), B)
        np.testing.assert_allclose(np.asarray(jax.jit(plan)(B)), refB,
                                   rtol=1e-9, atol=1e-11)

    def test_spmd_dist_solve_8_shards(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device CPU mesh")
        n = 1600
        A = _grid_matrix(n)
        plan = SchurLU(A, S=8).device_plan()
        mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
        b = np.random.RandomState(3).randn(n)
        ref = spla.spsolve(A.to_scipy().tocsc(), b)
        x = np.asarray(plan.dist_solve(b, mesh))
        np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-11)

    def test_interface_cap_raises(self):
        # an unordered (scrambled) matrix has a huge interface
        n = 1000
        A = _grid_matrix(n)
        rng = np.random.RandomState(0)
        p = rng.permutation(n)
        with pytest.raises(ValueError, match="interface"):
            SchurLU(A[p, p], S=8, max_interface=50)

    def test_fully_decoupled_raises(self):
        import scipy.sparse as sp

        blocks = sp.block_diag([
            sp.eye(50) * 2.0, sp.eye(50) * 3.0,
        ]).tocsc()
        with pytest.raises(ValueError, match="cross-shard"):
            SchurLU(cst.CSC.from_scipy(blocks), S=2)
