"""Supernodal device refactorization (linalg/supernodal.py) vs host LU
and scipy — the matmul panel-factorization path for general patterns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
from csparse3_jax.linalg import SupernodalRefactor, splu


def _grid_system(n, seed, shift=3.0):
    from csparse3_jax.models.grids import synthetic_grid

    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = cst.from_triplets(rows, cols, vals, (n, n))
    return cst.add(B, cst.diags(np.full(n, shift)))


@pytest.mark.parametrize("ordering", ["amd", "nd", "rcm"])
@pytest.mark.parametrize("relax", [1, 16])
def test_factor_matches_host(ordering, relax):
    A = _grid_system(500, seed=1)
    lu = splu(A, ordering=ordering, tol=0.0)
    sr = SupernodalRefactor(lu._h, A, relax=relax)
    Lx, Ux = jax.jit(sr.factor_values)(np.asarray(A.np_arrays()[2]))
    np.testing.assert_allclose(np.asarray(Lx), lu._h.Lx, rtol=2e-5,
                               atol=2e-5 * np.abs(lu._h.Lx).max())
    np.testing.assert_allclose(np.asarray(Ux), lu._h.Ux, rtol=2e-5,
                               atol=2e-5 * np.abs(lu._h.Ux).max())


def test_refactor_new_values_solve():
    A = _grid_system(400, seed=2)
    lu = splu(A, ordering="amd", tol=0.0)
    sr = SupernodalRefactor(lu._h, A)
    data2 = jnp.asarray(np.asarray(A.np_arrays()[2]) * 3.0)
    plan = jax.jit(sr.refactor)(data2)
    b = np.random.RandomState(0).rand(400)
    x = np.asarray(plan(jnp.asarray(b)), np.float64)
    xr = spla.spsolve(A.to_scipy().tocsc(), b) / 3.0
    assert np.abs(x - xr).max() / np.abs(xr).max() < 1e-4


def test_pytree_arg_and_scan():
    A = _grid_system(300, seed=3)
    lu = splu(A, ordering="amd", tol=0.0)
    sr = SupernodalRefactor(lu._h, A)
    d0 = jnp.asarray(np.asarray(A.np_arrays()[2], np.float32))

    @jax.jit
    def chain(p, d):
        def body(dd, _):
            Lx, Ux = p.factor_values(dd)
            s = (1.0 + 0.0 * jnp.max(jnp.abs(Ux))).astype(dd.dtype)
            return dd * s, None

        o, _ = jax.lax.scan(body, d, None, length=3)
        return p.factor_values(o)

    Lx, Ux = chain(sr, d0)
    np.testing.assert_allclose(np.asarray(Lx), lu._h.Lx, rtol=2e-4,
                               atol=2e-4 * np.abs(lu._h.Lx).max())


def test_asymmetric_pattern_rejected():
    # a pattern-asymmetric matrix must be refused (schedule relies on
    # symmetric fill closure)
    rng = np.random.RandomState(4)
    a = sp.random(60, 60, density=0.08, format="csc", random_state=rng)
    a = a + sp.eye(60) * 10
    A = cst.CSC.from_scipy(a.tocsc())
    lu = splu(A, ordering="natural", tol=0.0)
    if not np.array_equal(np.sort(lu._h.Li), np.sort(lu._h.Ui)):
        with pytest.raises(ValueError, match="symmetric"):
            SupernodalRefactor(lu._h, A)


def test_matches_scalar_refactor_plan():
    from csparse3_jax.linalg.refactor import RefactorPlan

    A = _grid_system(250, seed=5)
    lu = splu(A, ordering="amd", tol=0.0)
    sr = SupernodalRefactor(lu._h, A)
    rp = RefactorPlan(lu._h, A)
    data = np.asarray(A.np_arrays()[2]) * 1.7
    Ls, Us = jax.jit(sr.factor_values)(data)
    Lr, Ur = jax.jit(rp.factor_values)(data)
    np.testing.assert_allclose(np.asarray(Ls), np.asarray(Lr), rtol=2e-4,
                               atol=2e-4 * float(np.abs(Lr).max()))
    np.testing.assert_allclose(np.asarray(Us), np.asarray(Ur), rtol=2e-4,
                               atol=2e-4 * float(np.abs(Ur).max()))
