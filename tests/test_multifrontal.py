"""Multifrontal device refactorization (linalg/multifrontal.py) vs host
LU and scipy — the matmul-extend-add path for general patterns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
from csparse3_jax.linalg import MultifrontalRefactor, splu


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
    mf = MultifrontalRefactor(lu._h, A, relax=relax)
    Lx, Ux = jax.jit(mf.factor_values)(np.asarray(A.np_arrays()[2]))
    np.testing.assert_allclose(np.asarray(Lx), lu._h.Lx, rtol=2e-5,
                               atol=2e-5 * np.abs(lu._h.Lx).max())
    np.testing.assert_allclose(np.asarray(Ux), lu._h.Ux, rtol=2e-5,
                               atol=2e-5 * np.abs(lu._h.Ux).max())


def test_refactor_new_values_solve():
    A = _grid_system(400, seed=2)
    lu = splu(A, ordering="amd", tol=0.0)
    mf = MultifrontalRefactor(lu._h, A)
    data2 = jnp.asarray(np.asarray(A.np_arrays()[2]) * 3.0)
    plan = jax.jit(mf.refactor)(data2)
    b = np.random.RandomState(0).rand(400)
    x = np.asarray(plan(jnp.asarray(b)), np.float64)
    xr = spla.spsolve(A.to_scipy().tocsc(), b) / 3.0
    assert np.abs(x - xr).max() / np.abs(xr).max() < 1e-4


def test_pytree_arg_and_scan():
    A = _grid_system(300, seed=3)
    lu = splu(A, ordering="amd", tol=0.0)
    mf = MultifrontalRefactor(lu._h, A)
    d0 = jnp.asarray(np.asarray(A.np_arrays()[2], np.float32))

    @jax.jit
    def chain(p, d):
        def body(dd, _):
            Lx, Ux = p.factor_values(dd)
            s = (1.0 + 0.0 * jnp.max(jnp.abs(Ux))).astype(dd.dtype)
            return dd * s, None

        o, _ = jax.lax.scan(body, d, None, length=3)
        return p.factor_values(o)

    Lx, Ux = chain(mf, d0)
    np.testing.assert_allclose(np.asarray(Lx), lu._h.Lx, rtol=2e-4,
                               atol=2e-4 * np.abs(lu._h.Lx).max())


def test_asymmetric_pattern_rejected():
    rng = np.random.RandomState(4)
    a = sp.random(60, 60, density=0.08, format="csc", random_state=rng)
    a = a + sp.eye(60) * 10
    A = cst.CSC.from_scipy(a.tocsc())
    lu = splu(A, ordering="natural", tol=0.0)
    if not np.array_equal(np.sort(lu._h.Li), np.sort(lu._h.Ui)):
        with pytest.raises(ValueError, match="symmetric"):
            MultifrontalRefactor(lu._h, A)


def test_matches_supernodal_and_scalar():
    from csparse3_jax.linalg import SupernodalRefactor
    from csparse3_jax.linalg.refactor import RefactorPlan

    A = _grid_system(250, seed=5)
    lu = splu(A, ordering="amd", tol=0.0)
    mf = MultifrontalRefactor(lu._h, A)
    sr = SupernodalRefactor(lu._h, A)
    rp = RefactorPlan(lu._h, A)
    data = np.asarray(A.np_arrays()[2]) * 1.7
    Lm, Um = jax.jit(mf.factor_values)(data)
    Ls, Us = jax.jit(sr.factor_values)(data)
    Lr, Ur = jax.jit(rp.factor_values)(data)
    for got, ref in ((Lm, Lr), (Um, Ur), (Lm, Ls), (Um, Us)):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=2e-4,
            atol=2e-4 * float(np.abs(np.asarray(ref)).max()))


def test_dense_tail_and_deep_tree():
    """A 1-D chain (natural order) makes a pure-chain etree: exercises
    the amalgamation path and deep levels."""
    n = 200
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([np.full(n, 4.0), np.full(n - 1, -1.0),
                           np.full(n - 1, -1.0)])
    A = cst.from_triplets(rows, cols, vals, (n, n))
    lu = splu(A, ordering="natural", tol=0.0)
    mf = MultifrontalRefactor(lu._h, A, relax=8)
    assert mf.nlevels <= n // 4     # amalgamation actually merged
    Lx, Ux = mf.factor_values(np.asarray(A.np_arrays()[2]))
    np.testing.assert_allclose(np.asarray(Lx), lu._h.Lx, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(Ux), lu._h.Ux, rtol=2e-5,
                               atol=2e-5)


def test_grad_flows_through_refactor_solve():
    """factor_values is pure jnp ops, so AD works end-to-end: gradient
    of a solve wrt the matrix values (same contract as the trisolve
    differentiability tests)."""
    A = _grid_system(120, seed=7)
    lu = splu(A, ordering="amd", tol=0.0)
    mf = MultifrontalRefactor(lu._h, A)
    d0 = jnp.asarray(np.asarray(A.np_arrays()[2], np.float32))
    b = jnp.asarray(np.random.RandomState(1).rand(120).astype(np.float32))

    def loss(d):
        return jnp.sum(mf.refactor(d)(b) ** 2)

    g = jax.grad(loss)(d0)
    assert np.isfinite(np.asarray(g)).all()
    # finite-difference check on one entry
    e = 1e-2
    k = 3
    lp = loss(d0.at[k].add(e))
    lm = loss(d0.at[k].add(-e))
    fd = (lp - lm) / (2 * e)
    assert abs(float(g[k]) - float(fd)) <= 2e-2 * max(abs(float(fd)), 1.0)


class TestMultifrontalLU:
    """From-scratch device LU with within-front partial pivoting
   ."""

    def _grid(self, n, seed=1):
        from csparse3_jax.models.grids import synthetic_grid

        g = synthetic_grid(n, seed=seed)
        bp = 1.0 / g.x
        rows = np.concatenate([g.f, g.t, g.f, g.t])
        cols = np.concatenate([g.f, g.t, g.t, g.f])
        vals = np.concatenate([bp, bp, -bp, -bp])
        return cst.add(cst.from_triplets(rows, cols, vals, (n, n)),
                       cst.diags(np.full(n, 3.0)))

    def test_matches_spsolve_grid(self):
        from csparse3_jax.linalg import MultifrontalLU

        A = self._grid(900)
        mf = MultifrontalLU.from_matrix(A)
        data = jnp.asarray(np.asarray(A.np_arrays()[2]))
        fac, stats = mf.factor_piv(data)
        assert float(stats["min_pivot"]) > 0
        b = np.random.RandomState(3).rand(900)
        x = np.asarray(mf.solve_piv(fac, jnp.asarray(b)))
        xr = spla.spsolve(A.to_scipy().tocsc(), b)
        np.testing.assert_allclose(x, xr, rtol=1e-8, atol=1e-10)

    def test_pivoting_fixes_bad_diagonal(self):
        """A DENSE leading block (one wide front) with a zero diagonal
        entry: no-pivot dies, within-front pivoting recovers exactly."""
        from csparse3_jax.linalg import MultifrontalLU

        rng = np.random.RandomState(5)
        n = 40
        D = rng.rand(n, n) + np.eye(n) * 0.1
        # structurally present, numerically negligible: forces a row
        # exchange inside the front (exact 0.0 would drop the entry)
        D[3, 3] = 1e-300
        A = cst.CSC.from_dense(D)
        mf = MultifrontalLU.from_matrix(A, ordering=None)
        fac, stats = mf.factor_piv(jnp.asarray(np.asarray(
            A.np_arrays()[2])))
        b = rng.rand(n)
        x = np.asarray(mf.solve_piv(fac, jnp.asarray(b)))
        xr = np.linalg.solve(D, b)
        np.testing.assert_allclose(x, xr, rtol=1e-9, atol=1e-9)

    def test_growth_stats_flag_singular(self):
        """A numerically singular matrix (two equal rows) on a healthy
        pattern: the factorization itself can't fail-fast inside jit,
        but the stats must flag it — min_pivot collapses relative to
        max_u, which is exactly the NewtonPowerFlow growth-gate
        condition."""
        from csparse3_jax.linalg import MultifrontalLU

        rng = np.random.RandomState(7)
        n = 40
        D = rng.rand(n, n) + np.eye(n) * 0.1
        A = cst.CSC.from_dense(D)
        mf = MultifrontalLU.from_matrix(A, ordering=None)

        healthy, s_ok = mf.factor_piv(jnp.asarray(np.asarray(
            A.np_arrays()[2])))
        assert float(s_ok["min_pivot"]) > 1e-10 * float(s_ok["max_u"])

        D_bad = D.copy()
        D_bad[5] = D_bad[4]          # exactly singular, same pattern
        A_bad = cst.CSC.from_dense(D_bad)
        _, s_bad = mf.factor_piv(jnp.asarray(np.asarray(
            A_bad.np_arrays()[2])))
        assert float(s_bad["min_pivot"]) < 1e-10 * float(s_bad["max_u"])

    def test_multi_rhs_and_jit(self):
        from csparse3_jax.linalg import MultifrontalLU

        A = self._grid(500, seed=2)
        mf = MultifrontalLU.from_matrix(A)
        data = jnp.asarray(np.asarray(A.np_arrays()[2]))
        step = jax.jit(lambda p, d, b: p.solve_piv(p.factor_piv(d)[0], b))
        B = np.random.RandomState(4).rand(500, 3)
        X = np.asarray(step(mf, data, jnp.asarray(B)))
        Xr = spla.spsolve(A.to_scipy().tocsc(), B)
        np.testing.assert_allclose(X, Xr, rtol=1e-8, atol=1e-10)
