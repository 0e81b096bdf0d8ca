"""Sparse LU + triangular solves vs scipy.sparse.linalg (splu/spsolve) —
the test the reference never had (SURVEY §4 "add what the reference
lacks")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
from csparse3_jax import linalg as cla

from conftest import rand_sp


def ybus_like(n, seed=0, dtype=np.float64):
    """Symmetric diagonally-dominant grid-like matrix (Ybus shape)."""
    rng = np.random.RandomState(seed)
    # random spanning structure + extra edges
    f = np.arange(1, n)
    t = rng.randint(0, np.maximum(f, 1))
    extra = rng.randint(0, n, (max(n // 2, 1), 2))
    F = np.concatenate([f, extra[:, 0]])
    T = np.concatenate([t, extra[:, 1]])
    keep = F != T
    F, T = F[keep], T[keep]
    y = rng.uniform(1.0, 10.0, len(F)).astype(dtype)
    rows = np.concatenate([F, T, F, T])
    cols = np.concatenate([F, T, T, F])
    vals = np.concatenate([y, y, -y, -y])
    # shunt term keeps it nonsingular
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 0.5, dtype=dtype)])
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("ordering", ["natural", "rcm", "amd", "nd"])
@pytest.mark.parametrize("n", [10, 60, 200])
def test_lu_solve_vs_scipy(n, ordering):
    a_sp = ybus_like(n, seed=n)
    a = cst.CSC.from_scipy(a_sp)
    b = np.random.RandomState(n).randn(n)
    lu = cla.splu(a, ordering=ordering)
    assert not lu.is_singular
    x = np.asarray(lu.solve(b))
    ref = spla.spsolve(a_sp, b)
    np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-12)
    # host oracle path agrees
    np.testing.assert_allclose(lu.solve_host(b), ref, rtol=1e-9, atol=1e-12)


def test_lu_reconstruction():
    """P A Q = L U exactly (pattern + values)."""
    a_sp = rand_sp(40, 40, 0.1, seed=3) + sp.eye(40) * 5
    a = cst.CSC.from_scipy(a_sp.tocsc())
    lu = cla.splu(a, ordering="amd")
    L = lu.L.to_scipy()
    U = lu.U.to_scipy()
    n = 40
    P = sp.csc_matrix((np.ones(n), (np.arange(n), lu.perm_r)), shape=(n, n))
    Q = sp.csc_matrix((np.ones(n), (lu.perm_c, np.arange(n))), shape=(n, n))
    np.testing.assert_allclose(
        (P @ a_sp @ Q).toarray(), (L @ U).toarray(), rtol=1e-10, atol=1e-12
    )


def test_lu_unsymmetric():
    rng = np.random.RandomState(7)
    a_sp = (rand_sp(80, 80, 0.05, seed=7) + sp.diags(rng.uniform(1, 2, 80))).tocsc()
    a = cst.CSC.from_scipy(a_sp)
    b = rng.randn(80)
    x = np.asarray(cla.spsolve(a, b))
    np.testing.assert_allclose(x, spla.spsolve(a_sp, b), rtol=1e-8, atol=1e-11)


def test_multi_rhs_batched():
    """1024-RHS pattern (BASELINE config 4, scaled down)."""
    n, k = 100, 32
    a_sp = ybus_like(n, seed=1)
    a = cst.CSC.from_scipy(a_sp)
    B = np.random.RandomState(1).randn(n, k)
    lu = cla.splu(a)
    X = np.asarray(lu.solve(B))
    ref = spla.spsolve(a_sp.tocsc(), B)
    ref = np.asarray(ref.todense()) if sp.issparse(ref) else ref
    np.testing.assert_allclose(X, ref, rtol=1e-8, atol=1e-11)


def test_solve_plan_jit():
    n = 64
    a_sp = ybus_like(n, seed=2)
    a = cst.CSC.from_scipy(a_sp)
    lu = cla.splu(a)
    plan = lu.solve_plan()
    b = np.random.RandomState(2).randn(n)
    x1 = jax.jit(lambda p, b: p(b))(plan, b)
    np.testing.assert_allclose(np.asarray(x1), spla.spsolve(a_sp, b), rtol=1e-9)


def test_singular_reported():
    # exactly singular: duplicate column
    rows = [0, 1, 2, 0, 1, 2, 0, 1, 2]
    cols = [0, 0, 0, 1, 1, 1, 2, 2, 2]
    vals = [1.0, 2, 3, 1, 2, 3, 4, 5, 7]
    a = cst.from_triplets(rows, cols, vals, (3, 3))
    lu = cla.splu(a, ordering="natural")
    assert lu.is_singular
    with pytest.warns(UserWarning):
        x = lu.solve(np.ones(3))
    assert not np.all(np.isfinite(np.asarray(x)))


def test_host_trisolves():
    n = 30
    rng = np.random.RandomState(4)
    Ld = np.tril(rng.randn(n, n) * (rng.rand(n, n) < 0.3)) + np.eye(n) * 3
    L = cst.dense_to_csc(Ld)
    ip, ix, dt = L.np_arrays()
    b = rng.randn(n)
    np.testing.assert_allclose(cla.lsolve(ip, ix, dt, b),
                               np.linalg.solve(Ld, b), rtol=1e-10)
    np.testing.assert_allclose(cla.ltsolve(ip, ix, dt, b),
                               np.linalg.solve(Ld.T, b), rtol=1e-10)
    Ud = Ld.T.copy()
    U = cst.dense_to_csc(Ud)
    ip, ix, dt = U.np_arrays()
    np.testing.assert_allclose(cla.usolve(ip, ix, dt, b),
                               np.linalg.solve(Ud, b), rtol=1e-10)
    np.testing.assert_allclose(cla.utsolve(ip, ix, dt, b),
                               np.linalg.solve(Ud.T, b), rtol=1e-10)


def test_trisolve_plan_direct():
    n = 50
    rng = np.random.RandomState(5)
    Ld = np.tril(rng.randn(n, n) * (rng.rand(n, n) < 0.2)) + np.eye(n) * 2
    L = cst.dense_to_csc(Ld)
    ip, ix, dt = L.np_arrays()
    plan = cla.TriSolvePlan(n, ip, ix, dt, lower=True)
    b = rng.randn(n)
    np.testing.assert_allclose(np.asarray(plan.solve(b)),
                               np.linalg.solve(Ld, b), rtol=1e-10)
    # batched
    B = rng.randn(n, 8)
    np.testing.assert_allclose(np.asarray(plan.solve(B)),
                               np.linalg.solve(Ld, B), rtol=1e-10)


def test_complex_lu():
    """Ybus matrices are complex — LU must support complex128."""
    n = 40
    a_sp = ybus_like(n, seed=6).astype(np.complex128)
    a_sp = a_sp + 1j * ybus_like(n, seed=8).astype(np.complex128) * 0.3
    a = cst.CSC.from_scipy(a_sp.tocsc())
    b = np.random.RandomState(6).randn(n) + 1j * np.random.RandomState(9).randn(n)
    x = np.asarray(cla.spsolve(a, b))
    np.testing.assert_allclose(x, spla.spsolve(a_sp.tocsc(), b), rtol=1e-8)


def test_level_schedule():
    # chain: 0 <- 1 <- 2  plus isolated 3
    rows = np.array([1, 2])
    cols = np.array([0, 1])
    lev = cla.level_schedule(4, rows, cols, lower=True)
    np.testing.assert_array_equal(lev, [0, 1, 2, 0])
    with pytest.raises(ValueError):
        cla.level_schedule(2, np.array([0, 1]), np.array([1, 0]), lower=True)


class TestDenseTailPlan:
    """Hybrid level-scheduled + dense-matmul-tail solve plans."""

    def _grid_lu(self, n=3000, ordering="amd"):
        from csparse3_jax.models.grids import synthetic_grid

        g = synthetic_grid(n, seed=1)
        bp = 1.0 / g.x
        rows = np.concatenate([g.f, g.t, g.f, g.t])
        cols = np.concatenate([g.f, g.t, g.t, g.f])
        vals = np.concatenate([bp, bp, -bp, -bp])
        B = cst.from_triplets(rows, cols, vals, (n, n))
        return cla.splu(cst.add(B, cst.diags(np.full(n, 3.0))),
                        ordering=ordering), n

    def test_auto_plan_uses_dense_tail_and_matches(self):
        from csparse3_jax.linalg.trisolve import DenseTailTriSolvePlan

        lu, n = self._grid_lu()
        plan = lu.solve_plan()  # auto
        assert isinstance(plan.lplan, DenseTailTriSolvePlan)
        b = np.random.RandomState(0).randn(n, 8)
        x = np.asarray(jax.jit(plan)(jnp.asarray(b)))
        np.testing.assert_allclose(x, lu.solve_host(b), rtol=1e-9, atol=1e-11)

    def test_level_style_still_available(self):
        from csparse3_jax.linalg.trisolve import TriSolvePlan

        lu, n = self._grid_lu(n=1200)
        plan = lu.solve_plan("level")
        assert isinstance(plan.lplan, TriSolvePlan)
        b = np.random.RandomState(1).randn(n)
        np.testing.assert_allclose(
            np.asarray(plan(jnp.asarray(b))), lu.solve_host(b),
            rtol=1e-9, atol=1e-11,
        )

    def test_auto_plan_step_count_collapses(self):
        lu, n = self._grid_lu()
        auto = lu.solve_plan("auto")
        level = lu.solve_plan("level")
        # the dense tail must absorb the vast majority of dependency levels
        assert auto.lplan.nlevels * 5 < level.lplan.nlevels


class TestSupernodal:
    """BLAS-3 multifrontal kernel (native/lu_sn.cpp, splu mode='auto' /
    'supernodal')."""

    def _need_native(self):
        pytest.importorskip("csparse3_jax.native.host_ext")

    @pytest.mark.parametrize("n", [50, 300, 1500])
    def test_forced_supernodal_matches_scipy(self, n):
        self._need_native()
        a_sp = ybus_like(n, seed=n + 1)
        a = cst.CSC.from_scipy(a_sp)
        lu = cla.splu(a, mode="supernodal")
        assert lu.method == "supernodal"
        b = np.random.RandomState(2).rand(n)
        x = lu.solve_host(b)
        np.testing.assert_allclose(x, spla.spsolve(a_sp, b),
                                   rtol=1e-9, atol=1e-12)

    def test_reconstruction_exact(self):
        self._need_native()
        a_sp = ybus_like(400, seed=9)
        a = cst.CSC.from_scipy(a_sp)
        lu = cla.splu(a, mode="supernodal")
        L = sp.csc_matrix(
            (lu.L.np_arrays()[2], lu.L.np_arrays()[1], lu.L.np_arrays()[0]),
            shape=(400, 400))
        U = sp.csc_matrix(
            (lu.U.np_arrays()[2], lu.U.np_arrays()[1], lu.U.np_arrays()[0]),
            shape=(400, 400))
        paq = a_sp[np.asarray(lu.perm_r)][:, np.asarray(lu.perm_c)]
        err = abs((L @ U - paq)).max()
        assert err < 1e-10 * abs(a_sp).max()

    def test_auto_picks_supernodal_on_grid(self):
        self._need_native()
        a_sp = ybus_like(1024, seed=3)
        lu = cla.splu(cst.CSC.from_scipy(a_sp))
        assert lu.method == "supernodal"
        b = np.random.RandomState(0).rand(1024)
        np.testing.assert_allclose(lu.solve_host(b), spla.spsolve(a_sp, b),
                                   rtol=1e-8, atol=1e-11)

    def test_auto_keeps_gp_for_unsymmetric_or_small(self):
        self._need_native()
        # strongly unsymmetric pattern -> gp
        rng = np.random.RandomState(1)
        a_sp = (sp.random(800, 800, density=0.004, random_state=rng)
                + sp.diags(np.full(800, 5.0))).tocsc()
        lu = cla.splu(cst.CSC.from_scipy(a_sp))
        assert lu.method == "gp"
        # small n -> gp
        small = ybus_like(60, seed=2)
        assert cla.splu(cst.CSC.from_scipy(small)).method == "gp"
        # tol=0 (banded no-exchange contract) -> gp
        big = ybus_like(1024, seed=4)
        assert cla.splu(cst.CSC.from_scipy(big), tol=0.0).method == "gp"

    def test_supernodal_complex(self):
        self._need_native()
        n = 600
        rng = np.random.RandomState(5)
        a_sp = sp.random(n, n, density=0.005, random_state=rng) \
            + 1j * sp.random(n, n, density=0.005,
                             random_state=np.random.RandomState(6))
        a_sp = (a_sp + a_sp.T + sp.diags(np.full(n, 6.0 + 3.0j))).tocsc()
        lu = cla.splu(cst.CSC.from_scipy(a_sp), mode="supernodal")
        assert lu.method == "supernodal"
        b = rng.rand(n) + 1j * rng.rand(n)
        x = lu.solve_host(b)
        res = np.linalg.norm(a_sp @ x - b) / np.linalg.norm(b)
        assert res < 1e-12

    def test_singular_falls_back_and_reports(self):
        self._need_native()
        n = 700
        a_sp = ybus_like(n, seed=8).tolil()
        a_sp[:, 5] = 0.0
        a_sp[5, :] = 0.0
        a = cst.CSC.from_scipy(a_sp.tocsc())
        lu = cla.splu(a)  # auto: sn declines on the zero pivot -> gp
        assert lu.method == "gp"
        assert lu.is_singular


def test_iterative_refinement_f32_factor():
    """linalg.refine: f32 factor + f64 residual reaches f64 accuracy in
    one sweep (the LAPACK dsgesv mixed-precision pattern)."""
    import scipy.sparse.linalg as spla

    from csparse3_jax.linalg import BandedLU, refine
    from csparse3_jax.models.grids import synthetic_grid

    n = 1000
    g = synthetic_grid(n, seed=1)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    a = cst.add(cst.from_triplets(rows, cols, vals, (n, n)),
                cst.diags(np.full(n, 3.0)))
    plan = BandedLU(a, dtype=np.float32)
    yplan = cst.SpMVPlan(a)
    b = np.random.RandomState(0).rand(n)
    xr = spla.spsolve(a.to_scipy().tocsc(), b)
    x0 = np.asarray(plan(b.astype(np.float32))).astype(np.float64)
    x1 = np.asarray(refine(plan, yplan, b, iters=1))
    e0 = np.abs(x0 - xr).max() / np.abs(xr).max()
    e1 = np.abs(x1 - xr).max() / np.abs(xr).max()
    assert e0 > 1e-9          # the f32 factor alone is f32-accurate
    assert e1 < 1e-12, e1     # one sweep recovers f64
