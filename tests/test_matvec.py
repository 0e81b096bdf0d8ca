"""SpMV / SpMM vs scipy (reference: test1_operations.py C*x, A*X cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import csparse3_jax as cst

from conftest import rand_sp


@pytest.mark.parametrize("shape,density,seed", [
    ((100, 100), 0.01, 0),
    ((80, 50), 0.1, 1),
    ((50, 80), 0.05, 2),
])
def test_spmv(shape, density, seed):
    a_sp = rand_sp(*shape, density, seed=seed)
    a = cst.CSC.from_scipy(a_sp)
    rng = np.random.RandomState(seed)
    x = rng.randn(shape[1])
    np.testing.assert_allclose(np.asarray(cst.spmv(a, x)), a_sp @ x, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a * x), a_sp @ x, rtol=1e-12)
    # numpy debug backend agrees
    np.testing.assert_allclose(
        np.asarray(cst.spmv(a, x, backend="numpy")), a_sp @ x, rtol=1e-12
    )


def test_spmm():
    a_sp = rand_sp(60, 40, 0.08, seed=3)
    a = cst.CSC.from_scipy(a_sp)
    X = np.random.RandomState(3).randn(40, 5)
    np.testing.assert_allclose(np.asarray(cst.spmm(a, X)), a_sp @ X, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a * X), a_sp @ X, rtol=1e-12)


def test_spmv_plan_jit():
    a_sp = rand_sp(64, 64, 0.1, seed=4)
    a = cst.CSC.from_scipy(a_sp)
    plan = cst.SpMVPlan(a)
    x = np.random.RandomState(4).randn(64)

    @jax.jit
    def two_step(plan, x):
        return plan(plan(x))

    np.testing.assert_allclose(np.asarray(two_step(plan, x)), a_sp @ (a_sp @ x),
                               rtol=1e-11)


def test_spmv_grad():
    """SpMV is differentiable in values and x (new capability vs reference)."""
    a_sp = rand_sp(20, 20, 0.2, seed=5)
    a = cst.CSC.from_scipy(a_sp)
    plan = cst.SpMVPlan(a)
    x = np.random.RandomState(5).randn(20)

    def loss(vals, x):
        leaves, treedef = jax.tree_util.tree_flatten(plan)
        p = jax.tree_util.tree_unflatten(treedef, leaves[:-1] + [vals])
        return jnp.sum(p(x) ** 2)

    g = jax.grad(loss, argnums=1)(plan.vals, jnp.asarray(x))
    ref_g = 2 * a_sp.T @ (a_sp @ x)
    np.testing.assert_allclose(np.asarray(g), ref_g, rtol=1e-10)


@pytest.mark.parametrize("block", [(2, 2), (4, 8)])
def test_bsr_spmm(block):
    a_sp = rand_sp(50, 34, 0.1, seed=6)
    a = cst.CSC.from_scipy(a_sp)
    b = a.to_bsr(block=block)
    X = np.random.RandomState(6).randn(34, 7)
    np.testing.assert_allclose(np.asarray(cst.bsr_spmm(b, X)), a_sp @ X, rtol=1e-11)
    x = np.random.RandomState(7).randn(34)
    np.testing.assert_allclose(np.asarray(cst.bsr_spmm(b, x)), a_sp @ x, rtol=1e-11)


class TestSpMVPlanLayouts:
    def test_ell_matches_stream(self, rand_pair):
        import csparse3_jax as cst
        from csparse3_jax.ops.matvec import SpMVPlan

        a, _ = rand_pair
        A = cst.CSC.from_scipy(a)
        x = np.random.RandomState(3).rand(a.shape[1])
        p_ell = SpMVPlan(A, layout="ell")
        p_str = SpMVPlan(A, layout="stream")
        assert p_ell.layout == "ell" and p_str.layout == "stream"
        np.testing.assert_allclose(
            np.asarray(p_ell(jnp.asarray(x))),
            np.asarray(p_str(jnp.asarray(x))),
            rtol=1e-12, atol=1e-13,
        )
        np.testing.assert_allclose(np.asarray(p_ell(jnp.asarray(x))), a @ x,
                                   rtol=1e-12, atol=1e-13)

    def test_ell_multi_rhs(self, rand_pair):
        import csparse3_jax as cst
        from csparse3_jax.ops.matvec import SpMVPlan

        a, _ = rand_pair
        A = cst.CSC.from_scipy(a)
        X = np.random.RandomState(4).rand(a.shape[1], 7)
        p = SpMVPlan(A, layout="ell")
        np.testing.assert_allclose(np.asarray(p(jnp.asarray(X))), a @ X,
                                   rtol=1e-12, atol=1e-13)

    def test_ell_jit_and_pytree(self, rand_pair):
        import csparse3_jax as cst
        from csparse3_jax.ops.matvec import SpMVPlan

        a, _ = rand_pair
        A = cst.CSC.from_scipy(a)
        p = SpMVPlan(A)
        x = jnp.asarray(np.random.RandomState(5).rand(a.shape[1]))
        y = jax.jit(lambda pl, v: pl(v))(p, x)
        np.testing.assert_allclose(np.asarray(y), a @ np.asarray(x),
                                   rtol=1e-12, atol=1e-13)

    def test_outlier_row_falls_back_to_stream(self):
        import csparse3_jax as cst
        from csparse3_jax.ops.matvec import SpMVPlan

        # one dense row in an otherwise ultra-sparse matrix
        n = 500
        rows = np.concatenate([np.zeros(n, np.int64), np.arange(n)])
        cols = np.concatenate([np.arange(n), np.arange(n)])
        vals = np.ones(2 * n)
        A = cst.from_triplets(rows, cols, vals, (n, n))
        p = SpMVPlan(A)
        assert p.layout == "stream"
        x = np.random.RandomState(6).rand(n)
        np.testing.assert_allclose(
            np.asarray(p(jnp.asarray(x))), A.to_scipy() @ x,
            rtol=1e-12, atol=1e-13,
        )


class TestDIAPlan:
    def test_matches_scipy_after_rcm(self):
        from csparse3_jax.linalg.ordering import rcm
        from csparse3_jax.models.grids import synthetic_grid, ybus

        g = synthetic_grid(500, seed=3)
        Y, _, _ = ybus(g)
        p = rcm(Y)
        Yp = Y[p, p]
        plan = cst.SplitDIA(Yp)
        v = np.random.RandomState(0).rand(500) + 1j * np.random.RandomState(1).rand(500)
        yr, yi = jax.jit(lambda q, a, b: q(a, b))(
            plan, jnp.asarray(v.real), jnp.asarray(v.imag)
        )
        ref = Yp.to_scipy() @ v
        np.testing.assert_allclose(
            np.asarray(yr) + 1j * np.asarray(yi), ref, rtol=1e-11, atol=1e-12
        )

    def test_real_multi_rhs(self, rand_pair):
        a, _ = rand_pair
        A = cst.CSC.from_scipy(a)
        plan = cst.DIAPlan(A)
        X = np.random.RandomState(4).rand(a.shape[1], 6)
        np.testing.assert_allclose(
            np.asarray(plan(jnp.asarray(X))), a @ X, rtol=1e-11, atol=1e-12
        )

    def test_rectangular(self):
        import scipy.sparse as sp

        a = sp.random(40, 60, 0.1, random_state=5, format="csc")
        plan = cst.DIAPlan(cst.CSC.from_scipy(a))
        x = np.random.RandomState(6).rand(60)
        np.testing.assert_allclose(
            np.asarray(plan(jnp.asarray(x))), a @ x, rtol=1e-11, atol=1e-12
        )


class TestSymDIAPlan:
    """Symmetric banded SpMV keeping only the d >= 0 diagonals."""

    def _sym(self, n, density, seed):
        import scipy.sparse as sp

        a = sp.random(n, n, density, random_state=seed, format="csc")
        return (a + a.T + sp.eye(n)).tocsc()

    def test_matches_scipy(self):
        a = self._sym(97, 0.05, 1)
        plan = cst.SymDIAPlan(cst.CSC.from_scipy(a), chunk=7)
        x = np.random.RandomState(0).rand(97)
        np.testing.assert_allclose(
            np.asarray(plan(jnp.asarray(x))), a @ x, rtol=1e-11, atol=1e-12
        )

    def test_multi_rhs_and_jit(self):
        a = self._sym(60, 0.08, 2)
        plan = cst.SymDIAPlan(cst.CSC.from_scipy(a), chunk=8)
        X = np.random.RandomState(3).rand(60, 5)
        Y = jax.jit(lambda q, v: q(v))(plan, jnp.asarray(X))
        np.testing.assert_allclose(np.asarray(Y), a @ X, rtol=1e-11, atol=1e-12)

    def test_tridiagonal_exact(self):
        import scipy.sparse as sp

        n = 32
        d = np.arange(1.0, n + 1)
        e = np.full(n - 1, 0.5)
        a = sp.diags([e, d, e], [-1, 0, 1]).tocsc()
        plan = cst.SymDIAPlan(cst.CSC.from_scipy(a), chunk=4)
        x = np.random.RandomState(4).rand(n)
        np.testing.assert_allclose(
            np.asarray(plan(jnp.asarray(x))), a @ x, rtol=1e-13, atol=1e-14
        )

    def test_split_complex_symmetric(self):
        # Ybus is complex symmetric (not hermitian) — exactly this case
        ar = self._sym(50, 0.06, 5)
        ai = self._sym(50, 0.06, 6) * 0.3
        c = (ar + 1j * ai).tocsc()
        plan = cst.SplitSymDIA(cst.CSC.from_scipy(c), chunk=6)
        v = np.random.RandomState(7).rand(50) + 1j * np.random.RandomState(8).rand(50)
        yr, yi = jax.jit(lambda q, a_, b_: q(a_, b_))(
            plan, jnp.asarray(v.real), jnp.asarray(v.imag)
        )
        np.testing.assert_allclose(
            np.asarray(yr) + 1j * np.asarray(yi), c @ v, rtol=1e-11, atol=1e-12
        )

    def test_rejects_rectangular(self):
        import pytest
        import scipy.sparse as sp

        a = sp.random(8, 9, 0.3, random_state=9, format="csc")
        with pytest.raises(ValueError):
            cst.SymDIAPlan(cst.CSC.from_scipy(a))

    def test_rejects_asymmetric_bandwidth(self):
        import pytest
        import scipy.sparse as sp

        # lower bandwidth 3, upper bandwidth 1 — pattern not symmetric
        a = sp.diags([np.ones(5), np.ones(8), np.ones(7)], [-3, 0, 1]).tocsc()
        with pytest.raises(ValueError):
            cst.SymDIAPlan(cst.CSC.from_scipy(a))


# ---------------------------------------------------------------------------
# Split-complex and banded SpMV plans vs scipy: the cases the removed
# band/points kernels (removed) were tested on, now on the plans that replace them
# ---------------------------------------------------------------------------

def _spmv_case(case):
    """(CSC, scipy) for one matrix family of the SpMV-plan tests."""
    import scipy.sparse as sp

    from csparse3_jax.models.grids import synthetic_grid, ybus

    if case == "complex":          # a Ybus: complex symmetric
        Y, _, _ = ybus(synthetic_grid(300, seed=11))
        return Y, Y.to_scipy().tocsc()
    if case == "real":
        a = rand_sp(200, 200, 0.03, seed=12) + sp.eye(200)
        return cst.CSC.from_scipy(a.tocsc()), a.tocsc()
    if case == "banded":           # pure band, no off-band points
        n = 257
        a = sp.diags([np.arange(1.0, n), 4.0 + np.arange(n),
                      -np.arange(1.0, n), np.full(n - 3, 0.5)],
                     [-1, 0, 1, 3], shape=(n, n)).tocsc()
        return cst.CSC.from_scipy(a), a
    # "spread": a narrow band plus entries far from the diagonal
    n = 300
    rng = np.random.RandomState(13)
    far_r = rng.randint(0, n, 40)
    far_c = (far_r + rng.randint(n // 3, 2 * n // 3, 40)) % n
    a = (sp.diags([np.ones(n - 1), 3.0 * np.ones(n), np.ones(n - 1)],
                  [-1, 0, 1], shape=(n, n))
         + sp.csc_matrix((rng.rand(40) + 1j * rng.rand(40),
                          (far_r, far_c)), shape=(n, n))).tocsc()
    a.sum_duplicates()
    return cst.CSC.from_scipy(a), a


@pytest.mark.parametrize("case", ["complex", "real", "banded", "spread"])
@pytest.mark.parametrize("kind", ["ell", "dia"])
def test_split_plans_match_scipy(kind, case):
    A, a_sp = _spmv_case(case)
    plan = cst.SplitSpMV(A) if kind == "ell" else cst.SplitDIA(A)
    rng = np.random.RandomState(14)
    xr, xi = rng.rand(A.n), rng.rand(A.n)
    yr, yi = plan(jnp.asarray(xr), jnp.asarray(xi))
    z = a_sp @ (xr + 1j * xi)
    np.testing.assert_allclose(np.asarray(yr), z.real, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(yi), z.imag, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("layout", ["ell", "stream", "complex"])
def test_spmv_plan_batch_rhs(layout):
    """(n, B) right-hand sides through SpMVPlan's multi-RHS path."""
    A, a_sp = _spmv_case("complex" if layout == "complex" else "real")
    plan = cst.SpMVPlan(A, layout=None if layout == "complex" else layout)
    X = np.random.RandomState(15).rand(A.n, 7)
    np.testing.assert_allclose(np.asarray(plan(jnp.asarray(X))), a_sp @ X,
                               rtol=1e-12, atol=1e-12)


def test_split_spmv_batch_rhs():
    A, a_sp = _spmv_case("complex")
    rng = np.random.RandomState(16)
    Xr, Xi = rng.rand(A.n, 5), rng.rand(A.n, 5)
    Yr, Yi = cst.SplitSpMV(A)(jnp.asarray(Xr), jnp.asarray(Xi))
    Z = a_sp @ (Xr + 1j * Xi)
    np.testing.assert_allclose(np.asarray(Yr) + 1j * np.asarray(Yi), Z,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["split", "dia", "symdia"])
def test_split_plan_as_jit_argument(kind):
    """Plans are pytrees: a plan passed INTO jit (not closed over) gives
    the same product, and a second plan with new values reuses the
    compiled program."""
    A, a_sp = _spmv_case("complex")
    make = {"split": cst.SplitSpMV, "dia": cst.SplitDIA,
            "symdia": cst.SplitSymDIA}[kind]
    f = jax.jit(lambda p, a, b: p(a, b))
    rng = np.random.RandomState(17)
    xr, xi = jnp.asarray(rng.rand(A.n)), jnp.asarray(rng.rand(A.n))
    for scale in (1.0, 2.0):
        As = cst.CSC(A.m, A.n, *A.np_arrays()[:2],
                     scale * A.np_arrays()[2])
        yr, yi = f(make(As), xr, xi)
        z = scale * (a_sp @ (np.asarray(xr) + 1j * np.asarray(xi)))
        np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), z,
                                   rtol=1e-12, atol=1e-12)
    assert f._cache_size() == 1


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_unknown_backend_raises(op):
    """Only the XLA and numpy backends exist."""
    a = cst.CSC.from_scipy(rand_sp(10, 10, 0.2, seed=18))
    x = np.ones(10) if op == "spmv" else np.ones((10, 2))
    with pytest.raises(ValueError, match="backend"):
        getattr(cst, op)(a, x, backend="pallas")
