"""Sparse LDL^T tests (linalg/cholesky.py).

Oracle: scipy.sparse.linalg.spsolve plus direct reconstruction
P A P^T == L D L^T.  The reference has no symmetric solver; this is the
cs_chol capability from the CSparse lineage (SURVEY scope note).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax

import csparse3_jax as cst
from csparse3_jax import linalg
from csparse3_jax.models.grids import synthetic_grid, ybus


def _bprime(n, seed=1, shift=3.0):
    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    return cst.add(cst.from_triplets(rows, cols, vals, (n, n)),
                   cst.diags(np.full(n, shift)))


@pytest.mark.parametrize("ordering", ["amd", "rcm", None])
def test_ldlt_reconstruction(ordering):
    a = _bprime(400)
    f = linalg.ldlt(a, ordering=ordering)
    L = sp.csc_matrix((f.Lx, f.Li, f.Lp), shape=(a.m, a.m))
    Ap = a.to_scipy().tocsc()[f.perm][:, f.perm]
    R = L @ sp.diags(f.D) @ L.T - Ap
    assert (abs(R).max() if R.nnz else 0.0) < 1e-10
    assert not f.is_singular


def test_ldlt_solve_vs_scipy():
    a = _bprime(800)
    f = linalg.ldlt(a)
    rng = np.random.RandomState(0)
    b = rng.rand(a.m)
    xr = spla.spsolve(a.to_scipy().tocsc(), b)
    xh = f.solve_host(b)
    np.testing.assert_allclose(xh, xr, rtol=1e-9, atol=1e-12)
    xd = np.asarray(f.solve(b))
    np.testing.assert_allclose(xd, xr, rtol=1e-6, atol=1e-9)
    # multi-RHS
    B = rng.rand(a.m, 7)
    XH = f.solve_host(B)
    XR = spla.spsolve(a.to_scipy().tocsc(), B)
    np.testing.assert_allclose(XH, XR, rtol=1e-9, atol=1e-12)


def test_ldlt_complex_symmetric():
    """Ybus is complex SYMMETRIC (not Hermitian): LDL^T without
    conjugation factors it exactly."""
    Y, _, _ = ybus(synthetic_grid(500, seed=2))
    f = linalg.ldlt(Y)
    rng = np.random.RandomState(1)
    b = rng.rand(Y.n) + 1j * rng.rand(Y.n)
    xr = spla.spsolve(Y.to_scipy().tocsc(), b)
    xh = f.solve_host(b)
    np.testing.assert_allclose(xh, xr, rtol=1e-8, atol=1e-10)
    xd = np.asarray(f.solve(b))
    np.testing.assert_allclose(xd, xr, rtol=1e-5, atol=1e-7)


def test_ldlt_fill_vs_lu():
    """Symmetric factor stores roughly half of what LU's L+U store."""
    a = _bprime(1000)
    f = linalg.ldlt(a)
    lu = linalg.splu(a, ordering="amd")
    lu_fill = lu._h.Lx.size + lu._h.Ux.size
    assert f.fill_nnz < 0.75 * lu_fill


def test_ldlt_singular_reported():
    s = sp.csc_matrix(np.array([[1.0, 2.0], [2.0, 4.0]]))
    f = linalg.ldlt(cst.CSC.from_scipy(s), ordering=None)
    assert f.is_singular and 1 in f.singular_cols
    with pytest.warns(UserWarning, match="singular"):
        x = f.solve_host(np.ones(2))
    assert not np.all(np.isfinite(x))


def test_ldlt_plan_jit_vmap():
    a = _bprime(200)
    plan = linalg.ldlt(a).solve_plan()
    rng = np.random.RandomState(3)
    B = rng.rand(5, a.m)
    xs = jax.vmap(jax.jit(plan))(B)
    XR = spla.spsolve(a.to_scipy().tocsc(), B.T)
    np.testing.assert_allclose(np.asarray(xs), XR.T, rtol=1e-6, atol=1e-9)


def test_ldlt_rect_raises():
    a = cst.from_triplets([0], [1], [1.0], (2, 3))
    with pytest.raises(ValueError):
        linalg.ldlt(a)


def test_container_traced_no_upload():
    """Regression: eager conversions must not touch the lazy-upload
    properties (uploads there are wasted work).  construct.transpose on a host container must leave
    the raw fields as numpy."""
    from csparse3_jax.ops import construct

    a = sp.random(60, 40, density=0.1,
                  random_state=np.random.RandomState(0)).astype(complex)
    A = cst.CSC.from_scipy(a.tocsc())
    t = construct.transpose(A)
    assert isinstance(A._indptr, np.ndarray), "transpose uploaded its input"
    assert isinstance(A._data, np.ndarray)
    np.testing.assert_allclose(np.asarray(t.todense()), a.T.toarray())
