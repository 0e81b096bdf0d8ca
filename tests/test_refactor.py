"""Device numeric refactorization (linalg/refactor.py) vs scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst

from conftest import rand_sp


def _case(n, seed, cx=True):
    from csparse3_jax.models.grids import synthetic_grid, ybus

    g = synthetic_grid(n, seed=seed)
    Y, _, _ = ybus(g)
    shift = (0.4 + 0.4j) if cx else 2.0
    ys = Y.to_scipy() + sp.eye(n) * shift
    if not cx:
        ys = abs(ys).real + sp.eye(n)
    return ys.tocsc()


def test_same_values_reproduce():
    ys = _case(120, 0)
    A = cst.CSC.from_scipy(ys)
    lu = cst.linalg.splu(A, ordering="amd")
    rp = lu.refactor_plan(A)
    b = np.random.RandomState(1).rand(120) + 0j
    x = np.asarray(rp.refactor(A.np_arrays()[2])(jnp.asarray(b)))
    np.testing.assert_allclose(x, spla.spsolve(ys, b), rtol=1e-10, atol=1e-12)


def test_new_values_same_pattern():
    ys = _case(150, 1)
    A = cst.CSC.from_scipy(ys)
    lu = cst.linalg.splu(A, ordering="amd")
    rp = lu.refactor_plan(A)
    ip, ix, dt = A.np_arrays()
    rng = np.random.RandomState(2)
    dt2 = dt * (1 + 0.5 * rng.rand(len(dt))) + 0.1j * rng.rand(len(dt))
    ys2 = sp.csc_matrix((dt2, ix, ip), shape=ys.shape)
    b = rng.rand(150) + 0j
    x = np.asarray(rp.refactor(jnp.asarray(dt2))(jnp.asarray(b)))
    np.testing.assert_allclose(x, spla.spsolve(ys2, b), rtol=1e-9, atol=1e-11)


def test_jit_and_multi_rhs():
    ys = _case(80, 3)
    A = cst.CSC.from_scipy(ys)
    lu = cst.linalg.splu(A, ordering="amd")
    rp = lu.refactor_plan(A)
    ip, ix, dt = A.np_arrays()
    dt2 = dt * 1.7
    B = np.random.RandomState(4).rand(80, 9) + 0j

    @jax.jit
    def solve(plan, data, rhs):
        return plan.refactor(data)(rhs)

    X = np.asarray(solve(rp, jnp.asarray(dt2), jnp.asarray(B)))
    Xref = spla.spsolve(sp.csc_matrix((dt2, ix, ip), shape=ys.shape), B)
    np.testing.assert_allclose(X, np.asarray(Xref.todense() if sp.issparse(Xref) else Xref),
                               rtol=1e-9, atol=1e-11)


def test_vmap_batched_refactor():
    ys = _case(60, 5)
    A = cst.CSC.from_scipy(ys)
    lu = cst.linalg.splu(A, ordering="amd")
    rp = lu.refactor_plan(A)
    ip, ix, dt = A.np_arrays()
    rng = np.random.RandomState(6)
    scales = 1 + rng.rand(4)
    datas = jnp.asarray(np.stack([dt * s for s in scales]))
    b = jnp.asarray(rng.rand(60) + 0j)

    xs = jax.vmap(lambda d: rp.refactor(d)(b))(datas)
    for i, s in enumerate(scales):
        xref = spla.spsolve(sp.csc_matrix((dt * s, ix, ip), shape=ys.shape),
                            np.asarray(b))
        np.testing.assert_allclose(np.asarray(xs[i]), xref, rtol=1e-9, atol=1e-11)


def test_real_unsymmetric():
    rng = np.random.RandomState(7)
    a = rand_sp(100, 100, 0.05, seed=7) + sp.eye(100) * 8
    a = a.tolil()
    a[3, 60] = 0.5
    a[90, 2] = -0.7
    a = a.tocsc()
    A = cst.CSC.from_scipy(a)
    lu = cst.linalg.splu(A, ordering="amd")
    rp = lu.refactor_plan(A)
    ip, ix, dt = A.np_arrays()
    dt2 = dt * (1 + 0.2 * rng.rand(len(dt)))
    b = rng.rand(100)
    x = np.asarray(rp.refactor(jnp.asarray(dt2))(jnp.asarray(b)))
    np.testing.assert_allclose(
        x, spla.spsolve(sp.csc_matrix((dt2, ix, ip), shape=(100, 100)), b),
        rtol=1e-8, atol=1e-10,
    )


def test_grad_through_refactor_solve():
    """Differentiable factor-solve: jax.grad of a solve w.r.t. the MATRIX
    VALUES flows through the wavefront refactorization (power-flow
    sensitivity analysis use case).  Oracle: central finite differences."""
    import jax.numpy as jnp

    from csparse3_jax import linalg
    from csparse3_jax.models.grids import synthetic_grid

    n = 200
    g = synthetic_grid(n, seed=1)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    a = cst.add(cst.from_triplets(rows, cols, vals, (n, n)),
                cst.diags(np.full(n, 3.0)))
    lu = linalg.splu(a)
    rp = lu.refactor_plan(a)
    b = np.random.RandomState(0).rand(n)
    _, _, data = a.np_arrays()

    def loss(d):
        return jnp.sum(rp.refactor(d)(b) ** 2)

    grad = np.asarray(jax.grad(loss)(jnp.asarray(data)))
    assert np.isfinite(grad).all()
    eps = 1e-6
    for k in (0, 7, 50):
        d1 = data.copy()
        d1[k] += eps
        d0 = data.copy()
        d0[k] -= eps
        fd = (float(loss(jnp.asarray(d1))) - float(loss(jnp.asarray(d0))))
        fd /= 2 * eps
        np.testing.assert_allclose(grad[k], fd, rtol=1e-5)


def test_grad_solve_wrt_rhs():
    """grad through the level-scheduled solve w.r.t. b equals 2 A^-T A^-1 b."""
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    from csparse3_jax import linalg

    a_sp = rand_sp(80, 80, 0.06, seed=9) + sp.diags(np.full(80, 4.0))
    a = cst.CSC.from_scipy(a_sp.tocsc())
    plan = linalg.splu(a).solve_plan()
    b = np.random.RandomState(1).rand(80)
    g = np.asarray(jax.grad(lambda bb: jnp.sum(plan(bb) ** 2))(jnp.asarray(b)))
    x = spla.spsolve(a_sp.tocsc(), b)
    ref = 2.0 * spla.spsolve(a_sp.tocsc().T, x)
    np.testing.assert_allclose(g, ref, rtol=1e-8, atol=1e-10)
