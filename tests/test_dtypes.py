"""Dtype breadth: int64 indices end-to-end, int/bool value support
(reference: sparsetools.cxx:44 instantiates I in {int32,int64} and T over
bool/int/float/complex; complex_ops.h / bool_ops.h shims)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
from csparse3_jax import config


@pytest.fixture
def int64_indices():
    config.update(index_dtype=np.int64)
    yield
    config.update(index_dtype=np.int32)


def test_int64_index_end_to_end(int64_indices):
    """index_dtype=int64 through build -> arithmetic -> spmv -> LU solve.

    (A true >=2^31-nnz case cannot allocate here; this exercises the
    full int64 index path the config declares — the overflow regime's
    dtype plumbing, reference csr.h:591-596 overflow guard.)"""
    from csparse3_jax.linalg import splu
    from csparse3_jax.models.grids import synthetic_grid

    n = 400
    g = synthetic_grid(n, seed=0)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t]).astype(np.int64)
    cols = np.concatenate([g.f, g.t, g.t, g.f]).astype(np.int64)
    vals = np.concatenate([bp, bp, -bp, -bp])
    A = cst.add(cst.from_triplets(rows, cols, vals, (n, n)),
                cst.diags(np.full(n, 3.0)))
    ip, ix, _ = A.np_arrays()
    assert ip.dtype == np.int64 and ix.dtype == np.int64
    # arithmetic keeps int64 structure
    S = cst.add(A, A)
    assert S.np_arrays()[0].dtype == np.int64
    # spmv
    x = np.random.RandomState(1).rand(n)
    y = np.asarray(cst.SpMVPlan(A)(jnp.asarray(x)))
    ref = A.to_scipy() @ x
    np.testing.assert_allclose(y, ref, rtol=1e-6, atol=1e-8)
    # LU factor + solve
    lu = splu(A, ordering="rcm", tol=0.0)
    xs = np.asarray(lu.solve(np.random.RandomState(2).rand(n)))
    xr = spla.spsolve(A.to_scipy().tocsc(),
                      np.random.RandomState(2).rand(n))
    np.testing.assert_allclose(xs, xr, rtol=1e-6, atol=1e-8)


def _int_pair(seed):
    rng = np.random.RandomState(seed)
    a = (sp.random(25, 25, density=0.2, format="csc", random_state=rng)
         * 10).astype(np.int32)
    b = (sp.random(25, 25, density=0.2, format="csc", random_state=rng)
         * 7).astype(np.int32)
    return a, b, cst.CSC.from_scipy(a), cst.CSC.from_scipy(b)


def test_int_add_elmul_max():
    a_sp, b_sp, a, b = _int_pair(3)
    s = cst.add(a, b)
    assert np.issubdtype(s.dtype, np.integer)
    np.testing.assert_array_equal(np.asarray(s.todense()),
                                  (a_sp + b_sp).toarray())
    m = cst.elmul(a, b)
    np.testing.assert_array_equal(np.asarray(m.todense()),
                                  a_sp.multiply(b_sp).toarray())
    mx = cst.maximum(a, b)
    np.testing.assert_array_equal(np.asarray(mx.todense()),
                                  a_sp.maximum(b_sp).toarray())


def test_int_compare_returns_bool():
    a_sp, b_sp, a, b = _int_pair(4)
    lt = cst.compare(a, b, "lt")
    assert lt.dtype == np.bool_
    ref = (a_sp < b_sp).toarray()
    np.testing.assert_array_equal(np.asarray(lt.todense()), ref)


def _bool_pair(seed):
    rng = np.random.RandomState(seed)
    d = sp.random(30, 30, density=0.2, format="csc", random_state=rng)
    a = (d > 0.5).tocsc()
    b = (d.T > 0.3).tocsc()
    return a, b, cst.CSC.from_scipy(a), cst.CSC.from_scipy(b)


def test_bool_elmul_and_dense():
    a_sp, b_sp, a, b = _bool_pair(5)
    m = cst.elmul(a, b)
    assert m.dtype == np.bool_
    np.testing.assert_array_equal(np.asarray(m.todense()),
                                  a_sp.multiply(b_sp).toarray())


def test_bool_maximum_is_or():
    a_sp, b_sp, a, b = _bool_pair(6)
    mx = cst.maximum(a, b)
    ref = a_sp.maximum(b_sp).toarray()
    np.testing.assert_array_equal(np.asarray(mx.todense()), ref)


def test_bool_transpose_spgemm():
    a_sp, _, a, _ = _bool_pair(7)
    t = a.t()
    np.testing.assert_array_equal(np.asarray(t.todense()),
                                  a_sp.T.toarray())
    # pattern product in int space (bool matmul promotes, scipy-style)
    g = cst.spgemm(a.astype(np.int32), a.astype(np.int32).t())
    ref = (a_sp.astype(np.int32) @ a_sp.astype(np.int32).T).toarray()
    np.testing.assert_array_equal(np.asarray(g.todense()), ref)


def test_int_spgemm_all_paths():
    """Integer-valued SpGEMM policy (reference instantiates T over
    int8..int64 for matmat, sparsetools.cxx:44, csr.i:12-41): the host
    Gustavson path computes EXACTLY in the input integer dtype; the
    device paths (SpGEMMPlan.numeric, ESC) compute in the configured
    narrowed dtype (int64 -> int32, mirroring the f64 -> f32 device
    value policy)."""
    from csparse3_jax.ops import construct
    from csparse3_jax.ops.spgemm import spgemm_symbolic
    from csparse3_jax.ops.spgemm_device import spgemm_device

    rng = np.random.RandomState(11)
    for dt in (np.int8, np.int16, np.int32):
        a_sp = (sp.random(40, 40, density=0.15, format="csc",
                          random_state=rng) * 5).astype(dt)
        A = cst.CSC.from_scipy(a_sp)
        # host eager spgemm + gram keep the input dtype, exact result
        G = cst.gram(A)
        assert G.dtype == dt, (dt, G.dtype)
        ref = (a_sp @ a_sp.T).tocsc()
        np.testing.assert_array_equal(
            np.asarray(G.todense()).astype(np.int64),
            ref.toarray().astype(np.int64))
        C = cst.spgemm(A, A)
        np.testing.assert_array_equal(
            np.asarray(C.todense()).astype(np.int64),
            (a_sp @ a_sp).toarray().astype(np.int64))
    # device paths: int32 in, int32 out, exact
    a_sp = (sp.random(40, 40, density=0.15, format="csc",
                      random_state=rng) * 5).astype(np.int32)
    A = cst.CSC.from_scipy(a_sp)
    B = construct.transpose(A)
    plan = spgemm_symbolic(A, B)
    Cd = plan.numeric(A.data, B.data)
    assert np.issubdtype(Cd.data.dtype, np.integer)
    got = cst.CSC(A.m, A.m, *[np.asarray(x) for x in
                              (Cd.indptr, Cd.indices, Cd.data)])
    ref = (a_sp @ a_sp.T).tocsc()
    np.testing.assert_array_equal(np.asarray(got.todense()), ref.toarray())
    esc = spgemm_device(A, B)
    np.testing.assert_array_equal(np.asarray(esc.todense()), ref.toarray())


def test_int64_values_narrow_documented():
    """int64 VALUES narrow to int32 on container ingest (jax x64 off) —
    the integer analogue of the f64 -> f32 device policy.  This test
    pins the documented behavior: results are exact when they fit
    int32."""
    a_sp = (sp.random(30, 30, density=0.2, format="csc",
                      random_state=np.random.RandomState(12))
            * 9).astype(np.int64)
    A = cst.CSC.from_scipy(a_sp)
    G = cst.gram(A)
    assert np.issubdtype(G.dtype, np.integer)
    ref = (a_sp @ a_sp.T).tocsc()
    np.testing.assert_array_equal(
        np.asarray(G.todense()).astype(np.int64), ref.toarray())


def test_bool_densify_many_duplicates():
    """256 duplicate True triplets at one coordinate must densify as
    True (scatter-max OR semantics; uint8 scatter-ADD wrapped to 0)."""
    k = 256
    coo = cst.COO(4, 4, np.zeros(k, np.int32), np.zeros(k, np.int32),
                  np.ones(k, np.bool_), nnz=k)
    d = np.asarray(coo.to_dense())
    assert d[0, 0], "duplicate Trues wrapped to False"
