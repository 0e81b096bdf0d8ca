"""SpGEMM vs scipy (reference: test1_operations.py A·B; csr_product_test.py
intent — that reference test is broken, SURVEY §4)."""

import jax
import numpy as np
import pytest

import csparse3_jax as cst

from conftest import assert_csc_equal, rand_sp


@pytest.mark.parametrize("seed,ma,k,nb,da,db", [
    (0, 60, 60, 60, 0.05, 0.05),
    (1, 40, 70, 30, 0.1, 0.08),
    (2, 30, 10, 50, 0.3, 0.3),
    (3, 5, 5, 5, 1.0, 1.0),
])
def test_spgemm_vs_scipy(seed, ma, k, nb, da, db):
    a_sp = rand_sp(ma, k, da, seed=seed)
    b_sp = rand_sp(k, nb, db, seed=seed + 50)
    a, b = cst.CSC.from_scipy(a_sp), cst.CSC.from_scipy(b_sp)
    c = cst.spgemm(a, b)
    ref = (a_sp @ b_sp).tocsc()
    assert_csc_equal(c, ref, rtol=1e-11, pattern_exact=False)
    assert_csc_equal(a.dot(b), ref, rtol=1e-11, pattern_exact=False)
    assert_csc_equal(a * b, ref, rtol=1e-11, pattern_exact=False)


def test_gram():
    a_sp = rand_sp(40, 60, 0.07, seed=7)
    a = cst.CSC.from_scipy(a_sp)
    assert_csc_equal(cst.gram(a), (a_sp @ a_sp.T).tocsc(), rtol=1e-11,
                     pattern_exact=False)


@pytest.mark.parametrize("m,k,dens,dtype", [
    (200, 300, 0.03, np.float64),
    (500, 100, 0.02, np.float64),     # tall: k < m
    (300, 300, 0.05, np.complex128),  # symmetric non-conjugated product
    (400, 200, 0.04, np.float32),
    (3000, 3000, 0.01, np.float64),   # above the threading threshold
])
def test_gram_fused_kernel(m, k, dens, dtype):
    """The fused native A@A.T kernel (lower-half Gustavson + mirror) vs
    scipy, including canonical (strictly sorted) output columns."""
    a_sp = rand_sp(m, k, dens, seed=m + k)
    if np.issubdtype(dtype, np.complexfloating):
        a_sp = a_sp + 1j * rand_sp(m, k, dens, seed=m + k + 1)
    a_sp = a_sp.astype(dtype).tocsc()
    g = cst.gram(cst.CSC.from_scipy(a_sp))
    ref = (a_sp @ a_sp.T).tocsc()
    ref.sum_duplicates()
    rtol = 1e-5 if dtype == np.float32 else 1e-11
    assert_csc_equal(g, ref, rtol=rtol, pattern_exact=False)
    ip, rows, _ = g.np_arrays()
    ip = np.asarray(ip)
    rows = np.asarray(rows)
    for j in range(g.n):
        seg = rows[ip[j]:ip[j + 1]]
        assert np.all(np.diff(seg) > 0), f"column {j} not canonical"


def test_empty_product():
    a = cst.from_triplets([], [], [], (4, 3))
    b = cst.from_triplets([0], [0], [1.0], (3, 2))
    c = cst.spgemm(a, b)
    assert c.shape == (4, 2)
    assert c.nnz == 0


def test_symbolic_numeric_reuse():
    """pass1/pass2 split (reference: csc_matmat_pass1/2, csc.py:354-370):
    structure computed once, numeric multiply re-run under jit with new
    values on the same patterns."""
    a_sp = rand_sp(50, 50, 0.06, seed=8)
    b_sp = rand_sp(50, 50, 0.06, seed=9)
    a, b = cst.CSC.from_scipy(a_sp), cst.CSC.from_scipy(b_sp)
    plan = cst.spgemm_symbolic(a, b)

    numeric = jax.jit(plan.numeric)
    c1 = numeric(a.data, b.data)
    assert_csc_equal(c1, (a_sp @ b_sp).tocsc(), rtol=1e-11, pattern_exact=False)

    # same patterns, new values
    a2 = a_sp.copy()
    a2.data = a2.data * 3.0 + 1.0
    c2 = numeric(cst.CSC.from_scipy(a2).data, b.data)
    assert_csc_equal(c2, (a2 @ b_sp).tocsc(), rtol=1e-11, pattern_exact=False)


def test_identity_product(golden63):
    a = cst.CSC.from_scipy(golden63)
    i6 = cst.eye(6)
    assert_csc_equal(cst.spgemm(i6, a), golden63)
    i3 = cst.eye(3)
    assert_csc_equal(cst.spgemm(a, i3), golden63)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_numeric_small_operand_matches_scipy(dtype):
    """SpGEMMPlan.numeric (the v2 XLA compress) on a small operand with
    multi-product outputs AND a hub column, in each value dtype: exact
    for integers, to rounding for floats, dtype preserved."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from csparse3_jax.ops import construct
    from csparse3_jax.ops.spgemm import spgemm_symbolic

    rng = np.random.RandomState(7)
    a_sp = sp.random(300, 200, density=0.03, format="csc", random_state=rng,
                     data_rvs=lambda k: rng.randint(1, 9, k).astype(float))
    a_sp = (a_sp + sp.csc_matrix(
        (rng.randint(1, 9, 60).astype(float),
         (rng.permutation(300)[:60], np.full(60, 5))),
        shape=(300, 200))).tocsc()
    A = cst.CSC.from_scipy(a_sp)
    B = construct.transpose(A)
    plan = spgemm_symbolic(A, B)
    a_v = jnp.asarray(np.asarray(A.np_arrays()[2]).astype(dtype))
    b_v = jnp.asarray(np.asarray(B.np_arrays()[2]).astype(dtype))
    C = jax.jit(plan.numeric)(a_v, b_v)
    assert C.data.dtype == a_v.dtype
    ref = (a_sp @ a_sp.T).toarray()
    got = np.asarray(C.todense())
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6)

