"""Native BSR block ops (ops/bsr_ops.py) vs scipy.bsr_matrix."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import csparse3_jax as cst
from csparse3_jax.ops import bsr_ops


def _rand_bsr(m, n, R, C, density, seed):
    rng = np.random.RandomState(seed)
    a = sp.random(m, n, density=density, format="csc", random_state=rng)
    return cst.CSC.from_scipy(a).to_bsr(block=(R, C)), a


def test_transpose_no_csc_roundtrip():
    A, a = _rand_bsr(60, 45, 4, 3, 0.05, 0)
    T = A.t()
    assert (T.R, T.C) == (3, 4) and T.shape == (45, 60)
    ref = a.T.toarray()
    np.testing.assert_allclose(np.asarray(T.todense()), ref, atol=1e-12)
    # round trip returns the original
    np.testing.assert_allclose(np.asarray(T.t().todense()), a.toarray(),
                               atol=1e-12)


def test_add_sub_union_pattern():
    A, a = _rand_bsr(48, 48, 8, 8, 0.05, 1)
    B, b = _rand_bsr(48, 48, 8, 8, 0.05, 2)
    S = A + B
    D = A - B
    np.testing.assert_allclose(np.asarray(S.todense()), (a + b).toarray(),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(D.todense()), (a - b).toarray(),
                               atol=1e-12)
    # stays BSR with the same block size
    assert (S.R, S.C) == (8, 8)


def test_binop_elmul_max():
    A, a = _rand_bsr(32, 40, 4, 8, 0.08, 3)
    B, b = _rand_bsr(32, 40, 4, 8, 0.08, 4)
    M = bsr_ops.bsr_binop(A, B, jnp.multiply)
    ref = a.multiply(b).toarray()
    np.testing.assert_allclose(np.asarray(M.todense()), ref, atol=1e-12)
    X = bsr_ops.bsr_binop(A, B, jnp.maximum)
    ref = np.maximum(a.toarray(), b.toarray())
    np.testing.assert_allclose(np.asarray(X.todense()), ref, atol=1e-12)


def test_matmat_block_gustavson():
    A, a = _rand_bsr(40, 64, 8, 8, 0.06, 5)
    B, b = _rand_bsr(64, 56, 8, 8, 0.06, 6)
    C = A @ B
    assert isinstance(C, cst.BSR) and (C.R, C.C) == (8, 8)
    np.testing.assert_allclose(np.asarray(C.todense()), (a @ b).toarray(),
                               atol=1e-10)


def test_matmat_rect_blocks():
    A, a = _rand_bsr(24, 30, 4, 5, 0.15, 7)
    B, b = _rand_bsr(30, 16, 5, 8, 0.15, 8)
    C = bsr_ops.bsr_matmat(A, B)
    assert (C.R, C.C) == (4, 8)
    np.testing.assert_allclose(np.asarray(C.todense()), (a @ b).toarray(),
                               atol=1e-10)


def test_matmat_plan_reuse_jit():
    import jax

    A, a = _rand_bsr(32, 32, 8, 8, 0.1, 9)
    plan = bsr_ops.BSRMatMatPlan(A, A)
    f = jax.jit(plan.numeric)
    C1 = f(A.data[:A.nnz_blocks], A.data[:A.nnz_blocks])
    C2 = f(2.0 * A.data[:A.nnz_blocks], A.data[:A.nnz_blocks])
    np.testing.assert_allclose(np.asarray(C1.todense()), (a @ a).toarray(),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(C2.todense()),
                               (2.0 * a @ a).toarray(), atol=1e-10)


def test_matmat_empty():
    A = cst.from_triplets(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0), (16, 16)).to_bsr(block=(8, 8))
    C = bsr_ops.bsr_matmat(A, A)
    assert C.out_nblocks if hasattr(C, "out_nblocks") else C.nnz_blocks == 0
    assert np.abs(np.asarray(C.todense())).max() == 0.0


def test_guards():
    A, _ = _rand_bsr(16, 16, 4, 4, 0.2, 10)
    B, _ = _rand_bsr(16, 16, 8, 8, 0.2, 11)
    with pytest.raises(ValueError, match="matching shape and block"):
        bsr_ops.bsr_add(A, B)
    with pytest.raises(ValueError, match="mismatch"):
        bsr_ops.BSRMatMatPlan(A, B)
