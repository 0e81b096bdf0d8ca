"""Elementwise ops vs scipy (test model: reference test1_operations.py)."""

import numpy as np
import pytest
import scipy.sparse as sp

import csparse3_jax as cst

from conftest import assert_csc_equal, rand_sp


def _pair(seed=0):
    a_sp = rand_sp(60, 60, 0.08, seed=seed)
    b_sp = rand_sp(60, 60, 0.08, seed=seed + 100)
    return a_sp, b_sp, cst.CSC.from_scipy(a_sp), cst.CSC.from_scipy(b_sp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_sub(seed):
    a_sp, b_sp, a, b = _pair(seed)
    assert_csc_equal(a + b, a_sp + b_sp, pattern_exact=False)
    assert_csc_equal(a - b, a_sp - b_sp, pattern_exact=False)
    assert_csc_equal(cst.axpby(2.5, a, -0.5, b), 2.5 * a_sp - 0.5 * b_sp,
                     pattern_exact=False)


def test_scale_neg():
    a_sp, _, a, _ = _pair(3)
    assert_csc_equal(a * 5.0, a_sp * 5.0)
    assert_csc_equal(5.0 * a, a_sp * 5.0)
    assert_csc_equal(-a, -a_sp)


def test_elmul_eldiv():
    a_sp, b_sp, a, b = _pair(4)
    assert_csc_equal(cst.elmul(a, b), a_sp.multiply(b_sp), pattern_exact=False)
    # eldiv only defined on the intersection; compare values there
    inter = (a_sp != 0).multiply(b_sp != 0)
    ours = cst.eldiv(a, b)
    ref_dense = np.where(inter.toarray(), a_sp.toarray() / np.where(b_sp.toarray() == 0, 1, b_sp.toarray()), 0)
    np.testing.assert_allclose(np.asarray(ours.todense()), ref_dense, rtol=1e-12)


def test_max_min():
    a_sp, b_sp, a, b = _pair(5)
    assert_csc_equal(cst.maximum(a, b), a_sp.maximum(b_sp), pattern_exact=False)
    assert_csc_equal(cst.minimum(a, b), a_sp.minimum(b_sp), pattern_exact=False)


def test_compare():
    a_sp, b_sp, a, b = _pair(6)
    ne = cst.compare(a, b, "ne")
    ref = (a_sp != b_sp).astype(np.float64)
    np.testing.assert_array_equal(np.asarray(ne.todense()), ref.toarray())
    gt = cst.compare(a, b, "gt")
    ref_gt = (a_sp > b_sp).astype(np.float64)
    np.testing.assert_array_equal(np.asarray(gt.todense()), ref_gt.toarray())


def test_equal_exact(golden63):
    a = cst.CSC.from_scipy(golden63)
    b = cst.CSC.from_scipy(golden63.copy())
    assert a == b
    c = cst.scale(a, 2.0)
    assert not (a == c)


def test_eliminate_zeros():
    a = cst.from_triplets([0, 1, 2], [0, 1, 2], [1.0, 0.0, 3.0], (3, 3))
    e = cst.eliminate_zeros(a)
    assert e.nnz == 2
    np.testing.assert_array_equal(
        np.asarray(e.todense()), np.diag([1.0, 0.0, 3.0])
    )


def test_cancellation_keeps_union_pattern():
    # A + (-A) keeps the union pattern with explicit zeros (scipy-compatible)
    a_sp = rand_sp(30, 30, 0.1, seed=9)
    a = cst.CSC.from_scipy(a_sp)
    z = a + (-a)
    assert z.nnz == a.nnz
    assert float(cst.norm(z)) == 0.0


def test_norms(golden63):
    a = cst.CSC.from_scipy(golden63)
    assert float(cst.norm(a, 1)) == np.abs(golden63.toarray()).sum(axis=0).max()
    assert float(cst.norm(a, np.inf)) == np.abs(golden63.toarray()).sum(axis=1).max()
    np.testing.assert_allclose(
        float(cst.norm(a, "fro")), np.linalg.norm(golden63.toarray(), "fro")
    )


def test_diagonal_and_sums(golden63):
    a = cst.CSC.from_scipy(golden63)
    np.testing.assert_array_equal(np.asarray(a.diagonal()), golden63.toarray().diagonal())
    np.testing.assert_allclose(float(a.sum()), golden63.toarray().sum())
    np.testing.assert_allclose(np.asarray(a.sum(axis=0)), golden63.toarray().sum(axis=0))
    np.testing.assert_allclose(np.asarray(a.sum(axis=1)), golden63.toarray().sum(axis=1))
