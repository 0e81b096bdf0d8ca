"""All 8 slicing cases vs scipy on the golden 6x3 matrix
(reference: test2_slicing.py — which only prints; here they assert)."""

import numpy as np
import pytest

import csparse3_jax as cst

from conftest import rand_sp


@pytest.fixture
def pair(golden63):
    return cst.CSC.from_scipy(golden63), golden63


def dense(x):
    return np.asarray(x.todense())


def test_scalar(pair):
    a, ref = pair
    assert float(a[1, 0]) == ref[1, 0]
    assert float(a[0, 2]) == 0.0
    assert float(a[-1, -1]) == ref[5, 2]


def test_row(pair):
    a, ref = pair
    np.testing.assert_array_equal(dense(a[1, :]), ref[1, :].toarray())


def test_col(pair):
    a, ref = pair
    np.testing.assert_array_equal(dense(a[:, 2]), ref[:, 2].toarray())


def test_full_copy(pair):
    a, ref = pair
    np.testing.assert_array_equal(dense(a[:, :]), ref.toarray())


def test_row_lists(pair):
    a, ref = pair
    la, lb = [1, 2, 3], [1, 2]
    np.testing.assert_array_equal(
        dense(a[1, lb]), ref[1, :][:, lb].toarray()
    )
    np.testing.assert_array_equal(
        dense(a[la, 2]), ref[la, :][:, 2].toarray()
    )
    np.testing.assert_array_equal(dense(a[:, lb]), ref[:, lb].toarray())
    np.testing.assert_array_equal(dense(a[la, :]), ref[la, :].toarray())
    np.testing.assert_array_equal(
        dense(a[la, lb]), ref[la, :][:, lb].toarray()
    )


def test_slices(pair):
    a, ref = pair
    np.testing.assert_array_equal(dense(a[1:5, 0:2]), ref[1:5, 0:2].toarray())
    np.testing.assert_array_equal(dense(a[1:5, :]), ref[1:5, :].toarray())
    np.testing.assert_array_equal(dense(a[:, 1:3]), ref[:, 1:3].toarray())
    np.testing.assert_array_equal(dense(a[::2, :]), ref[::2, :].toarray())


def test_permutation_and_repeats():
    a_sp = rand_sp(20, 15, 0.2, seed=11)
    a = cst.CSC.from_scipy(a_sp)
    rows = np.array([5, 3, 3, 19, 0])
    cols = np.array([14, 0, 7])
    np.testing.assert_allclose(
        dense(a[rows, cols]), a_sp.toarray()[np.ix_(rows, cols)], rtol=1e-13
    )


def test_setitem_forbidden(pair):
    a, _ = pair
    with pytest.raises(TypeError):
        a[0, 0] = 1.0


def test_sample_offsets():
    import scipy.sparse as sp

    import csparse3_jax as cst
    from csparse3_jax.ops.slicing import sample_offsets

    a = sp.random(30, 40, density=0.15, random_state=np.random.RandomState(3),
                  format="csc")
    A = cst.CSC.from_scipy(a)
    a.sort_indices()
    rows = np.array([0, 5, 29, 12, 7])
    cols = np.array([0, 10, 39, 3, 22])
    offs = sample_offsets(A, rows, cols)
    _, _, data = A.np_arrays()
    dense = a.toarray()
    for r, c, o in zip(rows, cols, offs):
        if o >= 0:
            assert data[o] == dense[r, c]
        else:
            assert dense[r, c] == 0
    # hits must be found for every stored entry
    coo = a.tocoo()
    offs2 = sample_offsets(A, coo.row, coo.col)
    assert (offs2 >= 0).all()
    np.testing.assert_allclose(data[offs2], coo.data)
