"""TripletBuilder (LilMat/CooMat) semantics
(reference: test4_lil_matrix_slicing.py setitem cases, lil.py:47-257)."""

import numpy as np
import scipy.sparse as sp

import csparse3_jax as cst


def test_setitem_cases():
    ours = cst.LilMat(6, 6)
    ref = sp.lil_matrix((6, 6))
    # scalar
    ours[0, 0] = 2.0
    ref[0, 0] = 2.0
    # row broadcast over column list
    ours[1, [0, 2, 4]] = 7.0
    ref[1, [0, 2, 4]] = 7.0
    # column slice
    ours[2:5, 1] = 3.0
    ref[2:5, 1] = 3.0
    # window broadcast
    ours[3:5, 3:5] = 1.5
    ref[3:5, 3:5] = 1.5
    # window with array values
    vals = np.arange(4.0).reshape(2, 2)
    ours[0:2, 4:6] = vals
    ref[0:2, 4:6] = vals
    # overwrite (last write wins)
    ours[0, 0] = 9.0
    ref[0, 0] = 9.0
    np.testing.assert_allclose(
        np.asarray(ours.to_csc().todense()), ref.toarray(), rtol=1e-13
    )


def test_accumulate_vs_override():
    b = cst.TripletBuilder(3, 3)
    b.add(0, 0, 1.0).add(0, 0, 2.0)  # accumulates
    b.add_triplets([1, 2], [1, 2], [5.0, 6.0])
    assert b.try_get(0, 0) == 3.0
    b.insert_or_replace(0, 0, 10.0)  # override wins over accumulation
    d = np.asarray(b.to_csc().todense())
    np.testing.assert_allclose(d, [[10, 0, 0], [0, 5, 0], [0, 0, 6]])


def test_iadd_isub():
    a = cst.LilMat(3, 3)
    a[0, 0] = 1.0
    b = cst.LilMat(3, 3)
    b.add(0, 0, 2.0)
    b.add(1, 1, 4.0)
    a += b
    d = np.asarray(a.to_csc().todense())
    # setitem in `a` merges additively with b's accumulated entries
    np.testing.assert_allclose(d, [[3, 0, 0], [0, 4, 0], [0, 0, 0]])
    a -= b
    d2 = np.asarray(a.to_csc().todense())
    np.testing.assert_allclose(d2, [[1, 0, 0], [0, 0, 0], [0, 0, 0]])


def test_getitem_window():
    b = cst.LilMat(4, 4)
    b[1, 1] = 5.0
    win = b[0:2, 0:2]
    np.testing.assert_allclose(win, [[0, 0], [0, 5.0]])


def test_bulk_ybus_assembly():
    """Vectorized assembly path: a small admittance-like matrix built in one
    add_triplets call vs scipy coo accumulation."""
    rng = np.random.RandomState(0)
    n, e = 50, 200
    f = rng.randint(0, n, e)
    t = rng.randint(0, n, e)
    y = rng.randn(e)
    b = cst.TripletBuilder(n, n)
    b.add_triplets(f, f, y)
    b.add_triplets(t, t, y)
    b.add_triplets(f, t, -y)
    b.add_triplets(t, f, -y)
    ours = b.to_csc()
    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([f, t, t, f])
    vals = np.concatenate([y, y, -y, -y])
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    np.testing.assert_allclose(np.asarray(ours.todense()), ref.toarray(), rtol=1e-12)
