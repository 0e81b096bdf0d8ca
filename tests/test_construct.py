"""Construction / conversion round-trips vs the scipy oracle
(test model: reference cscs_to_csr_test.py and test1_operations.py)."""

import numpy as np
import pytest
import scipy.sparse as sp

import csparse3_jax as cst

from conftest import assert_csc_equal, rand_sp


@pytest.mark.parametrize("seed,shape,density", [
    (0, (50, 50), 0.05),
    (1, (80, 30), 0.1),
    (2, (30, 80), 0.02),
    (3, (1, 1), 1.0),
    (4, (200, 7), 0.3),
])
def test_from_triplets_vs_scipy(seed, shape, density):
    rng = np.random.RandomState(seed)
    k = max(1, int(shape[0] * shape[1] * density))
    rows = rng.randint(0, shape[0], k)
    cols = rng.randint(0, shape[1], k)
    vals = rng.randn(k)
    ours = cst.from_triplets(rows, cols, vals, shape)
    ref = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsc()
    ref.sum_duplicates()
    assert_csc_equal(ours, ref)
    assert ours.canonical


def test_duplicates_summed():
    ours = cst.from_triplets([0, 0, 1], [0, 0, 1], [1.0, 2.0, 5.0], (2, 2))
    assert ours.nnz == 2
    d = np.asarray(ours.todense())
    np.testing.assert_array_equal(d, [[3.0, 0.0], [0.0, 5.0]])


def test_round_trip_csr_dense(golden63):
    a = cst.CSC.from_scipy(golden63)
    # csc -> csr -> csc
    back = a.to_csr().to_csc()
    assert_csc_equal(back, golden63)
    # csr arrays vs scipy csr (golden check, reference cscs_to_csr_test.py)
    r = a.to_csr()
    ref = golden63.tocsr()
    ip, ix, dt = r.np_arrays()
    np.testing.assert_array_equal(ip, ref.indptr)
    np.testing.assert_array_equal(ix, ref.indices)
    np.testing.assert_array_equal(dt, ref.data)
    # dense
    np.testing.assert_array_equal(np.asarray(a.todense()), golden63.toarray())
    # coo
    assert_csc_equal(a.to_coo().to_csc(), golden63)
    # from_dense
    assert_csc_equal(cst.dense_to_csc(golden63.toarray()), golden63)


def test_transpose(golden63):
    a = cst.CSC.from_scipy(golden63)
    at = a.t()
    assert_csc_equal(at, golden63.T)
    assert_csc_equal(at.t(), golden63)
    assert_csc_equal(a.T, golden63.T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose_random(seed):
    a_sp = rand_sp(70, 40, 0.07, seed=seed)
    a = cst.CSC.from_scipy(a_sp)
    assert_csc_equal(a.t(), a_sp.T)


def test_canonicalize_unsorted():
    # deliberately unsorted rows within a column
    indptr = np.array([0, 3, 4], dtype=np.int32)
    indices = np.array([2, 0, 1, 1], dtype=np.int32)
    data = np.array([1.0, 2.0, 3.0, 4.0])
    a = cst.CSC(3, 2, indptr, indices, data, canonical=False)
    c = cst.canonicalize(a)
    ref = sp.csc_matrix((data, indices, indptr), shape=(3, 2))
    ref.sort_indices()
    assert_csc_equal(c, ref)


def test_eye_diag_diags():
    assert_csc_equal(cst.eye(5), sp.eye(5, format="csc"))
    assert_csc_equal(cst.eye(5, k=1), sp.eye(5, k=1, format="csc"))
    assert_csc_equal(cst.diag(4, 6, 3.0), sp.diags([3.0] * 4, shape=(4, 6)).tocsc())
    v = np.arange(1.0, 6.0)
    assert_csc_equal(cst.diags(v), sp.diags(v).tocsc())


def test_bsr_round_trip(golden63):
    a = cst.CSC.from_scipy(golden63)
    b = a.to_bsr(block=(2, 2))
    np.testing.assert_array_equal(np.asarray(b.todense()), golden63.toarray())


def test_empty():
    a = cst.from_triplets([], [], [], (4, 5))
    assert a.nnz == 0
    assert np.asarray(a.todense()).sum() == 0
    assert_csc_equal(a.t(), sp.csc_matrix((5, 4)))


def test_scipy_adoption(golden63):
    a = cst.scipy_to_mat(golden63)
    assert a.shape == (6, 3)
    assert a.nnz == 10
    back = a.to_scipy()
    assert (back != golden63).nnz == 0


def test_full_format_roundtrip(golden63):
    """coo -> csc -> csr -> csc -> bsr -> dense -> csc -> dia -> csc."""
    import csparse3_jax as cst

    A = cst.CSC.from_scipy(golden63)
    coo = A.to_coo()
    back = coo.to_csc()
    np.testing.assert_allclose(np.asarray(back.todense()), golden63.toarray())
    csr = back.to_csr()
    back2 = csr.to_csc()
    np.testing.assert_allclose(np.asarray(back2.todense()), golden63.toarray())
    bsr = back2.to_bsr(block=(2, 2))
    np.testing.assert_allclose(np.asarray(bsr.todense()), golden63.toarray())
    dense = back2.todense()
    np.testing.assert_allclose(
        np.asarray(cst.CSC.from_dense(np.asarray(dense)).todense()),
        golden63.toarray(),
    )
    dia = cst.csc_to_dia(back2)
    np.testing.assert_allclose(
        np.asarray(cst.dia_to_csc(dia).todense()), golden63.toarray()
    )


def test_real_equivalent_interleaved_and_block():
    """Split-complex real doubling (ops/construct.py::real_equivalent):
    the interleaved layout preserves bandedness (bw -> 2bw+1) and both
    layouts represent the complex product exactly."""
    import numpy as np

    import csparse3_jax as cst
    from csparse3_jax.ops.construct import real_equivalent

    rng = np.random.RandomState(0)
    n = 60
    D = np.zeros((n, n), dtype=np.complex128)
    for off in (-2, -1, 0, 1, 2):
        v = rng.rand(n - abs(off)) + 1j * rng.rand(n - abs(off))
        D += np.diag(v, off)
    D += np.eye(n) * 4.0
    A = cst.CSC.from_dense(D)
    z = rng.rand(n) + 1j * rng.rand(n)

    for interleave in (True, False):
        A2 = real_equivalent(A, interleave=interleave)
        assert A2.shape == (2 * n, 2 * n)
        D2 = np.asarray(A2.todense())
        if interleave:
            z2 = np.empty(2 * n)
            z2[0::2], z2[1::2] = z.real, z.imag
            y2 = D2 @ z2
            y = y2[0::2] + 1j * y2[1::2]
            # interleaved bandwidth: 2*bw + 1
            r_, c_ = np.nonzero(D2)
            assert np.abs(r_ - c_).max() <= 2 * 2 + 1
        else:
            z2 = np.concatenate([z.real, z.imag])
            y2 = D2 @ z2
            y = y2[:n] + 1j * y2[n:]
        np.testing.assert_allclose(y, D @ z, rtol=1e-12, atol=1e-12)

    # real input passes through untouched
    R = cst.CSC.from_dense(np.eye(4))
    assert real_equivalent(R) is R


def test_rowgather_edge_cases():
    """Direct unit tests for the ops/gather.py substrate (exactness,
    empty index set, pad_to handling, integer dtypes)."""
    import jax.numpy as jnp
    import numpy as np

    from csparse3_jax.ops.gather import ROWG_K, rowgather

    rng = np.random.RandomState(0)
    v = rng.rand(1000).astype(np.float32)
    idx = rng.randint(0, 1000, 5000).astype(np.int32)
    got = np.asarray(rowgather(jnp.asarray(v), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, v[idx])   # exact, not approx

    # explicit pad_to (precomputed multiple of K)
    pad = -(-1000 // ROWG_K) * ROWG_K + ROWG_K
    got2 = np.asarray(rowgather(jnp.asarray(v), jnp.asarray(idx), pad))
    np.testing.assert_array_equal(got2, v[idx])

    # empty index set
    e = np.asarray(rowgather(jnp.asarray(v),
                             jnp.zeros((0,), np.int32)))
    assert e.shape == (0,)

    # int64 indices, f64 values (x64 suite)
    v64 = rng.rand(100)
    i64 = rng.randint(0, 100, 300)
    got3 = np.asarray(rowgather(jnp.asarray(v64), jnp.asarray(i64)))
    np.testing.assert_array_equal(got3, v64[i64])
