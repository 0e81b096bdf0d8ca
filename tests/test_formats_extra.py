"""DIA format, scaling, sampling, validation — parity additions
(reference: dia.h, csr.h scale/sample/has_* kernels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import csparse3_jax as cst

from conftest import rand_sp


class TestDIA:
    def test_roundtrip_scipy(self):
        a = sp.diags(
            [np.arange(1.0, 9), 2 * np.ones(9), -np.ones(7)], [-1, 0, 2]
        ).tocsc()
        A = cst.CSC.from_scipy(a)
        D = cst.csc_to_dia(A)
        np.testing.assert_allclose(D.to_scipy().toarray(), a.toarray())
        back = cst.dia_to_csc(D)
        np.testing.assert_allclose(np.asarray(back.todense()), a.toarray())

    def test_dia_spmv_matches(self):
        a = sp.diags(
            [np.random.RandomState(0).rand(40 - abs(o)) for o in (-3, -1, 0, 2, 5)],
            [-3, -1, 0, 2, 5],
        ).tocsc()
        D = cst.csc_to_dia(cst.CSC.from_scipy(a))
        x = np.random.RandomState(1).rand(40)
        y = cst.dia_spmv(D, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12, atol=1e-13)

    def test_dia_from_scipy_rect(self):
        a = sp.random(20, 30, 0.1, random_state=2).todia()
        D = cst.DIA.from_scipy(a)
        x = np.random.RandomState(3).rand(30)
        np.testing.assert_allclose(
            np.asarray(cst.dia_spmv(D, jnp.asarray(x))), a @ x,
            rtol=1e-12, atol=1e-13,
        )


class TestScaling:
    def test_scale_rows_cols(self, rand_pair):
        a, _ = rand_pair
        A = cst.CSC.from_scipy(a)
        dr = np.random.RandomState(4).rand(a.shape[0])
        dc = np.random.RandomState(5).rand(a.shape[1])
        R = cst.scale_rows(A, jnp.asarray(dr))
        C = cst.scale_columns(A, jnp.asarray(dc))
        np.testing.assert_allclose(
            np.asarray(R.todense()), (sp.diags(dr) @ a).toarray(), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(C.todense()), (a @ sp.diags(dc)).toarray(), rtol=1e-12
        )


class TestSampling:
    def test_sample_values(self, golden63):
        A = cst.CSC.from_scipy(golden63)
        ri = np.array([0, 1, 5, 2, 3])
        ci = np.array([0, 1, 1, 2, 0])
        out = cst.sample_values(A, ri, ci)
        ref = np.array([golden63[r, c] for r, c in zip(ri, ci)])
        np.testing.assert_allclose(out, ref)

    def test_sample_absent_is_zero(self, golden63):
        A = cst.CSC.from_scipy(golden63)
        assert cst.sample_values(A, [0], [1])[0] == 0


class TestValidate:
    def test_good_matrix_passes(self, golden63):
        A = cst.CSC.from_scipy(golden63)
        cst.validate(A, check_sorted=True)
        assert cst.has_sorted_indices(A)
        assert cst.has_canonical_format(A)

    def test_bad_indptr_raises(self):
        A = cst.CSC(3, 3, np.array([0, 2, 1, 3]), np.array([0, 1, 2]),
                    np.ones(3))
        with pytest.raises(ValueError, match="monotone"):
            cst.validate(A)

    def test_out_of_bounds_raises(self):
        A = cst.CSC(3, 3, np.array([0, 1, 2, 3]), np.array([0, 5, 2]),
                    np.ones(3))
        with pytest.raises(ValueError, match="bounds"):
            cst.validate(A)

    def test_unsorted_detected(self):
        A = cst.CSC(3, 3, np.array([0, 3, 3, 3]), np.array([2, 0, 1]),
                    np.ones(3), canonical=False)
        assert not cst.has_sorted_indices(A)
        assert not cst.has_canonical_format(A)
        with pytest.raises(ValueError, match="canonical"):
            cst.validate(A, check_sorted=True)

    def test_duplicates_not_canonical(self):
        A = cst.CSC(3, 3, np.array([0, 2, 2, 2]), np.array([1, 1, ]),
                    np.ones(2), canonical=False)
        assert cst.has_sorted_indices(A)
        assert not cst.has_canonical_format(A)


def test_csr_operators_and_transpose():
    """CSR operator surface delegates to the CSC layer; transpose is
    zero-copy (reference: csr.h:418 csr_tocsc doubles as transpose)."""
    import scipy.sparse as sp

    a = sp.random(30, 20, density=0.2, format="csr",
                  random_state=np.random.RandomState(5))
    b = sp.random(30, 20, density=0.2, format="csr",
                  random_state=np.random.RandomState(6))
    R, B = cst.CSR.from_scipy(a), cst.CSR.from_scipy(b)
    x = np.ones(20)
    np.testing.assert_allclose(np.asarray(R @ x), a @ x, rtol=1e-12)
    np.testing.assert_allclose(np.asarray((R + B).todense()),
                               (a + b).toarray(), rtol=1e-12)
    np.testing.assert_allclose(np.asarray((R - B).todense()),
                               (a - b).toarray(), rtol=1e-12)
    np.testing.assert_allclose(np.asarray((3.0 * R).todense()),
                               3 * a.toarray(), rtol=1e-12)
    assert isinstance(R + B, cst.CSR)
    t = R.T
    assert isinstance(t, cst.CSC)
    np.testing.assert_allclose(np.asarray(t.todense()), a.T.toarray())


def test_coo_from_scipy():
    import scipy.sparse as sp

    a = sp.random(12, 9, density=0.3, random_state=np.random.RandomState(7))
    c = cst.COO.from_scipy(a)
    np.testing.assert_allclose(np.asarray(c.to_csc().todense()), a.toarray())


def test_bsr_surface_vs_scipy():
    """BSR transpose/binops/products round-trip through the CSC layer
    (reference kernels: bsr.h transpose :212, binops :349-694, tobsr
    csr.h:204)."""
    import scipy.sparse as sp

    rng = np.random.RandomState(0)
    a = sp.random(24, 16, density=0.3, random_state=rng).tobsr(
        blocksize=(4, 4))
    b = sp.random(24, 16, density=0.3, random_state=rng).tobsr(
        blocksize=(4, 4))
    A, B = cst.BSR.from_scipy(a), cst.BSR.from_scipy(b)
    np.testing.assert_allclose(np.asarray(A.to_csc().todense()),
                               a.toarray())
    t = A.t()
    assert isinstance(t, cst.BSR)
    np.testing.assert_allclose(np.asarray(t.todense()), a.T.toarray())
    s = A + B
    assert isinstance(s, cst.BSR)
    np.testing.assert_allclose(np.asarray(s.todense()), (a + b).toarray(),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray((A - B).todense()),
                               (a - b).toarray(), rtol=1e-12)
    np.testing.assert_allclose(np.asarray((-A).todense()), -a.toarray())
    c = sp.random(16, 20, density=0.3, random_state=rng).tobsr(
        blocksize=(4, 4))
    C = cst.BSR.from_scipy(c)
    p = A @ C
    assert isinstance(p, cst.BSR)
    np.testing.assert_allclose(np.asarray(p.todense()), (a @ c).toarray(),
                               rtol=1e-10)
    x = np.ones((16, 3))
    # dense product runs on device (matmul precision at the session dtype)
    np.testing.assert_allclose(np.asarray(A @ x)[:24], a @ x,
                               rtol=0, atol=1e-4 * np.abs(a.data).sum())
    np.testing.assert_allclose(A.to_scipy().toarray(), a.toarray())


# ---------------------------------------------------------------------------
# jax.experimental.sparse BCOO interop
# ---------------------------------------------------------------------------

def test_bcoo_roundtrip():
    import scipy.sparse as sp
    from csparse3_jax import CSC

    rng = np.random.RandomState(3)
    s = sp.random(40, 23, density=0.1, random_state=rng, format="csc")
    a = CSC.from_scipy(s)
    b = a.to_bcoo()
    assert b.shape == (40, 23)
    np.testing.assert_allclose(np.asarray(b.todense()), s.toarray())
    back = CSC.from_bcoo(b)
    assert (back.to_scipy() != s).nnz == 0


def test_bcoo_matvec_agrees():
    import scipy.sparse as sp
    from csparse3_jax import CSC

    rng = np.random.RandomState(4)
    s = sp.random(30, 30, density=0.15, random_state=rng, format="csc")
    a = CSC.from_scipy(s)
    x = rng.randn(30)
    y = a.to_bcoo() @ jnp.asarray(x)
    np.testing.assert_allclose(np.asarray(y), s @ x, atol=1e-10)


def test_bcoo_rejects_batched():
    import jax.experimental.sparse as jsparse
    import pytest
    from csparse3_jax import CSC

    dense = jnp.zeros((2, 3, 3)).at[:, 0, 0].set(1.0)
    b = jsparse.BCOO.fromdense(dense, n_batch=1)
    with pytest.raises(ValueError):
        CSC.from_bcoo(b)
