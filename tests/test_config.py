"""Config system (the reference's single NATIVE flag, generalized —
SURVEY §5.6): backend switch, index dtype (int64 for >2^31-nnz problems,
mirroring the csr.h:591 overflow guard), scoped updates."""

import jax.numpy as jnp
import numpy as np

import csparse3_jax as cst
from csparse3_jax import config

from conftest import rand_sp


def test_int64_indices():
    old = config.get_config().index_dtype
    try:
        config.update(index_dtype=np.int64)
        a = rand_sp(50, 50, 0.1, seed=1)
        A = cst.CSC.from_scipy(a)
        B = cst.from_triplets(*[np.asarray(x) for x in
                                (a.tocoo().row, a.tocoo().col, a.tocoo().data)],
                              (50, 50))
        assert B.np_arrays()[0].dtype == np.int64
        np.testing.assert_allclose(np.asarray(B.todense()), a.toarray())
        C = cst.add(A, B)
        np.testing.assert_allclose(np.asarray(C.todense()), 2 * a.toarray())
        y = cst.spmv(B, jnp.asarray(np.ones(50)))
        np.testing.assert_allclose(np.asarray(y), a @ np.ones(50), rtol=1e-12)
    finally:
        config.update(index_dtype=old)


def test_backend_switch_numpy_oracle():
    a = rand_sp(40, 40, 0.1, seed=2)
    A = cst.CSC.from_scipy(a)
    x = np.random.RandomState(0).rand(40)
    y_xla = np.asarray(cst.spmv(A, jnp.asarray(x), backend="xla"))
    y_np = np.asarray(cst.spmv(A, jnp.asarray(x), backend="numpy"))
    np.testing.assert_allclose(y_xla, y_np, rtol=1e-12)


def test_update_rejects_unknown():
    import pytest

    with pytest.raises(ValueError, match="unknown config"):
        config.update(not_a_field=1)
