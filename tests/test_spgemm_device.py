"""On-chip ESC SpGEMM (ops/spgemm_device.py) vs scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import csparse3_jax as cst
from csparse3_jax.ops.spgemm_device import ESCSpGEMM, gram_device, spgemm_device


def _finalize(m, n, ip, r, d, nz):
    nz = int(nz)
    return cst.CSC(m, n, np.asarray(ip), np.asarray(r[:nz]),
                   np.asarray(d[:nz])).to_scipy().copy()


@pytest.mark.parametrize("m,k,n,d", [
    (50, 40, 30, 0.1), (200, 200, 200, 0.02), (1, 1, 1, 1.0),
    (10, 10, 10, 0.0), (7, 300, 5, 0.2),
])
def test_matches_scipy(m, k, n, d):
    rng = np.random.RandomState(hash((m, k, n)) % 2**31)
    A = sp.random(m, k, density=d, format="csc", random_state=rng)
    B = sp.random(k, n, density=d, format="csc", random_state=rng)
    C = spgemm_device(cst.CSC.from_scipy(A), cst.CSC.from_scipy(B))
    ref = (A @ B).tocsc()
    ref.sort_indices()
    err = abs(C.to_scipy().copy() - ref).max() if (ref.nnz or C.nnz) else 0.0
    assert err < 1e-10  # x64 on in tests


def test_gram_matches_scipy():
    rng = np.random.RandomState(7)
    A = sp.random(300, 200, density=0.03, format="csc", random_state=rng)
    G = gram_device(cst.CSC.from_scipy(A))
    ref = (A @ A.T).tocsc()
    assert abs(G.to_scipy().copy() - ref).max() < 1e-10


def test_two_key_sort_path():
    rng = np.random.RandomState(8)
    A = sp.random(300, 200, density=0.03, format="csc", random_state=rng)
    Ac = cst.CSC.from_scipy(A)
    Bc = cst.CSC.from_scipy(A.T.tocsc())
    plan = ESCSpGEMM(Ac, Bc)
    plan.fused = False  # force the lexicographic two-key path
    out = jax.jit(plan.__call__)(Ac.data, Bc.data)
    got = _finalize(300, 300, *out)
    ref = (A @ A.T).tocsc()
    assert abs(got - ref).max() < 1e-10


def test_capacity_padding():
    rng = np.random.RandomState(9)
    A = sp.random(120, 80, density=0.05, format="csc", random_state=rng)
    Ac = cst.CSC.from_scipy(A)
    Bc = cst.CSC.from_scipy(A.T.tocsc())
    base = ESCSpGEMM(Ac, Bc)
    plan = ESCSpGEMM(Ac, Bc, capacity=base.total + 137)
    out = jax.jit(plan.__call__)(Ac.data, Bc.data)
    got = _finalize(120, 120, *out)
    ref = (A @ A.T).tocsc()
    assert abs(got - ref).max() < 1e-10


def test_capacity_guard():
    rng = np.random.RandomState(10)
    A = sp.random(50, 50, density=0.1, format="csc", random_state=rng)
    Ac = cst.CSC.from_scipy(A)
    base = ESCSpGEMM(Ac, Ac)
    with pytest.raises(ValueError, match="capacity"):
        ESCSpGEMM(Ac, Ac, capacity=base.total - 1)


def test_dim_guard():
    A = cst.from_triplets([0], [0], [1.0], (3, 4))
    B = cst.from_triplets([0], [0], [1.0], (3, 4))
    with pytest.raises(ValueError, match="dim mismatch"):
        spgemm_device(A, B)


def test_inside_scan_new_values():
    """The plan reuses across value changes inside jit (fixed capacity)."""
    rng = np.random.RandomState(11)
    A = sp.random(60, 60, density=0.08, format="csc", random_state=rng)
    Ac = cst.CSC.from_scipy(A)
    plan = ESCSpGEMM(Ac, Ac)

    @jax.jit
    def twice(d):
        _, _, d1, _ = plan(d, d)
        ip, r, d2, nz = plan(2.0 * d, d)
        return ip, r, d2, nz

    out = twice(Ac.data)
    got = _finalize(60, 60, *out)
    ref = (2.0 * A @ A).tocsc()
    assert abs(got - ref).max() < 1e-10


class TestGramPlan:
    """Symmetry-folded device gram (ops/spgemm.py::GramPlan, r5):
    lower-triangle products + host-composed mirror select."""

    def _check(self, n, dens, seed):
        import scipy.sparse as sp

        from csparse3_jax.ops.spgemm import gram_symbolic

        a = sp.random(n, n, density=dens, format="csc",
                      random_state=np.random.RandomState(seed))
        A = cst.CSC.from_scipy(a)
        plan = gram_symbolic(A)
        C = plan.numeric(jnp.asarray(np.asarray(A.np_arrays()[2])))
        got = C.to_scipy().copy()
        ref = (a @ a.T).tocsc()
        assert abs(got - ref).max() < 1e-6

    def test_matches_scipy(self):
        self._check(300, 0.02, 0)
        self._check(1000, 0.005, 1)
        self._check(50, 0.2, 2)

    def test_jit_and_reuse(self):
        import scipy.sparse as sp

        from csparse3_jax.ops.spgemm import gram_symbolic

        a = sp.random(400, 400, density=0.01, format="csc",
                      random_state=np.random.RandomState(3))
        A = cst.CSC.from_scipy(a)
        plan = gram_symbolic(A)
        d0 = jnp.asarray(np.asarray(A.np_arrays()[2]))
        f = jax.jit(lambda d: plan.numeric(d).data)
        x1 = np.asarray(f(d0))
        # new values, same pattern
        x2 = np.asarray(f(d0 * 2.0))
        np.testing.assert_allclose(x2, 4.0 * x1, rtol=1e-6)

    def test_empty(self):
        import scipy.sparse as sp

        from csparse3_jax.ops.spgemm import gram_symbolic

        E = cst.CSC.from_scipy(sp.csc_matrix((5, 5)))
        plan = gram_symbolic(E)
        assert plan.out_nnz == 0
