"""Randomized differential stress test: random op chains vs scipy.

Property-based coverage in the SURVEY §4 spirit (scipy is the oracle the
reference itself tests against): each trial builds random operands and
applies a random sequence of structural + arithmetic ops, mirroring every
step in scipy and comparing dense forms.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import csparse3_jax as cst


def _rand(rng, m, n, density):
    a = sp.random(m, n, density=density,
                  random_state=np.random.RandomState(rng.integers(2**31)))
    a = a.tocsc()
    a.sum_duplicates()
    return a


def _check(ours, ref, rtol=1e-10):
    d = np.asarray(ours.todense())
    np.testing.assert_allclose(d, ref.toarray(), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("seed", range(8))
def test_random_op_chain(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(5, 60))
    n = int(rng.integers(5, 60))
    a_sp = _rand(rng, m, n, 0.15)
    b_sp = _rand(rng, m, n, 0.15)
    A, B = cst.CSC.from_scipy(a_sp), cst.CSC.from_scipy(b_sp)

    for _ in range(12):
        op = rng.choice(["add", "sub", "scale", "neg", "transpose",
                         "gram", "spgemm", "elmul", "slice", "stack",
                         "maximum", "eliminate_zeros", "csr_roundtrip"])
        if op == "add":
            A, a_sp = A + B, (a_sp + b_sp).tocsc()
        elif op == "sub":
            A, a_sp = A - B, (a_sp - b_sp).tocsc()
        elif op == "scale":
            s = float(rng.normal())
            A, a_sp = s * A, (s * a_sp).tocsc()
        elif op == "neg":
            A, a_sp = -A, (-a_sp).tocsc()
        elif op == "transpose":
            A, a_sp = A.t(), a_sp.T.tocsc()
            B, b_sp = B.t(), b_sp.T.tocsc()
        elif op == "gram":
            A, a_sp = cst.gram(A), (a_sp @ a_sp.T).tocsc()
            B, b_sp = cst.gram(B), (b_sp @ b_sp.T).tocsc()
        elif op == "spgemm":
            A, a_sp = cst.spgemm(A, B.t()), (a_sp @ b_sp.T).tocsc()
            B, b_sp = A.copy(), a_sp.copy()
        elif op == "elmul":
            A, a_sp = cst.elmul(A, B), a_sp.multiply(b_sp).tocsc()
        elif op == "maximum":
            A, a_sp = cst.maximum(A, B), a_sp.maximum(b_sp).tocsc()
        elif op == "eliminate_zeros":
            A = cst.eliminate_zeros(A)
            a_sp = a_sp.copy()
            a_sp.eliminate_zeros()
        elif op == "csr_roundtrip":
            A, a_sp = A.to_csr().to_csc(), a_sp.tocsr().tocsc()
        elif op == "slice":
            mm, nn = a_sp.shape
            r0 = int(rng.integers(0, mm))
            r1 = int(rng.integers(r0 + 1, mm + 1))
            c0 = int(rng.integers(0, nn))
            c1 = int(rng.integers(c0 + 1, nn + 1))
            A, a_sp = A[r0:r1, c0:c1], a_sp[r0:r1, c0:c1].tocsc()
            B, b_sp = B[r0:r1, c0:c1], b_sp[r0:r1, c0:c1].tocsc()
        elif op == "stack":
            A = cst.hstack([A, A])
            a_sp = sp.hstack([a_sp, a_sp]).tocsc()
            B = cst.hstack([B, B])
            b_sp = sp.hstack([b_sp, b_sp]).tocsc()
        # keep shapes aligned for binary ops
        if A.shape != B.shape:
            B, b_sp = A.copy(), a_sp.copy()
        # bound growth
        if A.shape[0] * A.shape[1] > 80_000 or A.nnz > 150_000:
            A, a_sp = cst.CSC.from_scipy(_rand(rng, 30, 30, 0.2)), None
            a_sp = A.to_scipy().tocsc()
            B, b_sp = A.copy(), a_sp.copy()
        _check(A, a_sp)
        assert A.shape == a_sp.shape


@pytest.mark.parametrize("seed", range(4))
def test_random_solve_chain(seed):
    """Random SPD-ish systems through every factor family vs spsolve."""
    import scipy.sparse.linalg as spla

    from csparse3_jax import linalg

    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(30, 200))
    a_sp = _rand(rng, n, n, 0.05)
    a_sp = (a_sp + a_sp.T + sp.diags(np.full(n, 5.0))).tocsc()
    A = cst.CSC.from_scipy(a_sp)
    b = np.asarray(rng.normal(size=n))
    xr = spla.spsolve(a_sp, b)
    for factor in (lambda: linalg.splu(A),
                   lambda: linalg.splu(A, ordering="rcm", tol=0.0),
                   lambda: linalg.ldlt(A),
                   lambda: linalg.btf_splu(A)):
        f = factor()
        xh = f.solve_host(b) if hasattr(f, "solve_host") else f.solve(b)
        np.testing.assert_allclose(np.asarray(xh), xr, rtol=1e-7, atol=1e-9)
