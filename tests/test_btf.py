"""Block triangular form: maximum transversal + SCC blocks + block LU.

New capability vs the reference (its graph layer stops at undirected
islands, reference: src/CSparse3/csc_numba.py:744-808); oracle is
scipy.sparse.csgraph (matching + strong components).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
import importlib

btf_mod = importlib.import_module('csparse3_jax.linalg.btf')
from csparse3_jax.linalg.btf import BTFLU, btf, btf_splu, max_transversal


def _random_reducible(n, nb, seed):
    """Random block-upper-triangular matrix scrambled by random perms."""
    rng = np.random.RandomState(seed)
    sizes = rng.multinomial(n - nb, np.ones(nb) / nb) + 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    A = sp.lil_matrix((n, n))
    for b in range(nb):
        lo, hi = bounds[b], bounds[b + 1]
        blk = sp.random(hi - lo, hi - lo, 0.5, random_state=rng)
        A[lo:hi, lo:hi] = blk.toarray() + np.eye(hi - lo) * (2 + rng.rand())
        if hi < n:  # strictly-upper coupling
            A[lo:hi, hi:] = (sp.random(hi - lo, n - hi, 0.15, random_state=rng)).toarray()
    pr = rng.permutation(n)
    pc = rng.permutation(n)
    return sp.csc_matrix(A.tocsr()[pr][:, pc])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_btf_blocks_upper_triangular(seed):
    n = 60
    As = _random_reducible(n, 5, seed)
    a = cst.CSC.from_scipy(As)
    p, q, blocks = btf(a)
    assert sorted(p.tolist()) == list(range(n))
    assert sorted(q.tolist()) == list(range(n))
    B = As.toarray()[np.ix_(p, q)]
    nb = len(blocks) - 1
    bid = np.zeros(n, dtype=int)
    for b in range(nb):
        bid[blocks[b]:blocks[b + 1]] = b
    rr, cc = np.nonzero(B)
    assert (bid[rr] <= bid[cc]).all()
    assert (np.abs(np.diag(B)) > 0).all()


def test_btf_matches_scipy_block_count():
    n = 80
    As = _random_reducible(n, 7, 3)
    a = cst.CSC.from_scipy(As)
    _, _, blocks = btf(a)
    _, _, blocks_sp = btf_mod._btf_scipy(a)
    # block size multiset is a permutation-invariant of the BTF
    assert sorted(np.diff(blocks).tolist()) == sorted(np.diff(blocks_sp).tolist())


def test_max_transversal_full_rank_and_deficient():
    As = _random_reducible(40, 4, 5)
    a = cst.CSC.from_scipy(As)
    match, size = max_transversal(a)
    assert size == 40
    assert sorted(match.tolist()) == list(range(40))
    # structurally singular: an empty column
    Ad = As.tolil()
    Ad[:, 7] = 0
    ad = cst.CSC.from_scipy(Ad.tocsc())
    _, size_d = max_transversal(ad)
    assert size_d == 39


@pytest.mark.parametrize("seed", [0, 4])
def test_btf_splu_solve_matches_scipy(seed):
    n = 70
    As = _random_reducible(n, 6, seed)
    a = cst.CSC.from_scipy(As)
    lu = btf_splu(a)
    assert isinstance(lu, BTFLU)
    assert not lu.is_singular
    b = np.random.RandomState(seed).randn(n)
    x = lu.solve(b)
    ref = spla.spsolve(As, b)
    np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-10)
    # multi-RHS
    B = np.random.RandomState(seed + 1).randn(n, 3)
    X = lu.solve(B)
    np.testing.assert_allclose(X, spla.spsolve(As, B), rtol=1e-8, atol=1e-10)


def test_btf_splu_never_fills_across_blocks():
    n = 90
    As = _random_reducible(n, 9, 7)
    a = cst.CSC.from_scipy(As)
    blu = btf_splu(a)
    mono = cst.linalg.splu(a, ordering="amd")
    assert blu.fill <= mono.lnz + mono.unz
