"""Islands / connected components vs scipy.sparse.csgraph
(reference: find_islands, csc_numba.py:744-808; end-to-end flow
test3_lil_matrix.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

import csparse3_jax as cst


def test_grid5_flow(grid5_lines):
    """The canonical GridCal flow (reference: test3_lil_matrix.py:29-48):
    LIL build from branch list -> CSC subtract -> A = C @ C.T -> islands."""
    n, m = 5, len(grid5_lines)
    f_mat = cst.LilMat(m, n)
    t_mat = cst.LilMat(m, n)
    for k, (f, t, r, x, b) in enumerate(grid5_lines):
        f_mat[k, f - 1] = 1
        t_mat[k, t - 1] = 1
    C = f_mat.to_csc() - t_mat.to_csc()
    A = C * C.t()

    # scipy oracle
    fs = sp.lil_matrix((m, n))
    ts = sp.lil_matrix((m, n))
    for k, (f, t, r, x, b) in enumerate(grid5_lines):
        fs[k, f - 1] = 1
        ts[k, t - 1] = 1
    Cs = (fs.tocsc() - ts.tocsc())
    As = Cs @ Cs.T
    np.testing.assert_allclose(np.asarray(A.todense()), As.toarray(), rtol=1e-13)

    # a fully connected 5-bus grid -> all 7 branches in one island
    isl = A.islands()
    assert len(isl) == 1
    np.testing.assert_array_equal(isl[0], np.arange(m))


@pytest.mark.parametrize("seed,n,density", [(0, 50, 0.02), (1, 100, 0.01),
                                            (2, 200, 0.005), (3, 30, 0.0)])
def test_islands_vs_scipy(seed, n, density):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=density, random_state=rng, format="csc")
    a = a + a.T  # symmetric pattern
    ours = cst.component_labels(cst.CSC.from_scipy(a.tocsc()))
    ncomp, ref = connected_components(a, directed=False)
    assert len(np.unique(ours)) == ncomp
    # same partition (labels may differ by renaming)
    for lab in range(ncomp):
        members = np.flatnonzero(ref == lab)
        assert len(np.unique(ours[members])) == 1


def test_two_islands():
    # two disjoint 3-cycles
    rows = [0, 1, 2, 3, 4, 5]
    cols = [1, 2, 0, 4, 5, 3]
    a = cst.from_triplets(rows, cols, np.ones(6), (6, 6))
    isl = cst.islands(a)
    assert len(isl) == 2
    np.testing.assert_array_equal(isl[0], [0, 1, 2])
    np.testing.assert_array_equal(isl[1], [3, 4, 5])
