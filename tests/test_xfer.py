"""Transfer-safe complex marshaling (utils.xfer) + the plan-state
host-residency invariant it depends on."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
from csparse3_jax.linalg import splu
from csparse3_jax.utils import split, splitc, unsplit


def _rand_csc(n, dens, seed, complex_=False):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, dens, random_state=rng, format="csc")
    if complex_:
        a = a + 1j * sp.random(n, n, dens, random_state=rng, format="csc")
    return (a + sp.eye(n) * (4.0 + (1.0j if complex_ else 0.0))).tocsc()


def test_split_unsplit_roundtrip():
    rng = np.random.RandomState(0)
    z = (rng.randn(7, 3) + 1j * rng.randn(7, 3)).astype(np.complex64)
    f = rng.randn(5).astype(np.float32)
    tree = {"z": z, "f": f}
    s = split(tree)
    assert s["z"].dtype == np.float32 and s["z"].shape == (7, 3, 2)
    assert s["f"] is f
    r = unsplit(s)
    np.testing.assert_array_equal(r["z"], z)
    np.testing.assert_array_equal(r["f"], f)


def test_splitc_wrapped_jit_complex_solve():
    """jax.jit(splitc(plan)) must match the host oracle with only float
    arrays crossing the boundary."""
    a = _rand_csc(300, 0.02, 1, complex_=True)
    A = cst.CSC.from_scipy(a)
    lu = splu(A, ordering="amd")
    plan = lu.solve_plan()
    rng = np.random.RandomState(2)
    b = (rng.randn(300) + 1j * rng.randn(300)).astype(np.complex128)

    solve = jax.jit(splitc(plan))
    sb = split(b)
    assert sb.dtype == np.float64 and sb.shape == (300, 2)
    x = unsplit(solve(sb))
    assert x.dtype == np.complex128
    ref = spla.spsolve(a, b)
    np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-10)


def test_plan_state_stays_on_host():
    """Plans must hold host numpy state so closure-jit embeds constants
    without host->device transfers."""
    a = _rand_csc(300, 0.02, 3, complex_=True)
    lu = splu(cst.CSC.from_scipy(a), ordering="amd")
    plan = lu.solve_plan()
    leaves = jax.tree_util.tree_leaves(plan)
    assert leaves, "plan should flatten to leaves"
    for leaf in leaves:
        assert isinstance(leaf, np.ndarray), type(leaf)


def test_splitc_real_passthrough():
    a = _rand_csc(200, 0.03, 4, complex_=False)
    lu = splu(cst.CSC.from_scipy(a), ordering="amd")
    plan = lu.solve_plan()
    b = np.random.RandomState(5).randn(200)
    x = unsplit(jax.jit(splitc(plan))(split(b)))
    np.testing.assert_allclose(
        x, spla.spsolve(a, b), rtol=1e-8, atol=1e-10)
