"""Native host extension (native/host_ext.cpp) vs numpy host kernels.

Differential oracle style (SURVEY §4): the numpy implementations in
linalg/lu_host.py and linalg/ordering.py are the reference; the C++
kernels must agree on factors/permutations semantics and solve accuracy.
Skipped wholesale when the library isn't built (make -C native).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
from csparse3_jax.linalg.lu_host import lu_factor_host
from csparse3_jax.linalg.ordering import mindeg
from csparse3_jax.linalg.trisolve import lsolve, usolve

host_ext = pytest.importorskip("csparse3_jax.native.host_ext")

from conftest import rand_sp


def _solve_with(h, b):
    y = lsolve(h.Lp, h.Li, h.Lx, np.asarray(b)[h.perm_r])
    z = usolve(h.Up, h.Ui, h.Ux, y)
    x = np.zeros_like(z)
    x[h.perm_c] = z
    return x


def _spd_case(n, seed, complex_=False):
    a = rand_sp(n, n, density=0.05, seed=seed)
    a = a + a.T + sp.eye(n) * (n * 0.2)
    if complex_:
        b = rand_sp(n, n, density=0.05, seed=seed + 1)
        a = (a + 1j * (b - b.T)).tocsc()
    return a.tocsc()


@pytest.mark.parametrize("n,seed,cx", [(40, 0, False), (80, 1, True), (120, 2, False)])
def test_lu_matches_scipy(n, seed, cx):
    a = _spd_case(n, seed, cx)
    A = cst.CSC.from_scipy(a)
    ip, ix, dt = A.np_arrays()
    q = mindeg(A)
    h = host_ext.lu_factor(n, ip, ix, dt, q, 1.0)
    rng = np.random.RandomState(seed)
    b = rng.rand(n) + (1j * rng.rand(n) if cx else 0)
    x = _solve_with(h, b)
    xref = spla.spsolve(a, b)
    np.testing.assert_allclose(x, xref, rtol=1e-9, atol=1e-11)


def test_lu_matches_python_host():
    a = _spd_case(60, 3)
    A = cst.CSC.from_scipy(a)
    ip, ix, dt = A.np_arrays()
    q = mindeg(A)
    hc = host_ext.lu_factor(60, ip, ix, dt, q, 1.0)
    hp = lu_factor_host(60, ip, ix, dt, q, 1.0)
    # identical pivot sequence and factor patterns (same algorithm)
    np.testing.assert_array_equal(hc.perm_r, hp.perm_r)
    np.testing.assert_array_equal(hc.Lp, hp.Lp)
    np.testing.assert_array_equal(hc.Li, hp.Li)
    np.testing.assert_array_equal(hc.Up, hp.Up)
    np.testing.assert_array_equal(hc.Ui, hp.Ui)
    np.testing.assert_allclose(hc.Lx, hp.Lx, rtol=1e-14)
    np.testing.assert_allclose(hc.Ux, hp.Ux, rtol=1e-14)


def test_singular_detection_matches():
    # rank-2: third column is a copy of the first two's span
    rows = [0, 1, 2, 0, 1, 2, 0, 1, 2]
    cols = [0, 0, 0, 1, 1, 1, 2, 2, 2]
    vals = [1.0, 2, 3, 1, 2, 3, 4, 5, 7]
    a = cst.from_triplets(rows, cols, vals, (3, 3))
    ip, ix, dt = a.np_arrays()
    h = host_ext.lu_factor(3, ip, ix, dt, np.arange(3), 1.0)
    assert list(h.singular_cols) == [1]


def test_amd_is_permutation_and_reduces_fill():
    a = _spd_case(200, 4)
    A = cst.CSC.from_scipy(a)
    ip, ix, dt = A.np_arrays()
    q = host_ext.amd(200, ip, ix)
    assert sorted(q.tolist()) == list(range(200))
    h_amd = host_ext.lu_factor(200, ip, ix, dt, q, 1.0)
    h_nat = host_ext.lu_factor(200, ip, ix, dt, np.arange(200), 1.0)
    fill_amd = len(h_amd.Lx) + len(h_amd.Ux)
    fill_nat = len(h_nat.Lx) + len(h_nat.Ux)
    assert fill_amd < fill_nat


def test_amd_quality_close_to_python_mindeg():
    from csparse3_jax.models.grids import synthetic_grid, ybus

    g = synthetic_grid(800, seed=5)
    Y, _, _ = ybus(g)
    A = cst.CSC.from_scipy((Y.to_scipy() + sp.eye(800) * (0.3 + 0.3j)).tocsc())
    ip, ix, dt = A.np_arrays()
    q_c = host_ext.amd(800, ip, ix)
    q_p = mindeg(A)
    fill_c = sum(
        len(getattr(host_ext.lu_factor(800, ip, ix, dt, q, 1.0), f))
        for q, f in [(q_c, "Lx"), (q_c, "Ux")]
    )
    fill_p = sum(
        len(getattr(host_ext.lu_factor(800, ip, ix, dt, q, 1.0), f))
        for q, f in [(q_p, "Lx"), (q_p, "Ux")]
    )
    assert fill_c <= fill_p * 1.25  # approximate degree within 25% of exact


def test_coo_to_csc_native():
    rng = np.random.RandomState(6)
    k = 5000
    rows = rng.randint(0, 300, k)
    cols = rng.randint(0, 300, k)
    vals = rng.rand(k)
    p, i, x = host_ext.coo_to_csc(300, 300, rows, cols, vals)
    ref = sp.csc_matrix((vals, (rows, cols)), shape=(300, 300))
    ref.sum_duplicates()
    np.testing.assert_array_equal(p, ref.indptr)
    np.testing.assert_array_equal(i, ref.indices)
    np.testing.assert_allclose(x, ref.data, rtol=1e-14)


def test_splu_uses_native():
    """splu must route through the native kernel when built."""
    a = _spd_case(50, 7)
    A = cst.CSC.from_scipy(a)
    lu = cst.linalg.splu(A, ordering="amd")
    b = np.random.RandomState(8).rand(50)
    x = np.asarray(lu.solve(b))
    np.testing.assert_allclose(a @ x, b, rtol=1e-9, atol=1e-10)


def test_rcm_native_matches_python_bandwidth():
    """Native RCM must be a permutation with bandwidth no worse than the
    Python oracle's (tie-breaking may differ)."""
    import scipy.sparse as sp

    from csparse3_jax.linalg.ordering import _rcm_py, rcm

    rng = np.random.RandomState(5)
    n = 400
    a_sp = sp.random(n, n, 0.01, random_state=rng) + sp.eye(n)
    a_sp = (a_sp + a_sp.T).tocsc()
    a = cst.CSC.from_scipy(a_sp)
    p_nat = rcm(a)
    p_py = _rcm_py(a)
    assert sorted(p_nat.tolist()) == list(range(n))

    rows, cols = a_sp.tocoo().row, a_sp.tocoo().col

    def bw(p):
        inv = np.empty(n, dtype=np.int64)
        inv[p] = np.arange(n)
        return int(np.abs(inv[rows] - inv[cols]).max())

    assert bw(p_nat) <= int(1.3 * bw(p_py)) + 5


def test_nd_is_permutation_and_fill_competitive():
    """Nested dissection must be a valid elimination order whose fill on a
    lattice grid is within 2x of AMD's (it wins at larger scale)."""
    from csparse3_jax.linalg import splu
    from csparse3_jax.models.grids import synthetic_grid

    n = 3000
    g = synthetic_grid(n, seed=1)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = cst.from_triplets(rows, cols, vals, (n, n))
    Breg = cst.add(B, cst.diags(np.full(n, 3.0)))
    from csparse3_jax.linalg.ordering import nd

    p = nd(Breg)
    assert sorted(p.tolist()) == list(range(n))
    lu_nd = splu(Breg, ordering="nd")
    lu_amd = splu(Breg, ordering="amd")
    assert lu_nd.lnz + lu_nd.unz <= 2 * (lu_amd.lnz + lu_amd.unz)
    b = np.random.RandomState(0).rand(n)
    np.testing.assert_allclose(
        lu_nd.solve_host(b), lu_amd.solve_host(b), rtol=1e-8, atol=1e-10
    )


def test_hostmem_allocator_installed():
    """The NEP-49 populate allocator is active after package import (when
    the extension is built) and large buffers behave correctly."""
    try:
        from csparse3_jax.native import _npalloc  # noqa: F401
    except ImportError:
        return  # extension not built; mallopt-only mode
    # numpy>=2 moved multiarray under _core; no public home for this yet
    from numpy._core.multiarray import get_handler_name

    name = get_handler_name()
    assert name == "populate_mmap_allocator"
    z = np.zeros(2_000_000, dtype=np.float64)
    assert not z.any()
    r = np.arange(2_000_000, dtype=np.int64)
    big = r + 1
    assert big[-1] == 2_000_000
    # realloc path
    r.resize(4_000_000, refcheck=False)
    assert r[1_999_999] == 1_999_999 and r[-1] == 0


def test_lu_exact_cancellation_keeps_pruning_sound():
    """Integer-valued matrices produce exact zeros during elimination;
    symmetric pruning is only sound if those entries stay in L's pattern
    (regression: cancelled entries were dropped, corrupting later
    columns' reach)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from csparse3_jax.linalg import splu

    for seed in range(8):
        rng = np.random.RandomState(seed)
        n = 120
        a = sp.random(n, n, 0.06, random_state=rng, data_rvs=lambda k:
                      rng.randint(-2, 3, k).astype(float))
        a = (a + sp.eye(n) * 4.0).tocsc()
        A = cst.CSC.from_scipy(a)
        lu = splu(A, ordering="amd")
        assert not lu.is_singular
        b = rng.randn(n)
        x = lu.solve_host(b)
        ref = spla.spsolve(a, b)
        np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-11,
                                   err_msg=f"seed {seed}")


# ---------------------------------------------------------------------------
# build from source on first use (csparse3_jax/native/__init__.py)
# ---------------------------------------------------------------------------

def _native_tree(tmp_path):
    import os
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = tmp_path / "native"
    shutil.copytree(os.path.join(root, "native"), src)
    out = tmp_path / "out"
    out.mkdir()
    return str(src), str(out)


def test_ensure_built_rebuilds_only_when_stale(tmp_path):
    import os

    from csparse3_jax.native import ensure_built

    src, out = _native_tree(tmp_path)
    path = ensure_built("_npalloc.so", src_dir=src, out_dir=out)
    t_built = os.path.getmtime(path)
    assert ensure_built("_npalloc.so", src_dir=src, out_dir=out) == path
    assert os.path.getmtime(path) == t_built            # fresh: no rebuild
    future = t_built + 10
    os.utime(os.path.join(src, "npalloc.c"), (future, future))
    ensure_built("_npalloc.so", src_dir=src, out_dir=out)
    assert os.path.getmtime(path) > t_built             # stale: rebuilt
    assert sorted(os.listdir(out)) == [".build.lock", "_npalloc.so"]


def _build_worker(args):
    from csparse3_jax.native import ensure_built

    return ensure_built("_npalloc.so", src_dir=args[0], out_dir=args[1])


def test_ensure_built_concurrent_processes(tmp_path):
    """More builders than cores race on one fresh tree: the lock lets one
    build, the others wait and reuse it, and no temporary file is left."""
    import multiprocessing
    import os

    src, out = _native_tree(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    n = (os.cpu_count() or 4) + 2
    with ctx.Pool(n) as pool:
        paths = pool.map_async(_build_worker, [(src, out)] * n).get(
            timeout=600)
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    assert sorted(os.listdir(out)) == [".build.lock", "_npalloc.so"]
