"""Persistence + profiling utilities."""

import numpy as np
import scipy.sparse as sp

import csparse3_jax as cst
from csparse3_jax.utils import io as cio
from csparse3_jax.utils.profiling import Timer, compare_with_scipy, timeit

from conftest import rand_sp


def test_npz_roundtrip_csc(tmp_path):
    a = rand_sp(40, 30, 0.1, seed=1)
    A = cst.CSC.from_scipy(a)
    p = tmp_path / "a.npz"
    cio.save_npz(p, A)
    B = cio.load_npz(p)
    np.testing.assert_allclose(np.asarray(B.todense()), a.toarray())


def test_npz_scipy_interop(tmp_path):
    # scipy reads ours
    a = rand_sp(25, 25, 0.2, seed=2)
    A = cst.CSC.from_scipy(a)
    p = tmp_path / "ours.npz"
    cio.save_npz(p, A)
    s = sp.load_npz(p)
    np.testing.assert_allclose(s.toarray(), a.toarray())
    # we read scipy's
    p2 = tmp_path / "theirs.npz"
    sp.save_npz(p2, a.tocsr())
    B = cio.load_npz(p2)
    np.testing.assert_allclose(np.asarray(B.todense()), a.toarray())


def test_lu_roundtrip(tmp_path):
    a = rand_sp(30, 30, 0.15, seed=3) + sp.eye(30) * 5
    A = cst.CSC.from_scipy(a.tocsc())
    lu = cst.linalg.splu(A)
    p = tmp_path / "lu.npz"
    cio.save_lu(p, lu)
    lu2 = cio.load_lu(p)
    b = np.random.RandomState(4).rand(30)
    np.testing.assert_allclose(
        np.asarray(lu.solve(b)), np.asarray(lu2.solve(b)), rtol=1e-14
    )


def test_timer_and_compare():
    t = Timer()
    with t.section("x"):
        pass
    assert "x" in t.summary()
    a = cst.CSC.from_scipy(rand_sp(200, 200, 0.05, seed=5))
    r = compare_with_scipy(a, "spmv", iters=2)
    assert r["ours_s"] > 0 and r["scipy_s"] > 0
    r2 = compare_with_scipy(a, "spgemm")
    assert r2["ours_s"] > 0


def test_timeit_sync():
    import jax.numpy as jnp

    x = jnp.ones(16)
    assert timeit(lambda v: v + 1, x, iters=2, warmup=1) >= 0


def test_banded_roundtrip(tmp_path):
    import csparse3_jax as cst
    from csparse3_jax.linalg import BandedLU
    from csparse3_jax.models.grids import synthetic_grid
    from csparse3_jax.utils.io import load_banded, save_banded

    n = 1000
    g = synthetic_grid(n, seed=3)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    a = cst.add(cst.from_triplets(rows, cols, vals, (n, n)),
                cst.diags(np.full(n, 3.0)))
    plan = BandedLU(a)
    p = tmp_path / "banded.npz"
    save_banded(p, plan)
    plan2 = load_banded(p)
    assert (plan2.n, plan2.s, plan2.bw) == (plan.n, plan.s, plan.bw)
    b = np.random.RandomState(0).rand(n)
    np.testing.assert_array_equal(plan.solve_host(b), plan2.solve_host(b))
    # device path works off the reloaded stacks too
    x = np.asarray(plan2(b))
    ref = plan.solve_host(b.astype(np.float64))
    assert np.abs(x - ref).max() / np.abs(ref).max() < 5e-4


# ---------------------------------------------------------------------------
# trace reduction (utils/roofline.py) on a small recorded trace
# ---------------------------------------------------------------------------

# the shape of a GPU profile's Chrome trace: one host process, one device
# process whose XLA-op and stream lines overlap in time
_TRACE = {"traceEvents": [
    {"ph": "M", "pid": 1, "name": "process_name",
     "args": {"name": "/host:CPU"}},
    {"ph": "M", "pid": 7, "name": "process_name",
     "args": {"name": "/device:GPU:0"}},
    {"ph": "M", "pid": 8, "name": "process_name",
     "args": {"name": "/device:GPU:1"}},
    {"ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0,
     "name": "PjitFunction"},
    {"ph": "X", "pid": 7, "tid": 2, "ts": 10.0, "dur": 5.0,
     "name": "fusion"},
    {"ph": "X", "pid": 7, "tid": 3, "ts": 12.0, "dur": 5.0,
     "name": "fusion.1"},
    {"ph": "X", "pid": 7, "tid": 2, "ts": 30.0, "dur": 2.0,
     "name": "gather"},
    {"ph": "X", "pid": 8, "tid": 2, "ts": 40.0, "dur": 4.0,
     "name": "fusion"},
]}


def test_device_pids_selects_gpu_tracks():
    from csparse3_jax.utils.roofline import device_pids

    assert device_pids(_TRACE) == {7, 8}
    host_only = {"traceEvents": [{"ph": "M", "pid": 3, "name": "process_name",
                                 "args": {"name": "/host:CPU"}}]}
    assert device_pids(host_only) == set()


def test_device_busy_is_union_of_intervals():
    from csparse3_jax.utils.roofline import device_busy_s

    ev = _TRACE["traceEvents"]
    # [10, 17) + [30, 32) on GPU 0: overlapping lines count once
    assert abs(device_busy_s(ev, {7}) - 9e-6) < 1e-12
    assert abs(device_busy_s(ev, {7, 8}) - 13e-6) < 1e-12
    assert device_busy_s(ev, set()) == 0.0


# ---------------------------------------------------------------------------
# persistent compile cache (utils/compile_cache.py)
# ---------------------------------------------------------------------------

def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from csparse3_jax.utils.compile_cache import cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache_dir() == str(tmp_path)


def test_compile_cache_fixed_repo_path(monkeypatch):
    import os

    from csparse3_jax.utils.compile_cache import cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache_dir() == os.path.join(root, ".jax_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    import jax

    from csparse3_jax.utils.compile_cache import enable_compile_cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
