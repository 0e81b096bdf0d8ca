"""Distributed SPIKE banded direct solve (parallel/banded.py) on the
virtual 8-device CPU mesh, vs scipy spsolve."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from jax.sharding import Mesh

import csparse3_jax as cst
from csparse3_jax.parallel import DistBandedLU


def _grid_system(n, seed, shift=3.0):
    from csparse3_jax.models.grids import synthetic_grid

    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = cst.from_triplets(rows, cols, vals, (n, n))
    return cst.add(B, cst.diags(np.full(n, shift)))


def _mesh(k):
    devs = jax.devices()
    if len(devs) < k:
        pytest.skip(f"needs {k} devices")
    return Mesh(np.array(devs[:k]), ("rows",))


class TestDistBandedLU:
    def test_matches_scipy_8way(self):
        A = _grid_system(5000, seed=1)
        plan = DistBandedLU(A, mesh=_mesh(8))
        b = np.random.RandomState(0).rand(5000, 8)
        xs = spla.spsolve(A.to_scipy().tocsc(), b)
        np.testing.assert_allclose(plan.solve_host(b), xs,
                                   rtol=1e-10, atol=1e-12)
        xd = plan(b)
        np.testing.assert_allclose(xd, xs, rtol=1e-5, atol=1e-7)

    def test_partition_count_invariance(self):
        A = _grid_system(3000, seed=2)
        b = np.random.RandomState(1).rand(3000)
        x1 = DistBandedLU(A, mesh=_mesh(1))(b)
        x4 = DistBandedLU(A, mesh=_mesh(4))(b)
        x8 = DistBandedLU(A, mesh=_mesh(8))(b)
        np.testing.assert_allclose(x4, x1, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(x8, x1, rtol=1e-5, atol=1e-7)

    def test_natural_band(self):
        n = 4096
        main = 4.0 * np.ones(n)
        off = -np.ones(n - 1)
        off9 = -0.3 * np.ones(n - 9)
        A_sp = sp.diags([off9, off, main, off, off9],
                        [-9, -1, 0, 1, 9]).tocsc()
        plan = DistBandedLU(cst.CSC.from_scipy(A_sp), mesh=_mesh(8),
                            ordering=None)
        b = np.random.RandomState(2).rand(n)
        np.testing.assert_allclose(plan.solve_host(b),
                                   spla.spsolve(A_sp, b),
                                   rtol=1e-10, atol=1e-12)

    def test_chunk_guard(self):
        A = _grid_system(400, seed=3)
        with pytest.raises(ValueError, match="chunks"):
            DistBandedLU(A, mesh=_mesh(8), s=256)


def test_factor_device_matches_host():
    """Device-sharded SPIKE factorization (shard_map block-Thomas +
    spike solves + device-reduced interface) vs the host-factored one
    and scipy."""
    import scipy.sparse.linalg as spla

    from csparse3_jax.parallel import DistBandedLU

    n = 4000
    A = _grid_system(n, seed=3)
    mesh8 = _mesh(8)
    dk = DistBandedLU.factor_device(A, mesh=mesh8)
    b = np.random.RandomState(1).rand(n).astype(np.float32)
    x = np.asarray(dk(b), np.float64)
    As = A.to_scipy().tocsc()
    res = np.linalg.norm(As @ x - b) / np.linalg.norm(b)
    assert res < 1e-4
    xr = spla.spsolve(As, b.astype(np.float64))
    assert np.abs(x - xr).max() / np.abs(xr).max() < 1e-3
    # same answer as the host-factored SPIKE
    x2 = np.asarray(DistBandedLU(A, mesh=mesh8)(b), np.float64)
    assert np.abs(x - x2).max() / max(np.abs(x2).max(), 1e-30) < 1e-4


def test_factor_device_reduced_store_modes():
    """'sharded' (1/P memory + per-solve gather) and 'replicated' agree."""
    import scipy.sparse as sp

    n = 4096
    d1 = -np.ones(n - 1)
    band = sp.diags([d1, 4.0 * np.ones(n), d1], [-1, 0, 1]).tocsc()
    A = cst.CSC.from_scipy(band)
    b = np.random.RandomState(0).rand(n)
    xs = []
    for mode in ("sharded", "replicated"):
        dk = DistBandedLU.factor_device(A, mesh=_mesh(8), ordering=None,
                                        s=64, reduced_store=mode)
        assert dk._r_sharded == (mode == "sharded")
        xs.append(np.asarray(dk(b), np.float64))
    ref = sp.linalg.spsolve(band, b)
    for x in xs:
        np.testing.assert_allclose(x, ref, rtol=1e-4, atol=1e-6)


def test_factor_device_complex_50k():
    """AC config-5 path: a complex 50k Ybus-like
    system SPIKE-factored ON the mesh through the split-complex
    interleaved real embedding, solved to <1e-4 relative residual."""
    from csparse3_jax.models.grids import synthetic_grid, ybus

    n = 50_000
    g = synthetic_grid(n, seed=3)
    Y, _, _ = ybus(g)
    A = cst.add(Y, cst.diags(np.full(n, 3.0 + 0.5j)))
    mesh = _mesh(8)
    dk = DistBandedLU.factor_device(A, mesh=mesh)
    rng = np.random.RandomState(0)
    b = rng.rand(n) + 1j * rng.rand(n)
    x = dk(b)
    assert np.iscomplexobj(x) and x.shape == (n,)
    As = A.to_scipy().tocsc()
    resid = np.linalg.norm(As @ x - b) / np.linalg.norm(b)
    assert resid < 1e-4, f"complex distributed solve residual {resid}"


def test_factor_device_complex_small_matches_scipy():
    """Small complex case: values against spsolve, plus multi-RHS."""
    from csparse3_jax.models.grids import synthetic_grid, ybus

    n = 3000
    g = synthetic_grid(n, seed=5)
    Y, _, _ = ybus(g)
    A = cst.add(Y, cst.diags(np.full(n, 2.0 + 0.3j)))
    dk = DistBandedLU.factor_device(A, mesh=_mesh(4))
    rng = np.random.RandomState(1)
    B = rng.rand(n, 3) + 1j * rng.rand(n, 3)
    X = dk(B)
    Xr = spla.spsolve(A.to_scipy().tocsc(), B)
    As = A.to_scipy().tocsc()
    resid = np.linalg.norm(As @ X - B) / np.linalg.norm(B)
    assert resid < 1e-4
    np.testing.assert_allclose(X, Xr, rtol=2e-3, atol=2e-5)
