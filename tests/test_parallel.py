"""Distributed layer tests on the virtual 8-device CPU mesh (SURVEY §4:
multi-device sharding without a cluster)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh

import csparse3_jax as cst
from csparse3_jax.parallel import (
    BlockJacobi,
    RowPartition,
    dist_bicgstab,
    dist_cg,
    dist_spmm,
    dist_spmv,
    partition_rows,
)

from conftest import rand_sp


def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8
    return Mesh(np.array(devs[:8]), ("rows",))


def banded_spd(n, bw=5, seed=0):
    """SPD banded matrix (Laplacian-like) — the RCM-ordered Ybus shape."""
    rng = np.random.RandomState(seed)
    diags, offs = [], []
    for off in range(1, bw + 1):
        v = -rng.rand(n - off)
        diags += [v, v]
        offs += [off, -off]
    a = sp.diags(diags, offs, shape=(n, n), format="csc")
    d = -np.asarray(a.sum(axis=1)).ravel() + 0.1
    return (a + sp.diags(d)).tocsc()


class TestPartition:
    def test_ring_strategy_banded(self):
        a = banded_spd(96, bw=3)
        part = partition_rows(cst.CSC.from_scipy(a), 8)
        assert part.strategy == "ring"
        assert part.k == 1  # band fits in neighbor halo

    def test_allgather_for_dense_pattern(self):
        a = rand_sp(64, 64, density=0.5, seed=3)
        part = partition_rows(cst.CSC.from_scipy(a), 8)
        assert part.strategy == "allgather"

    def test_pad_roundtrip(self):
        a = banded_spd(50)
        part = partition_rows(cst.CSC.from_scipy(a), 8)
        x = jnp.arange(50.0)
        assert part.pad_vector(x).shape[0] == part.m_pad
        np.testing.assert_array_equal(
            np.asarray(part.trim_vector(part.pad_vector(x))), np.asarray(x)
        )


class TestDistSpMV:
    @pytest.mark.parametrize("strategy", ["ring", "allgather"])
    def test_matches_scipy_banded(self, strategy):
        a = banded_spd(100, bw=4, seed=1)
        part = partition_rows(cst.CSC.from_scipy(a), 8, strategy=strategy)
        x = np.random.RandomState(0).rand(100)
        with mesh8() as mesh:
            y = dist_spmv(part, jnp.asarray(x), mesh)
        np.testing.assert_allclose(
            np.asarray(part.trim_vector(y)), a @ x, rtol=1e-12, atol=1e-13
        )

    def test_unstructured_allgather(self):
        a = rand_sp(73, 73, density=0.2, seed=5)
        part = partition_rows(cst.CSC.from_scipy(a), 8)
        x = np.random.RandomState(1).rand(73)
        with mesh8() as mesh:
            y = dist_spmv(part, jnp.asarray(x), mesh)
        np.testing.assert_allclose(
            np.asarray(part.trim_vector(y)), a @ x, rtol=1e-12, atol=1e-13
        )

    def test_multi_rhs(self):
        a = banded_spd(64, bw=2, seed=2)
        part = partition_rows(cst.CSC.from_scipy(a), 8)
        X = np.random.RandomState(2).rand(64, 5)
        with mesh8() as mesh:
            Y = dist_spmm(part, jnp.asarray(X), mesh)
        np.testing.assert_allclose(
            np.asarray(Y)[:64], a @ X, rtol=1e-12, atol=1e-13
        )

    def test_complex_ybus(self):
        from csparse3_jax.models.grids import synthetic_grid, ybus

        grid = synthetic_grid(120, seed=4)
        Y, _, _ = ybus(grid)
        part = partition_rows(Y, 8, strategy="allgather")
        v = np.random.RandomState(3).rand(120) + 1j * np.random.RandomState(4).rand(120)
        with mesh8() as mesh:
            i = dist_spmv(part, jnp.asarray(v), mesh)
        np.testing.assert_allclose(
            np.asarray(part.trim_vector(i)), Y.to_scipy() @ v, rtol=1e-11, atol=1e-12
        )

    def test_jit_wrapped(self):
        a = banded_spd(80, bw=3, seed=7)
        part = partition_rows(cst.CSC.from_scipy(a), 8)
        x = jnp.asarray(np.random.RandomState(5).rand(80))
        with mesh8() as mesh:
            f = jax.jit(lambda p, v: dist_spmv(p, v, mesh))
            y = f(part, x)
        np.testing.assert_allclose(
            np.asarray(y)[:80], a @ np.asarray(x), rtol=1e-12, atol=1e-13
        )


class TestDistSolve:
    def test_cg_unpreconditioned(self):
        a = banded_spd(100, bw=3, seed=11)
        part = partition_rows(cst.CSC.from_scipy(a), 8)
        b = np.random.RandomState(6).rand(100)
        with mesh8() as mesh:
            x, res, it = dist_cg(part, b, mesh, tol=1e-12)
        np.testing.assert_allclose(a @ np.asarray(x), b, rtol=1e-8, atol=1e-9)

    def test_cg_block_jacobi(self):
        a = banded_spd(128, bw=4, seed=12)
        A = cst.CSC.from_scipy(a)
        part = partition_rows(A, 8)
        prec = BlockJacobi.build(A, part)
        b = np.random.RandomState(7).rand(128)
        with mesh8() as mesh:
            x, res, it_p = dist_cg(part, b, mesh, prec=prec, tol=1e-12)
            _, _, it_u = dist_cg(part, b, mesh, tol=1e-12)
        np.testing.assert_allclose(a @ np.asarray(x), b, rtol=1e-8, atol=1e-9)
        assert int(it_p) < int(it_u)  # preconditioning must help

    def test_bicgstab_nonsymmetric(self):
        rng = np.random.RandomState(13)
        a = banded_spd(96, bw=3, seed=13).tolil()
        # break symmetry but keep dominance
        a[0, 5] += 0.3
        a[40, 44] -= 0.2
        a = a.tocsc()
        A = cst.CSC.from_scipy(a)
        part = partition_rows(A, 8)
        prec = BlockJacobi.build(A, part)
        b = rng.rand(96)
        with mesh8() as mesh:
            x, res, it = dist_bicgstab(part, b, mesh, prec=prec, tol=1e-12)
        np.testing.assert_allclose(a @ np.asarray(x), b, rtol=1e-7, atol=1e-8)

    def test_bicgstab_complex_ybus_regularized(self):
        """Distributed solve of a (regularized) admittance system — the
        config-5 shape at toy size."""
        from csparse3_jax.models.grids import synthetic_grid, ybus

        grid = synthetic_grid(96, seed=8)
        Y, _, _ = ybus(grid)
        ys = Y.to_scipy() + sp.eye(96) * (0.5 + 0.5j)  # shift off singularity
        A = cst.CSC.from_scipy(ys.tocsc())
        part = partition_rows(A, 8, strategy="allgather")
        prec = BlockJacobi.build(A, part)
        b = np.random.RandomState(9).rand(96) + 0j
        with mesh8() as mesh:
            x, res, it = dist_bicgstab(part, b, mesh, prec=prec, tol=1e-11,
                                       maxiter=2000)
        np.testing.assert_allclose(ys @ np.asarray(x), b, rtol=1e-6, atol=1e-7)


class TestIterativeSingleDevice:
    def test_cg_vs_dense(self):
        from csparse3_jax.linalg.iterative import cg, jacobi_prec

        a = banded_spd(60, bw=2, seed=21)
        A = cst.CSC.from_scipy(a)
        plan = cst.SpMVPlan(A)
        b = np.random.RandomState(10).rand(60)
        x, res, it = cg(plan, jnp.asarray(b), M=jacobi_prec(A), tol=1e-13)
        np.testing.assert_allclose(a @ np.asarray(x), b, rtol=1e-9, atol=1e-10)

    def test_bicgstab_complex(self):
        from csparse3_jax.linalg.iterative import bicgstab

        a = banded_spd(60, bw=2, seed=22).astype(complex)
        a = a + sp.eye(60) * 0.3j
        A = cst.CSC.from_scipy(a.tocsc())
        plan = cst.SpMVPlan(A)
        b = np.random.RandomState(11).rand(60) + 0j
        x, res, it = bicgstab(plan, jnp.asarray(b), tol=1e-12, maxiter=2000)
        np.testing.assert_allclose(a @ np.asarray(x), b, rtol=1e-7, atol=1e-8)

    def test_gmres(self):
        from csparse3_jax.linalg.iterative import gmres

        a = banded_spd(50, bw=2, seed=23).tolil()
        a[3, 10] += 0.4
        a = a.tocsc()
        plan = cst.SpMVPlan(cst.CSC.from_scipy(a))
        b = np.random.RandomState(12).rand(50)
        x, res, it = gmres(plan, jnp.asarray(b), tol=1e-11, restart=25)
        np.testing.assert_allclose(a @ np.asarray(x), b, rtol=1e-7, atol=1e-8)

    def test_gmres_jittable(self):
        from csparse3_jax.linalg.iterative import gmres

        a = banded_spd(40, bw=2, seed=24)
        plan = cst.SpMVPlan(cst.CSC.from_scipy(a))
        b = jnp.asarray(np.random.RandomState(13).rand(40))
        f = jax.jit(lambda p, v: gmres(p, v, tol=1e-10, restart=20))
        x, res, it = f(plan, b)
        np.testing.assert_allclose(
            a @ np.asarray(x), np.asarray(b), rtol=1e-6, atol=1e-7
        )


def test_diag_jacobi_prec_converges_faster():
    """DiagJacobi: memory-light point-Jacobi companion to BlockJacobi
    (per-shard direct factors fill at n_loc x bandwidth — untenable at
    config-5 scale)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import csparse3_jax as cst
    from csparse3_jax.parallel import DiagJacobi, dist_cg, partition_rows

    n = 4096
    rng = np.random.RandomState(3)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    # strongly varying diagonal so Jacobi actually helps
    dv = 4.0 + 10.0 * rng.rand(n)
    vals = np.concatenate([dv, -np.ones(n - 1), -np.ones(n - 1)])
    A = cst.from_triplets(rows, cols, vals, (n, n))
    part = partition_rows(A, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("rows",))
    b = rng.rand(n)
    prec = DiagJacobi.build(A, part)
    with mesh:
        x0, r0, it0 = dist_cg(part, b, mesh, tol=1e-10, maxiter=500)
        x1, r1, it1 = dist_cg(part, b, mesh, prec=prec, tol=1e-10,
                              maxiter=500)
    As = A.to_scipy()
    for x in (x0, x1):
        rel = np.linalg.norm(As @ np.asarray(x) - b) / np.linalg.norm(b)
        assert rel < 1e-7
    assert int(it1) <= int(it0)


def test_diag_jacobi_reference():
    """DiagJacobi.apply_local is exactly diag(A)^{-1} b per shard."""
    from csparse3_jax.parallel import DiagJacobi
    from csparse3_jax.parallel.partition import partition_rows

    n = 64
    rng = np.random.RandomState(5)
    dv = 2.0 + rng.rand(n)
    A = cst.diags(dv)
    part = partition_rows(A, 4)
    prec = DiagJacobi.build(A, part)
    d = np.asarray(prec.dinv)
    assert d.shape[0] == 4
    np.testing.assert_allclose(d.reshape(-1)[:n], 1.0 / dv, rtol=1e-6)
