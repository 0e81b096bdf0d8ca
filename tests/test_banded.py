"""Block-bidiagonal banded solves (linalg/banded.py) vs scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import csparse3_jax as cst
from csparse3_jax.linalg import BandedLU, BandedSolvePlan, bandwidth, splu


def _grid_system(n, seed, shift=3.0):
    from csparse3_jax.models.grids import synthetic_grid

    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = cst.from_triplets(rows, cols, vals, (n, n))
    return cst.add(B, cst.diags(np.full(n, shift)))


def test_banded_solve_matches_scipy():
    A = _grid_system(600, seed=2)
    lu = splu(A, ordering="rcm", tol=0.0)
    plan = lu.banded_solve_plan()
    b = np.random.RandomState(0).rand(600)
    x = np.asarray(plan(jnp.asarray(b)))
    xref = spla.spsolve(A.to_scipy().tocsc(), b)
    np.testing.assert_allclose(x, xref, rtol=1e-8, atol=1e-10)


def test_banded_multi_rhs_jit():
    A = _grid_system(400, seed=3)
    lu = splu(A, ordering="rcm", tol=0.0)
    plan = lu.banded_solve_plan()
    B = np.random.RandomState(1).rand(400, 33)
    X = np.asarray(jax.jit(lambda p, b: p(b))(plan, jnp.asarray(B)))
    Xref = spla.spsolve(A.to_scipy().tocsc(), B)
    np.testing.assert_allclose(X, Xref, rtol=1e-8, atol=1e-10)


def test_matches_level_scheduled_plan():
    A = _grid_system(300, seed=4)
    lu = splu(A, ordering="rcm", tol=0.0)
    b = np.random.RandomState(2).rand(300)
    x_band = np.asarray(lu.banded_solve_plan()(jnp.asarray(b)))
    x_lvl = np.asarray(lu.solve_plan()(jnp.asarray(b)))
    np.testing.assert_allclose(x_band, x_lvl, rtol=1e-10, atol=1e-12)


def test_bandwidth_guard():
    # AMD ordering scatters the band -> plan with tiny block must refuse
    A = _grid_system(300, seed=5)
    lu = splu(A, ordering="amd")
    bw = max(bandwidth(lu._h.Lp, lu._h.Li), bandwidth(lu._h.Up, lu._h.Ui))
    with pytest.raises(ValueError, match="block size"):
        BandedSolvePlan(lu._h, s=max(8, (bw // 2) // 8 * 8))


def test_complex_banded():
    from csparse3_jax.models.grids import synthetic_grid, ybus

    g = synthetic_grid(300, seed=6)
    Y, _, _ = ybus(g)
    ys = (Y.to_scipy() + sp.eye(300) * (0.5 + 0.5j)).tocsc()
    A = cst.CSC.from_scipy(ys)
    lu = splu(A, ordering="rcm", tol=0.0)
    plan = lu.banded_solve_plan()
    b = np.random.RandomState(3).rand(300) + 0j
    x = np.asarray(plan(jnp.asarray(b)))
    np.testing.assert_allclose(ys @ x, b, rtol=1e-8, atol=1e-9)


class TestBandedLU:
    """Block-tridiagonal direct factorization (BandedLU) vs scipy."""

    def test_solve_matches_scipy(self):
        A = _grid_system(600, seed=7)
        plan = BandedLU(A)
        b = np.random.RandomState(0).rand(600)
        xref = spla.spsolve(A.to_scipy().tocsc(), b)
        # f64 host twin is near-exact
        np.testing.assert_allclose(plan.solve_host(b), xref,
                                   rtol=1e-12, atol=1e-14)
        # jitted device sweeps (f32 by default without x64)
        x = np.asarray(jax.jit(plan)(jnp.asarray(b)))
        np.testing.assert_allclose(x, xref, rtol=1e-5, atol=1e-7)

    def test_multi_rhs(self):
        A = _grid_system(500, seed=8)
        plan = BandedLU(A)
        B = np.random.RandomState(1).rand(500, 64)
        X = np.asarray(jax.jit(plan)(jnp.asarray(B)))
        Xref = spla.spsolve(A.to_scipy().tocsc(), B)
        np.testing.assert_allclose(X, Xref, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(plan.solve_host(B), Xref,
                                   rtol=1e-12, atol=1e-14)

    def test_natural_ordering_tridiagonal(self):
        n = 257  # deliberately not a multiple of the block size
        main = 4.0 * np.ones(n)
        off = -np.ones(n - 1)
        A_sp = sp.diags([off, main, off], [-1, 0, 1]).tocsc()
        plan = BandedLU(cst.CSC.from_scipy(A_sp), ordering=None)
        b = np.random.RandomState(2).rand(n)
        np.testing.assert_allclose(plan.solve_host(b), spla.spsolve(A_sp, b),
                                   rtol=1e-12, atol=1e-14)

    def test_block_size_guard(self):
        A = _grid_system(300, seed=9)
        with pytest.raises(ValueError, match="bandwidth"):
            BandedLU(A, s=8)

    def test_singular_block_raises(self):
        n = 64
        A_sp = sp.diags([np.zeros(n)], [0]).tocsc()
        A_sp = (A_sp + sp.diags([-np.ones(n - 1)], [1])).tocsc()
        with pytest.raises(np.linalg.LinAlgError):
            BandedLU(cst.CSC.from_scipy(A_sp), ordering=None)

    def test_pytree_roundtrip_in_jit(self):
        A = _grid_system(300, seed=10)
        plan = BandedLU(A)
        b = jnp.asarray(np.random.RandomState(3).rand(300))

        @jax.jit
        def run(p, v):
            return p(v)

        x1 = np.asarray(run(plan, b))
        x2 = np.asarray(plan(b))
        np.testing.assert_allclose(x1, x2, rtol=1e-6, atol=1e-8)


class TestBandedRefactor:
    """Device block-Thomas refactorization (BandedRefactor)."""

    def test_refactor_matches_fresh_factor(self):
        A = _grid_system(500, seed=11)
        plan = BandedLU(A)
        rf = plan.refactor_plan(A)
        b = np.random.RandomState(0).rand(500)
        # same values -> same solve
        plan2 = jax.jit(lambda r, d: r(d))(rf, jnp.asarray(A.np_arrays()[2]))
        x1 = np.asarray(plan(b))
        x2 = np.asarray(plan2(b))
        np.testing.assert_allclose(x2, x1, rtol=1e-5, atol=1e-8)

    def test_refactor_new_values(self):
        A = _grid_system(400, seed=12)
        plan = BandedLU(A)
        rf = plan.refactor_plan(A)
        ip, ix, dt = A.np_arrays()
        new = dt * 1.7
        A2 = cst.CSC(400, 400, ip, ix, new)
        plan2 = rf(jnp.asarray(new))
        b = np.random.RandomState(1).rand(400)
        xref = spla.spsolve(A2.to_scipy().tocsc(), b)
        np.testing.assert_allclose(np.asarray(plan2(b)), xref,
                                   rtol=1e-4, atol=1e-6)

    def test_refactor_inside_scan(self):
        """factor-per-iteration loops must jit (Newton shape)."""
        A = _grid_system(300, seed=13)
        plan = BandedLU(A)
        rf = plan.refactor_plan(A)
        d0 = jnp.asarray(A.np_arrays()[2])
        b = jnp.asarray(np.random.RandomState(2).rand(300))

        @jax.jit
        def chain(rf, d, b):
            def body(c, _):
                p = rf(c * 1.0)
                x = p(b)
                return c * (1.0 + 1e-9 * jnp.max(jnp.abs(x))), x

            _, xs = jax.lax.scan(body, d, None, length=3)
            return xs

        xs = np.asarray(chain(rf, d0, b))
        xref = spla.spsolve(A.to_scipy().tocsc(), np.asarray(b))
        np.testing.assert_allclose(xs[0], xref, rtol=1e-4, atol=1e-6)


class TestBandedLUComplex:
    """Complex (Ybus-type) systems: host stacks embed as constants under
    closure-jit (utils.splitc) so no complex dtype ever crosses the
    host<->device boundary."""

    def _ybus_system(self, n, seed):
        from csparse3_jax.models.grids import synthetic_grid, ybus

        g = synthetic_grid(n, seed=seed)
        Y, _, _ = ybus(g)
        return cst.add(Y, cst.diags(np.full(n, 0.5 + 0.1j)))

    def test_complex_host_and_device(self):
        from csparse3_jax.utils import split, splitc, unsplit

        A = self._ybus_system(800, seed=6)
        plan = BandedLU(A)
        rng = np.random.RandomState(0)
        b = rng.rand(800) + 1j * rng.rand(800)
        xs = spla.spsolve(A.to_scipy().tocsc(), b)
        np.testing.assert_allclose(plan.solve_host(b), xs,
                                   rtol=1e-12, atol=1e-14)
        solve = jax.jit(splitc(plan))
        xd = unsplit(np.asarray(solve(split(b.astype(np.complex64)))))
        np.testing.assert_allclose(xd, xs, rtol=2e-4, atol=1e-6)


class TestFactorDevice:
    """BandedLU.factor_device: numeric factorization entirely on device
    (symbolic-only host work) — the on-chip LU path."""

    def test_matches_scipy(self):
        A = _grid_system(800, seed=7)
        lu, rf = BandedLU.factor_device(A)
        b = np.random.RandomState(3).rand(800).astype(np.float32)
        x = np.asarray(lu(jnp.asarray(b)), dtype=np.float64)
        As = A.to_scipy().tocsc()
        xref = spla.spsolve(As, b.astype(np.float64))
        assert np.abs(x - xref).max() / np.abs(xref).max() < 1e-4
        res = np.linalg.norm(As @ x - b) / np.linalg.norm(b)
        assert res < 1e-5

    def test_matches_host_constructor(self):
        A = _grid_system(500, seed=8)
        lu_d, _ = BandedLU.factor_device(A)
        lu_h = BandedLU(A)
        assert lu_d.s == lu_h.s and lu_d.bw == lu_h.bw
        b = np.random.RandomState(4).rand(500, 5).astype(np.float32)
        xd = np.asarray(lu_d(jnp.asarray(b)))
        xh = np.asarray(lu_h(jnp.asarray(b)))
        np.testing.assert_allclose(xd, xh, rtol=2e-4, atol=2e-5)

    def test_refactor_handle_reuse(self):
        A = _grid_system(400, seed=9)
        lu, rf = BandedLU.factor_device(A)
        # same pattern, scaled values: x solves (2A) x = b  =>  2x solves
        data2 = jnp.asarray(np.asarray(A.np_arrays()[2]) * 2.0)
        lu2 = jax.jit(rf)(data2)
        b = np.random.RandomState(5).rand(400).astype(np.float32)
        x2 = np.asarray(lu2(jnp.asarray(b)), dtype=np.float64)
        As = A.to_scipy().tocsc()
        res = np.linalg.norm(2.0 * (As @ x2) - b) / np.linalg.norm(b)
        assert res < 1e-5

    def test_from_matrix_inside_jit_chain(self):
        from csparse3_jax.linalg.banded import BandedRefactor

        A = _grid_system(300, seed=10)
        rf = BandedRefactor.from_matrix(A)
        data = jnp.asarray(np.asarray(A.np_arrays()[2], np.float32))
        b = jnp.asarray(np.random.RandomState(6).rand(300).astype(np.float32))

        @jax.jit
        def fs(d, b):
            return rf(d)(b)

        x = np.asarray(fs(data, b), dtype=np.float64)
        As = A.to_scipy().tocsc()
        res = np.linalg.norm(As @ x - np.asarray(b, np.float64))
        assert res / np.linalg.norm(np.asarray(b)) < 1e-5

    def test_complex_solves_via_embedding(self):
        """r5: the former real-only guard is lifted — complex input
        factors through the split-complex interleaved embedding."""
        import scipy.sparse.linalg as spla

        from csparse3_jax.models.grids import synthetic_grid, ybus

        g = synthetic_grid(100, seed=11)
        Y, _, _ = ybus(g)
        A = cst.add(Y, cst.diags(np.full(100, 2.0 + 0.3j)))
        lu, _ = BandedLU.factor_device(A)
        b = np.random.RandomState(3).rand(100) + 0.5j
        x = lu(b)
        xr = spla.spsolve(A.to_scipy().tocsc(), b)
        np.testing.assert_allclose(x, xr, rtol=2e-3, atol=2e-5)


def test_factor_device_complex_single_chip():
    """BandedLU.factor_device on a complex matrix: split-complex
    interleaved embedding, ComplexBandedSolve wrapper (the
    linalg/banded.py real-only guard is lifted)."""
    import scipy.sparse.linalg as spla

    from csparse3_jax.linalg import BandedLU
    from csparse3_jax.models.grids import synthetic_grid, ybus

    n = 3000
    g = synthetic_grid(n, seed=7)
    Y, _, _ = ybus(g)
    A = cst.add(Y, cst.diags(np.full(n, 2.0 + 0.3j)))
    lu, rf = BandedLU.factor_device(A)
    rng = np.random.RandomState(2)
    b = rng.rand(n) + 1j * rng.rand(n)
    x = lu(b)
    As = A.to_scipy().tocsc()
    resid = np.linalg.norm(As @ x - b) / np.linalg.norm(b)
    assert resid < 1e-4, resid
    xr = spla.spsolve(As, b)
    np.testing.assert_allclose(x, xr, rtol=2e-3, atol=2e-5)


class TestStreamedSPIKE:
    """Single-chip out-of-core SPIKE (linalg/spike_stream.py): chunk
    rematerialization — only tips + reduced factors persist."""

    def _sys(self, n, seed=1):
        A = _grid_system(n, seed)
        return A, A.to_scipy().tocsc()

    def test_matches_scipy(self):
        from csparse3_jax.linalg import StreamedSPIKE

        A, As = self._sys(6000)
        sk = StreamedSPIKE(A, P=4)
        b = np.random.RandomState(0).rand(6000)
        x = sk(b)
        res = np.linalg.norm(As @ x.astype(np.float64) - b) \
            / np.linalg.norm(b)
        assert res < 1e-4, res
        # second solve reuses cached tips/reduced factors
        B = np.random.RandomState(1).rand(6000, 3)
        X = sk(B)
        res2 = np.linalg.norm(As @ X.astype(np.float64) - B) \
            / np.linalg.norm(B)
        assert res2 < 1e-4, res2

    def test_chunk_count_invariance(self):
        from csparse3_jax.linalg import StreamedSPIKE

        A, As = self._sys(4000, seed=2)
        b = np.random.RandomState(2).rand(4000)
        x4 = StreamedSPIKE(A, P=4)(b)
        x8 = StreamedSPIKE(A, P=8)(b)
        np.testing.assert_allclose(x8, x4, rtol=1e-3, atol=1e-5)

    def test_matches_dist_banded(self):
        """Same answer as the mesh path (DistBandedLU.factor_device)."""
        from csparse3_jax.linalg import StreamedSPIKE
        from csparse3_jax.parallel import DistBandedLU
        from jax.sharding import Mesh

        devs = jax.devices()
        if len(devs) < 4:
            pytest.skip("needs 4 devices")
        A, As = self._sys(5000, seed=3)
        b = np.random.RandomState(3).rand(5000)
        xs = StreamedSPIKE(A, P=4)(b)
        xd = DistBandedLU.factor_device(
            A, mesh=Mesh(np.array(devs[:4]), ("rows",)))(b)
        np.testing.assert_allclose(xs, np.asarray(xd), rtol=2e-3,
                                   atol=2e-5)

    def test_unsymmetric_general_path(self):
        from csparse3_jax.linalg import StreamedSPIKE

        n = 2000
        rng = np.random.RandomState(5)
        tri = sp.diags([rng.rand(n - 1), 4 + rng.rand(n),
                        2 * rng.rand(n - 1)], [-1, 0, 1]).tocsc()
        A = cst.CSC.from_scipy(tri)
        sk = StreamedSPIKE(A, P=4, ordering=None)
        b = rng.rand(n)
        x = sk(b)
        res = np.linalg.norm(tri @ x.astype(np.float64) - b) \
            / np.linalg.norm(b)
        assert res < 1e-4, res

    def test_complex_via_embedding(self):
        from csparse3_jax.linalg import StreamedSPIKE
        from csparse3_jax.models.grids import synthetic_grid, ybus

        n = 3000
        g = synthetic_grid(n, seed=9)
        Y, _, _ = ybus(g)
        A = cst.add(Y, cst.diags(np.full(n, 2.0 + 0.3j)))
        sk = StreamedSPIKE(A, P=4)
        b = np.random.RandomState(4).rand(n) + \
            1j * np.random.RandomState(5).rand(n)
        x = sk(b)
        As = A.to_scipy().tocsc()
        res = np.linalg.norm(As @ x - b) / np.linalg.norm(b)
        assert res < 1e-4, res


    def test_pad_blocks_span_trailing_chunks(self):
        """Regression (r5 review): when padding extends beyond the last
        chunk, each pad block's unit diagonal must land in its OWNING
        chunk — lumping them onto the last chunk left earlier chunks
        with singular all-zero D blocks (NaN solve)."""
        from csparse3_jax.linalg import StreamedSPIKE

        n = 136   # s=8 -> nblk=17, m=3, nb=24: pad blocks 17..23
        main = 4.0 * np.ones(n)
        off = -np.ones(n - 1)
        A_sp = sp.diags([off, main, off], [-1, 0, 1]).tocsc()
        A = cst.CSC.from_scipy(A_sp)
        sk = StreamedSPIKE(A, P=8, ordering=None, s=8)
        b = np.random.RandomState(7).rand(n)
        x = sk(b)
        assert np.isfinite(x).all()
        res = np.linalg.norm(A_sp @ x.astype(np.float64) - b) \
            / np.linalg.norm(b)
        assert res < 1e-4, res

    def test_single_chunk(self):
        """Regression (r5 review): P=1 has no interfaces — the local
        sweep IS the solution (the reduced factor would crash on a
        zero-length scan)."""
        from csparse3_jax.linalg import StreamedSPIKE

        A, As = self._sys(2000, seed=6)
        sk = StreamedSPIKE(A, P=1)
        b = np.random.RandomState(8).rand(2000)
        x = sk(b)
        res = np.linalg.norm(As @ x.astype(np.float64) - b) \
            / np.linalg.norm(b)
        assert res < 1e-4, res

    def test_complex_explicit_block_size(self):
        """Regression (r5 review): a block size that was legal for the
        complex system (s >= bw) must stay legal after the interleaved
        embedding doubles the bandwidth."""
        from csparse3_jax.linalg import StreamedSPIKE, bandwidth

        n = 600
        rng = np.random.RandomState(9)
        # s == bw is the failure boundary: the interleaved embedding
        # has bandwidth 2*bw + 1 = 17, so the old 2*s mapping (16)
        # raised; only a mapping >= 2*s + 1 passes
        diags_c = [rng.rand(n - 8) + 1j * rng.rand(n - 8),
                   4 + rng.rand(n) + 0.5j,
                   rng.rand(n - 8) - 1j * rng.rand(n - 8)]
        A_sp = sp.diags(diags_c, [-8, 0, 8]).tocsc()
        A = cst.CSC.from_scipy(A_sp)
        sk = StreamedSPIKE(A, P=2, ordering=None, s=8)  # s == bw == 8
        b = rng.rand(n) + 1j * rng.rand(n)
        x = sk(b)
        res = np.linalg.norm(A_sp @ x - b) / np.linalg.norm(b)
        assert res < 1e-4, res
