"""Power-flow model family: Ybus assembly vs scipy-built oracle, DC / FDPF /
Newton solvers cross-checked against each other and physics invariants
(BASELINE configs 1, 3, 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import csparse3_jax as cst
from csparse3_jax.models import (
    FastDecoupled,
    connectivity,
    dc_power_flow,
    ieee14,
    newton_raphson,
    sbus,
    synthetic_grid,
    ybus,
)


def scipy_ybus(grid):
    """Independent numpy/scipy oracle for Ybus assembly."""
    ys = 1.0 / (grid.r + 1j * grid.x)
    bc2 = 1j * grid.b / 2
    tap = grid.tap.astype(complex)
    n = grid.n_bus
    Y = np.zeros((n, n), dtype=complex)
    for k in range(grid.n_branch):
        f, t = grid.f[k], grid.t[k]
        ytt = ys[k] + bc2[k]
        Y[f, f] += ytt / (tap[k] * np.conj(tap[k]))
        Y[t, t] += ytt
        Y[f, t] += -ys[k] / np.conj(tap[k])
        Y[t, f] += -ys[k] / tap[k]
    Y[np.arange(n), np.arange(n)] += grid.gs + 1j * grid.bs
    return Y


def test_ybus_ieee14():
    grid = ieee14()
    Y, Yf, Yt = ybus(grid)
    np.testing.assert_allclose(np.asarray(Y.todense()), scipy_ybus(grid),
                               rtol=1e-12, atol=1e-14)
    # Yf/Yt consistency: Cf^T Yf + Ct^T Yt + shunts == Ybus
    Cf, Ct = connectivity(grid)
    lhs = cst.add(cst.spgemm(Cf.t(), Yf), cst.spgemm(Ct.t(), Yt))
    sh = cst.diags(grid.gs + 1j * grid.bs)
    np.testing.assert_allclose(
        np.asarray(cst.add(lhs, sh).todense()), np.asarray(Y.todense()),
        rtol=1e-12, atol=1e-14,
    )


def test_ybus_synthetic():
    grid = synthetic_grid(300, seed=1)
    Y, _, _ = ybus(grid)
    np.testing.assert_allclose(np.asarray(Y.todense()), scipy_ybus(grid),
                               rtol=1e-11, atol=1e-13)


def test_dc_power_flow_balance():
    grid = ieee14()
    th = dc_power_flow(grid)
    assert th[grid.slack[0]] == 0.0
    # flows from angles satisfy P balance at every non-slack bus
    bsus = 1.0 / grid.x
    pf = bsus * (th[grid.f] - th[grid.t])
    inj = np.zeros(grid.n_bus)
    np.add.at(inj, grid.f, pf)
    np.add.at(inj, grid.t, -pf)
    keep = grid.bus_type != 2
    np.testing.assert_allclose(inj[keep], (grid.pg - grid.pd)[keep], atol=1e-9)


def test_newton_ieee14():
    grid = ieee14()
    vm, va, iters, res = newton_raphson(grid)
    assert res < 1e-10
    assert iters <= 6
    # physical sanity: magnitudes near 1, PV setpoints held
    assert np.all(vm > 0.9) and np.all(vm < 1.1)
    np.testing.assert_allclose(vm[grid.pv], grid.vm0[grid.pv], atol=1e-12)
    # power balance at PQ buses
    Y, _, _ = ybus(grid)
    v = vm * np.exp(1j * va)
    s = v * np.conj(np.asarray(Y.todense()) @ v)
    np.testing.assert_allclose(s.real[grid.pq], (grid.pg - grid.pd)[grid.pq],
                               atol=1e-9)


def test_fdpf_matches_newton():
    grid = ieee14()
    vm_n, va_n, _, _ = newton_raphson(grid)
    fd = FastDecoupled(grid, tol=1e-10, max_iter=100)
    vm, va, iters, res = fd.solve()
    assert res < 1e-8
    np.testing.assert_allclose(vm, vm_n, atol=1e-7)
    np.testing.assert_allclose(va, va_n, atol=1e-7)


def test_fdpf_synthetic():
    grid = synthetic_grid(200, seed=3)
    fd = FastDecoupled(grid, tol=1e-8, max_iter=200)
    vm, va, iters, res = fd.solve()
    assert res < 1e-8, f"FDPF did not converge: res={res}"


def test_fdpf_batch():
    grid = ieee14()
    fd = FastDecoupled(grid, tol=1e-9, max_iter=60)
    base = sbus(grid)
    rng = np.random.RandomState(0)
    scale = 1.0 + 0.1 * rng.randn(8)[:, None]
    batch = base[None, :] * scale
    vm, va, iters = fd.solve_batch(batch)
    assert vm.shape == (8, grid.n_bus)
    # each scenario individually converged
    for i in range(8):
        r = float(fd.residual(vm[i], va[i], jnp.asarray(batch[i].real), jnp.asarray(batch[i].imag)))
        assert r < 1e-9, f"scenario {i}: residual {r}"


def test_newton_synthetic_grid():
    grid = synthetic_grid(150, seed=5)
    vm, va, iters, res = newton_raphson(grid, tol=1e-9)
    assert res < 1e-9


class TestNewtonDevice:
    def test_matches_host_newton_ieee14(self):
        from csparse3_jax.models.grids import ieee14
        from csparse3_jax.models.powerflow import NewtonPowerFlow, newton_raphson

        g = ieee14()
        vm, va, it, res = NewtonPowerFlow(g).solve()
        vm_r, va_r, _, _ = newton_raphson(g)
        assert res < 1e-9
        np.testing.assert_allclose(vm, vm_r, atol=1e-10)
        np.testing.assert_allclose(va, va_r, atol=1e-10)

    def test_power_balance_synthetic(self):
        from csparse3_jax.models.grids import synthetic_grid, ybus
        from csparse3_jax.models.powerflow import NewtonPowerFlow, sbus

        g = synthetic_grid(150, seed=9)
        npf = NewtonPowerFlow(g)
        vm, va, it, res = npf.solve()
        assert res < 1e-9
        # physics check: injections at PQ buses match specified load
        Y, _, _ = ybus(g)
        v = vm * np.exp(1j * va)
        s = v * np.conj(Y.to_scipy() @ v)
        sb = sbus(g)
        pq = g.pq
        np.testing.assert_allclose(s.real[pq], sb.real[pq], atol=1e-8)
        np.testing.assert_allclose(s.imag[pq], sb.imag[pq], atol=1e-8)

    def test_batched_scenarios(self):
        from csparse3_jax.models.grids import synthetic_grid
        from csparse3_jax.models.powerflow import NewtonPowerFlow, sbus

        g = synthetic_grid(80, seed=10)
        npf = NewtonPowerFlow(g)
        sb = sbus(g)
        batch = np.stack([sb * s for s in (0.8, 0.9, 1.0)])
        vm, va, it, res = npf.solve_batch(batch)
        assert np.asarray(res).max() < 1e-9
        assert vm.shape == (3, 80)


def test_reordered_grid_same_solution():
    """Power-flow solutions are invariant under bus renumbering
    (models.grids.rcm_grid), and the gather-free dia/banded path agrees
    with the default path."""
    from csparse3_jax.models.grids import rcm_grid, synthetic_grid
    from csparse3_jax.models.powerflow import FastDecoupled

    g = synthetic_grid(120, seed=11)
    fd = FastDecoupled(g, tol=1e-10, max_iter=80)
    vm, va, _, res = fd.solve()
    assert res < 1e-9

    g2, perm = rcm_grid(g)
    fd2 = FastDecoupled(g2, tol=1e-10, max_iter=80, spmv="dia",
                        solver="banded")
    vm2, va2, _, res2 = fd2.solve()
    assert res2 < 1e-9
    np.testing.assert_allclose(vm2, vm[perm], atol=1e-8)
    np.testing.assert_allclose(va2, va[perm], atol=1e-8)

    # symmetric-banded path: Ybus is complex symmetric (real taps), so
    # SplitSymDIA applies and must give the same solution
    fd3 = FastDecoupled(g2, tol=1e-10, max_iter=80, spmv="symdia",
                        solver="banded")
    vm3, va3, _, res3 = fd3.solve()
    assert res3 < 1e-9
    np.testing.assert_allclose(vm3, vm[perm], atol=1e-8)
    np.testing.assert_allclose(va3, va[perm], atol=1e-8)


@pytest.mark.parametrize("solver_cls", ["NewtonPowerFlow", "FastDecoupled"])
def test_unknown_spmv_plan_raises(solver_cls):
    """The Ybus SpMV plan is one of 'ell', 'dia', 'symdia'; anything else
    (the removed 'bandpoints' among them) is refused up front."""
    from csparse3_jax.models import powerflow
    from csparse3_jax.models.grids import ieee14

    with pytest.raises(ValueError, match="spmv"):
        getattr(powerflow, solver_cls)(ieee14(), spmv="bandpoints")


def test_fdpf_blocklu_solver_matches_default():
    """solver='blocklu' (BandedLU block-Thomas, no sparse factorization)
    reaches the same solution as the default level-scheduled path."""
    from csparse3_jax.models.grids import rcm_grid, synthetic_grid
    from csparse3_jax.models.powerflow import FastDecoupled

    g = synthetic_grid(150, seed=12)
    fd = FastDecoupled(g, tol=1e-10, max_iter=80)
    vm, va, _, res = fd.solve()
    assert res < 1e-9

    g2, perm = rcm_grid(g)
    fd2 = FastDecoupled(g2, tol=1e-10, max_iter=80, spmv="dia",
                        solver="blocklu")
    vm2, va2, _, res2 = fd2.solve()
    assert res2 < 1e-9
    np.testing.assert_allclose(vm2, vm[perm], atol=1e-8)
    np.testing.assert_allclose(va2, va[perm], atol=1e-8)


def test_device_newton_blocklu_matches_host():
    """NewtonPowerFlow(solver='blocklu'): the Jacobian refactors on
    device as block-Thomas recurrences; must reach the host solution."""
    from csparse3_jax.models.grids import rcm_grid, synthetic_grid
    from csparse3_jax.models.powerflow import NewtonPowerFlow, newton_raphson

    g, _ = rcm_grid(synthetic_grid(120, seed=14))
    vmh, vah, ith, resh = newton_raphson(g, tol=1e-10)
    assert resh < 1e-9

    npf = NewtonPowerFlow(g, tol=1e-8, spmv="dia", solver="blocklu")
    vm, va, it, res = npf.solve()
    assert res < 1e-7
    np.testing.assert_allclose(vm, vmh, atol=1e-7)
    np.testing.assert_allclose(va, vah, atol=1e-7)


def test_device_newton_multifrontal_matches_host():
    """NewtonPowerFlow(solver='multifrontal'): per-iteration Jacobian
    refactorization as matmul extend-add fronts (static pivoting); must
    reach the host solution."""
    from csparse3_jax.models.grids import synthetic_grid
    from csparse3_jax.models.powerflow import NewtonPowerFlow, newton_raphson

    g = synthetic_grid(120, seed=14)
    vmh, vah, ith, resh = newton_raphson(g, tol=1e-10)
    npf = NewtonPowerFlow(g, tol=1e-10, solver="multifrontal")
    vm, va, it, res = npf.solve()
    assert res < 1e-8
    np.testing.assert_allclose(np.asarray(vm), vmh, atol=1e-7)
    np.testing.assert_allclose(np.asarray(va), vah, atol=1e-7)


def test_multifrontal_growth_gate_fallback_converges():
    """Pivot-growth gate: with the growth limit
    tightened so the very first device factorization trips it, the
    gated iteration must NOT be applied, the solver must fall back to
    host splu with true partial pivoting, and Newton must still reach
    the reference solution."""
    import pytest

    from csparse3_jax.models.grids import synthetic_grid
    from csparse3_jax.models.powerflow import NewtonPowerFlow, newton_raphson

    g = synthetic_grid(120, seed=14)
    vmh, vah, _, _ = newton_raphson(g, tol=1e-10)
    # any real factorization has max_u > 1e-12 * max|J| -> gate engages
    npf = NewtonPowerFlow(g, tol=1e-10, solver="multifrontal",
                          growth_limit=1e-12)
    with pytest.warns(RuntimeWarning, match="pivot-growth gate"):
        vm, va, it, res = npf.solve()
    assert res < 1e-8
    np.testing.assert_allclose(np.asarray(vm), vmh, atol=1e-7)
    np.testing.assert_allclose(np.asarray(va), vah, atol=1e-7)

    # the device run alone must report the gate (bad=True) and an
    # UNCHANGED state for the gated iteration (flat start preserved)
    import jax.numpy as jnp

    vm0 = jnp.asarray(g.vm0.astype(np.float64))
    va0 = jnp.zeros(g.n_bus)
    vmr, var, itr, resr, bad = npf.run(vm0, va0, npf._sbr, npf._sbi)
    assert bool(bad)
    np.testing.assert_array_equal(np.asarray(vmr), np.asarray(vm0))
    np.testing.assert_array_equal(np.asarray(var), np.asarray(va0))


def test_multifrontal_growth_gate_batch_fallback():
    """solve_batch re-solves gated scenarios on host."""
    import pytest

    from csparse3_jax.models.grids import synthetic_grid
    from csparse3_jax.models.powerflow import NewtonPowerFlow, sbus

    g = synthetic_grid(80, seed=3)
    npf = NewtonPowerFlow(g, tol=1e-10, solver="multifrontal",
                          growth_limit=1e-12)
    sb = sbus(g)
    batch = np.stack([sb, sb * 1.0001])
    with pytest.warns(RuntimeWarning, match="pivot-growth gate"):
        vm, va, it, res = npf.solve_batch(batch)
    assert np.asarray(res).max() < 1e-8
