"""N-1 DC contingency screening vs per-outage scipy solves."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from csparse3_jax.models.contingency import DCContingency
from csparse3_jax.models.grids import SLACK, ieee14, synthetic_grid


def _oracle_outage(g, k):
    n = g.n_bus
    keep = np.flatnonzero(np.asarray(g.bus_type) != SLACK)
    P = (np.asarray(g.pg) - np.asarray(g.pd))[keep]
    mask = np.ones(g.n_branch, bool)
    mask[k] = False
    f, t, x = g.f[mask], g.t[mask], g.x[mask]
    b = 1.0 / x
    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([t, f, f, t])
    vals = np.concatenate([-b, -b, b, b])
    B = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    B = B[keep][:, keep].tocsc()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        th_r = spla.spsolve(B, P)
    if not np.isfinite(th_r).all():
        return None
    th = np.zeros(n)
    th[keep] = th_r
    fl = (th[g.f] - th[g.t]) / g.x
    fl[k] = 0.0
    return fl


def test_ieee14_all_outages():
    g = ieee14()
    ca = DCContingency(g)
    flows, theta, ok = ca.run()
    assert flows.shape == (g.n_branch, g.n_branch)
    islanded = 0
    for k in range(g.n_branch):
        ref = _oracle_outage(g, k)
        if ref is None:
            assert not ok[k], f"outage {k}: islanding not detected"
            islanded += 1
            continue
        assert ok[k], f"outage {k}: spuriously flagged singular"
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(flows[k], ref, rtol=0, atol=1e-8 * scale)
    assert islanded >= 1  # the radial branch to bus 8 islands it


def test_synthetic_sample_and_batching():
    g = synthetic_grid(300, seed=4)
    ca = DCContingency(g)
    ks = np.random.RandomState(0).choice(g.n_branch, 12, replace=False)
    f1, t1, ok1 = ca.run(ks)
    f2, t2, ok2 = ca.run(ks, batch=5)  # uneven chunks, same result
    np.testing.assert_array_equal(ok1, ok2)
    np.testing.assert_allclose(f1, f2, rtol=1e-12)
    for i, k in enumerate(ks):
        ref = _oracle_outage(g, k)
        assert ref is not None and ok1[i]
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(f1[i], ref, rtol=0, atol=1e-7 * scale)


def test_base_theta_matches_dc_power_flow():
    from csparse3_jax.models.powerflow import dc_power_flow

    g = ieee14()
    ca = DCContingency(g)
    np.testing.assert_allclose(ca.base_theta(), dc_power_flow(g),
                               rtol=1e-8, atol=1e-10)


def test_run_sharded_matches_run():
    """Scenario-parallel sweep over the 8-device mesh == single-device."""
    import jax
    from jax.sharding import Mesh

    g = synthetic_grid(300, seed=4)
    ca = DCContingency(g)
    ks = np.arange(50)  # not a mesh-size multiple: exercises padding
    f1, t1, ok1 = ca.run(ks)
    mesh = Mesh(np.array(jax.devices()), ("scen",))
    f2, t2, ok2 = ca.run_sharded(mesh, ks)
    np.testing.assert_array_equal(ok1, ok2)
    np.testing.assert_allclose(f1, f2, rtol=1e-10)
    np.testing.assert_allclose(t1, t2, rtol=1e-10)


def test_islanding_with_noisy_pivot():
    """Regression: a chain grid where EVERY outage islands buses from the
    slack, but cancellation leaves round-off pivots instead of exact
    zeros — the solution is finite backward-stable garbage that only the
    KLU-style pivot-ratio estimate catches."""
    from csparse3_jax.models.grids import PQ, Grid

    n = 5
    g = Grid(n_bus=n, f=np.array([0, 1, 2, 3]), t=np.array([1, 2, 3, 4]),
             r=np.zeros(4), x=np.array([0.13, 0.071, 0.093, 0.17]),
             b=np.zeros(4), tap=np.ones(4),
             bus_type=np.array([SLACK, PQ, PQ, PQ, PQ]),
             pd=np.array([0, 0.1, 0.1, 0.1, 0.1]), qd=np.zeros(n),
             pg=np.zeros(n), vm0=np.ones(n), gs=np.zeros(n), bs=np.zeros(n))
    ca = DCContingency(g)
    flows, theta, ok = ca.run()
    assert not ok.any(), f"islanding missed: {ok}"


def test_empty_outage_list():
    g = ieee14()
    ca = DCContingency(g)
    flows, theta, ok = ca.run(np.array([], dtype=int))
    assert flows.shape == (0, g.n_branch)
    assert theta.shape == (0, g.n_bus)
    assert ok.shape == (0,)


def test_ac_contingency_vs_host_newton():
    """Full-AC N-1 vs per-outage host Newton on IEEE14 (subset of
    outages; the vmapped device sweep must match the sequential oracle
    and flag the islanding branch as not-ok)."""
    from csparse3_jax.models.contingency import ACContingency
    from csparse3_jax.models.grids import Grid
    from csparse3_jax.models.powerflow import newton_raphson

    g = ieee14()
    ca = ACContingency(g)
    ks = np.arange(g.n_branch)
    vm, va, iters, ok = ca.run(ks)
    import warnings

    mismatches = 0
    for i, k in enumerate(ks):
        mask = np.ones(g.n_branch, bool)
        mask[k] = False
        g2 = Grid(n_bus=g.n_bus, f=g.f[mask], t=g.t[mask], r=g.r[mask],
                  x=g.x[mask], b=g.b[mask], tap=np.asarray(g.tap)[mask],
                  bus_type=g.bus_type, pd=g.pd, qd=g.qd, pg=g.pg,
                  vm0=g.vm0, gs=g.gs, bs=g.bs)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                vmr, var, itr, resr = newton_raphson(g2)
                conv = resr < 1e-8
            except Exception:
                conv = False
        if conv != bool(ok[i]):
            mismatches += 1
        elif conv:
            err = max(np.abs(vm[i] - vmr).max(), np.abs(va[i] - var).max())
            if err > 1e-6:
                mismatches += 1
    assert mismatches == 0
    assert (~ok).sum() >= 1  # the radial branch islands bus 8


def test_outage_bounds_checked():
    g = ieee14()
    ca = DCContingency(g)
    with pytest.raises(IndexError):
        ca.run(np.array([g.n_branch]))  # 1-based ids would clamp silently
    from csparse3_jax.models.contingency import ACContingency

    with pytest.raises(IndexError):
        ACContingency(g).run(np.array([-1]))


def test_ac_run_sharded_matches_run():
    import jax
    from jax.sharding import Mesh

    from csparse3_jax.models.contingency import ACContingency

    g = ieee14()
    ca = ACContingency(g)
    ks = np.arange(10)  # not a mesh multiple: exercises padding
    v1, a1, i1, ok1 = ca.run(ks)
    mesh = Mesh(np.array(jax.devices()), ("scen",))
    v2, a2, i2, ok2 = ca.run_sharded(mesh, ks)
    np.testing.assert_array_equal(ok1, ok2)
    np.testing.assert_allclose(v1, v2, rtol=1e-12)
    np.testing.assert_allclose(a1, a2, rtol=1e-12)
