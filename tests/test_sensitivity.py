"""PTDF / LODF linear sensitivities vs brute-force DC re-solves."""

import numpy as np
import pytest

from csparse3_jax.models import (
    DCContingency,
    LinearContingency,
    lodf,
    ptdf,
)
from csparse3_jax.models.grids import SLACK, ieee14, synthetic_grid
from csparse3_jax.models.powerflow import dc_power_flow


def _base_flows(g):
    th = dc_power_flow(g)
    return (th[g.f] - th[g.t]) / g.x


def test_ptdf_reproduces_base_flows():
    g = ieee14()
    H = ptdf(g)
    P = np.asarray(g.pg) - np.asarray(g.pd)
    np.testing.assert_allclose(H @ P, _base_flows(g), atol=1e-10)
    # slack columns are exactly zero
    slack = np.flatnonzero(np.asarray(g.bus_type) == SLACK)
    assert (H[:, slack] == 0).all()


def test_ptdf_matches_finite_difference():
    g = synthetic_grid(120, seed=7)
    H = ptdf(g)
    base = _base_flows(g)
    rng = np.random.RandomState(0)
    slack = np.flatnonzero(np.asarray(g.bus_type) == SLACK)[0]
    for i in rng.choice(g.n_bus, 5, replace=False):
        if i == slack:
            continue
        gp = g._replace(pg=np.asarray(g.pg).copy())
        gp.pg[i] += 1.0  # 1 p.u. extra injection at bus i
        np.testing.assert_allclose(_base_flows(gp) - base, H[:, i],
                                   atol=1e-8)


def test_ptdf_monitored_subset_and_chunking():
    g = synthetic_grid(150, seed=3)
    H = ptdf(g, chunk=17)
    sub = np.array([0, 5, g.n_branch - 1])
    Hs = ptdf(g, branches=sub)
    np.testing.assert_allclose(Hs, H[sub], atol=1e-12)


def test_lodf_screen_matches_refactor_contingency():
    g = ieee14()
    lin = LinearContingency(g)
    flows_lin, ok_lin = lin.run()
    ca = DCContingency(g)
    flows_ref, _, ok_ref = ca.run()
    np.testing.assert_array_equal(ok_lin, ok_ref)
    assert not ok_lin.all()  # the radial branch to bus 8 islands
    for k in np.flatnonzero(ok_lin):
        scale = max(np.abs(flows_ref[k]).max(), 1e-12)
        np.testing.assert_allclose(flows_lin[k], flows_ref[k],
                                   rtol=0, atol=1e-8 * scale,
                                   err_msg=f"outage {k}")


def test_lodf_screen_synthetic_subset():
    g = synthetic_grid(250, seed=11)
    lin = LinearContingency(g)
    ks = np.random.RandomState(1).choice(g.n_branch, 10, replace=False)
    flows_lin, ok_lin = lin.run(ks)
    ca = DCContingency(g)
    flows_ref, _, ok_ref = ca.run(ks)
    np.testing.assert_array_equal(ok_lin, ok_ref)
    sel = np.flatnonzero(ok_lin)
    scale = max(np.abs(flows_ref[sel]).max(), 1e-12)
    np.testing.assert_allclose(flows_lin[sel], flows_ref[sel],
                               rtol=0, atol=1e-7 * scale)


def test_lodf_islanding_column_zeroed():
    g = ieee14()
    L, ok = lodf(g)
    assert L.shape == (g.n_branch, g.n_branch)
    bad = np.flatnonzero(~ok)
    assert len(bad) >= 1
    assert (L[:, bad] == 0).all()
    good = np.flatnonzero(ok)
    np.testing.assert_allclose(np.diagonal(L)[good], -1.0)


def test_linear_contingency_sharded_matches_local():
    import jax
    from jax.sharding import Mesh

    g = synthetic_grid(200, seed=5)
    lin = LinearContingency(g)
    flows, ok = lin.run()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("s",))
    flows_sh, ok_sh = lin.run_sharded(mesh)
    np.testing.assert_array_equal(ok, ok_sh)
    np.testing.assert_allclose(flows_sh, flows, atol=1e-12)


def test_bad_indices_raise():
    g = ieee14()
    lin = LinearContingency(g)
    with pytest.raises(IndexError):
        lin.run(np.array([g.n_branch]))
    with pytest.raises(IndexError):
        ptdf(g, branches=np.array([-1]))
