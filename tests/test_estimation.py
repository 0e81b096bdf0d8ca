"""DC WLS state estimation vs dense normal-equations oracle."""

import numpy as np
import pytest

from csparse3_jax.models.estimation import (
    DCMeasurements,
    dc_state_estimation,
    largest_normalized_residual,
)
from csparse3_jax.models.grids import SLACK, ieee14, synthetic_grid
from csparse3_jax.models.powerflow import dc_power_flow


def _true_state(g):
    th = dc_power_flow(g)
    flows = (th[g.f] - th[g.t]) / g.x
    inj = np.zeros(g.n_bus)
    np.add.at(inj, g.f, flows)
    np.add.at(inj, g.t, -flows)
    return th, flows, inj


def _full_meas(g, noise=0.0, seed=0, sigma_f=0.01, sigma_i=0.02):
    th, flows, inj = _true_state(g)
    rng = np.random.RandomState(seed)
    zf = flows + noise * sigma_f * rng.randn(len(flows))
    buses = np.arange(g.n_bus)
    zi = inj + noise * sigma_i * rng.randn(g.n_bus)
    return DCMeasurements.build(
        flows=(np.arange(g.n_branch), zf, sigma_f),
        injections=(buses, zi, sigma_i),
    ), th


def test_exact_measurements_recover_state():
    g = ieee14()
    meas, th = _full_meas(g)
    res = dc_state_estimation(g, meas)
    np.testing.assert_allclose(res.theta, th, atol=1e-10)
    assert res.chi2 < 1e-12
    assert res.dof == meas.size - (g.n_bus - 1)


def test_noisy_matches_dense_wls_oracle():
    g = synthetic_grid(80, seed=9)
    meas, _ = _full_meas(g, noise=1.0, seed=1)
    res = dc_state_estimation(g, meas)
    # dense oracle from the sparse H the estimator itself exposes is NOT
    # independent enough: rebuild H densely from first principles
    keep = np.flatnonzero(np.asarray(g.bus_type) != SLACK)
    nb = len(keep)
    red = np.full(g.n_bus, -1, np.int64)
    red[keep] = np.arange(nb)
    b = 1.0 / g.x
    Hf = np.zeros((g.n_branch, nb))
    r = np.arange(g.n_branch)
    for end, sgn in ((g.f, 1.0), (g.t, -1.0)):
        live = red[end] >= 0
        Hf[r[live], red[end[live]]] += sgn * b[live]
    B = np.zeros((g.n_bus, g.n_bus))
    np.add.at(B, (g.f, g.f), b)
    np.add.at(B, (g.t, g.t), b)
    np.add.at(B, (g.f, g.t), -b)
    np.add.at(B, (g.t, g.f), -b)
    Hi = B[:, keep]
    H = np.vstack([Hf, Hi])
    z = np.concatenate([meas.flow_val, meas.inj_val])
    w = 1.0 / np.concatenate([meas.flow_sigma, meas.inj_sigma]) ** 2
    G = H.T @ (w[:, None] * H)
    th_r = np.linalg.solve(G, H.T @ (w * z))
    np.testing.assert_allclose(res.theta[keep], th_r, atol=1e-9)
    np.testing.assert_allclose(res.residuals, z - H @ th_r, atol=1e-9)


def test_bad_data_identified():
    g = ieee14()
    meas, _ = _full_meas(g, noise=1.0, seed=3)
    bad = 7  # corrupt one flow measurement grossly
    zf = meas.flow_val.copy()
    zf[bad] += 2.0
    meas = meas._replace(flow_val=zf)
    res = dc_state_estimation(g, meas)
    j, rN = largest_normalized_residual(res)
    assert j == bad
    assert rN[bad] > 10.0  # way past the 3-sigma test


def test_flows_only_estimation():
    # flows alone (plus the implicit slack reference) observe a connected
    # grid: H has a spanning set of branch rows
    g = ieee14()
    _, flows, _ = _true_state(g)
    meas = DCMeasurements.build(
        flows=(np.arange(g.n_branch), flows, 0.01))
    res = dc_state_estimation(g, meas)
    np.testing.assert_allclose(res.theta, dc_power_flow(g), atol=1e-10)


def test_unobservable_raises():
    g = ieee14()
    _, flows, _ = _true_state(g)
    k = np.zeros(20, dtype=np.int64)  # 20 copies of branch 0 only
    meas = DCMeasurements.build(flows=(k, flows[k], 0.01))
    with pytest.raises(ValueError, match="unobservable"):
        dc_state_estimation(g, meas)


def test_underdetermined_raises():
    g = ieee14()
    meas = DCMeasurements.build(flows=(np.array([0, 1]),
                                       np.zeros(2), 0.01))
    with pytest.raises(ValueError, match="underdetermined"):
        dc_state_estimation(g, meas)


def test_angle_measurements_and_chunking():
    g = synthetic_grid(60, seed=2)
    th, flows, inj = _true_state(g)
    buses = np.arange(g.n_bus)
    meas = DCMeasurements.build(
        flows=(np.arange(g.n_branch), flows, 0.01),
        angles=(buses, th[buses], 0.001),
    )
    res = dc_state_estimation(g, meas)
    np.testing.assert_allclose(res.theta, th, atol=1e-9)
    j1, r1 = largest_normalized_residual(res, chunk=7)
    j2, r2 = largest_normalized_residual(res)
    np.testing.assert_allclose(r1, r2, atol=1e-7)


def test_duplicate_injection_rejected():
    g = ieee14()
    meas = DCMeasurements.build(
        injections=(np.array([3, 3] + list(range(14))), np.zeros(16), 0.1))
    with pytest.raises(ValueError, match="duplicate"):
        dc_state_estimation(g, meas)
