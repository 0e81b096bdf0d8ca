"""MATPOWER case reader tests (models/matpower.py).

Oracle: the MATPOWER pi-model formulas computed densely in numpy, plus a
Grid -> case-text -> Grid round trip on the IEEE 14-bus system.
"""

import io

import numpy as np
import pytest

from csparse3_jax.models import grids
from csparse3_jax.models.matpower import load_case, parse_case

CASE3 = """
function mpc = case3
% a 3-bus case: non-consecutive ids, a phase-shifting transformer,
% one out-of-service branch, one switched-off generator
mpc.version = '2';
mpc.baseMVA = 50;
mpc.bus = [
    10  3   0    0    0   0   1  1.00  0  345  1  1.1  0.9;
    20  2  25   10    0   5   1  1.02  0  345  1  1.1  0.9;
    35  1  60   20    2   0   1  0     0  345  1  1.1  0.9;
];
mpc.gen = [
    10  80  0  99 -99  1.05  50  1  200  0;
    20  40  0  99 -99  1.01  50  1  200  0;
    35  99  0  99 -99  1.50  50  0  200  0;  % off: must be ignored
];
mpc.branch = [
    10  20  0.01  0.06  0.10  0 0 0  0     0   1  -360 360;
    20  35  0.02  0.08  0.04  0 0 0  1.05  10  1  -360 360;
    10  35  0.01  0.05  0.00  0 0 0  0     0   0  -360 360;  % out of service
];
"""


def test_parse_case3():
    g = parse_case(CASE3)
    assert g.n_bus == 3 and g.n_branch == 2  # third branch dropped
    # bus id remap 10,20,35 -> 0,1,2
    np.testing.assert_array_equal(g.f, [0, 1])
    np.testing.assert_array_equal(g.t, [1, 2])
    np.testing.assert_array_equal(g.bus_type,
                                  [grids.SLACK, grids.PV, grids.PQ])
    # p.u. conversion on baseMVA=50
    np.testing.assert_allclose(g.pd, [0, 0.5, 1.2])
    np.testing.assert_allclose(g.qd, [0, 0.2, 0.4])
    np.testing.assert_allclose(g.gs, [0, 0, 0.04])
    np.testing.assert_allclose(g.bs, [0, 0.1, 0])
    # only in-service generators aggregate; VG overrides bus VM
    np.testing.assert_allclose(g.pg, [1.6, 0.8, 0])
    np.testing.assert_allclose(g.vm0, [1.05, 1.01, 1.0])  # vm<=0 -> flat
    # tap: nominal (0 -> 1) on branch 1; ratio+shift on branch 2
    assert g.tap[0] == 1.0
    np.testing.assert_allclose(g.tap[1], 1.05 * np.exp(1j * np.deg2rad(10)))


def test_ybus_matches_matpower_formulas():
    g = parse_case(CASE3)
    Y, Yf, Yt = grids.ybus(g)
    n = g.n_bus
    dense = np.zeros((n, n), dtype=complex)
    for k in range(g.n_branch):
        ys = 1.0 / (g.r[k] + 1j * g.x[k])
        bc2 = 1j * g.b[k] / 2
        tap = g.tap[k]
        f, t = g.f[k], g.t[k]
        dense[f, f] += (ys + bc2) / (tap * np.conj(tap))
        dense[f, t] += -ys / np.conj(tap)
        dense[t, f] += -ys / tap
        dense[t, t] += ys + bc2
    dense += np.diag(g.gs + 1j * g.bs)
    np.testing.assert_allclose(np.asarray(Y.todense()), dense, atol=1e-12)


def _grid_to_case_text(g, base=100.0):
    """Minimal MATPOWER writer for the round-trip test."""
    buf = io.StringIO()
    buf.write("function mpc = roundtrip\nmpc.version = '2';\n")
    buf.write(f"mpc.baseMVA = {base};\n")
    mp_type = np.where(np.asarray(g.bus_type) == grids.SLACK, 3,
                       np.where(np.asarray(g.bus_type) == grids.PV, 2, 1))
    buf.write("mpc.bus = [\n")
    for i in range(g.n_bus):
        buf.write(
            f" {i + 1} {mp_type[i]} {g.pd[i] * base} {g.qd[i] * base}"
            f" {g.gs[i] * base} {g.bs[i] * base} 1 {g.vm0[i]}"
            f" 0 0 1 1.1 0.9;\n")
    buf.write("];\nmpc.gen = [\n")
    for i in np.flatnonzero(g.pg != 0):
        buf.write(f" {i + 1} {g.pg[i] * base} 0 99 -99 {g.vm0[i]}"
                  f" {base} 1 999 0;\n")
    buf.write("];\nmpc.branch = [\n")
    tap = np.asarray(g.tap)
    ratio = np.abs(tap)
    shift = np.degrees(np.angle(tap)) if np.iscomplexobj(tap) else \
        np.zeros(g.n_branch)
    for k in range(g.n_branch):
        buf.write(
            f" {g.f[k] + 1} {g.t[k] + 1} {g.r[k]} {g.x[k]} {g.b[k]}"
            f" 0 0 0 {ratio[k]} {shift[k]} 1 -360 360;\n")
    buf.write("];\n")
    return buf.getvalue()


def test_ieee14_round_trip():
    g = grids.ieee14()
    g2 = parse_case(_grid_to_case_text(g))
    assert g2.n_bus == g.n_bus and g2.n_branch == g.n_branch
    for name in ("f", "t", "bus_type"):
        np.testing.assert_array_equal(getattr(g2, name), getattr(g, name))
    for name in ("r", "x", "b", "pd", "qd", "pg", "gs", "bs", "vm0"):
        np.testing.assert_allclose(getattr(g2, name), getattr(g, name),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(np.abs(g2.tap), np.abs(np.asarray(g.tap)),
                               rtol=1e-12)
    Y1 = grids.ybus(g)[0]
    Y2 = grids.ybus(g2)[0]
    np.testing.assert_allclose(np.asarray(Y2.todense()),
                               np.asarray(Y1.todense()), atol=1e-12)


def test_load_case_file(tmp_path):
    p = tmp_path / "case3.m"
    p.write_text(CASE3)
    g = load_case(p)
    assert g.n_bus == 3


def test_powerflow_on_parsed_case():
    """A parsed case runs through the solver chain end to end."""
    from csparse3_jax.models.powerflow import newton_raphson

    g = parse_case(CASE3)
    vm, va, iters, resid = newton_raphson(g)
    assert resid < 1e-10
    # power balance at the PQ bus: |S_calc - S_spec| ~ 0
    Y = grids.ybus(g)[0]
    v = vm * np.exp(1j * va)
    s_calc = v * np.conj(Y.to_scipy() @ v)
    s_spec = (g.pg - g.pd) + 1j * (-g.qd)
    pq = g.pq
    assert np.abs(s_calc[pq] - s_spec[pq]).max() < 1e-8


def test_missing_matrix_raises():
    with pytest.raises(ValueError):
        parse_case("mpc.baseMVA = 100;\n")
