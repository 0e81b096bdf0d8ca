"""DC weighted-least-squares state estimation with bad-data detection.

State estimation is the other canonical workload (besides power flow /
contingency) that GridCal-class tools run on exactly the matrix stack the
reference provides (SURVEY "What the reference is": the library exists to
serve power-systems solvers).  The reference itself has no estimation
layer; this is new capability built from this framework's own kernels:

* the measurement Jacobian H is assembled sparse with one sort-based
  ``from_triplets`` (the vectorized LilMat-insertion replacement),
* the gain matrix ``G = H^T W H`` comes from the fused native gram kernel
  (``ops.spgemm.gram`` — G is exactly a weighted Gram matrix),
* G is SPD on observable systems, so it factors with sparse LDL^T
  (``linalg.ldlt``) — the symmetric factorization exists for precisely
  this normal-equations shape,
* normalized-residual bad-data analysis needs ``diag(H G^{-1} H^T)``,
  computed as one chunked multi-RHS device solve (the BASELINE config-3
  1024-RHS shape) — the same pattern as ``models.sensitivity.ptdf``.

Measurement model (DC): z = H theta + e with theta the non-slack bus
angles.  Supported measurement kinds: active branch flows (from->to),
active bus injections, and direct angle measurements (PMU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..linalg import ldlt
from ..ops import construct, spgemm
from ..types import CSC
from .grids import SLACK, Grid

__all__ = ["DCMeasurements", "SEResult", "dc_state_estimation",
           "largest_normalized_residual"]


class DCMeasurements(NamedTuple):
    """Measurement set for DC WLS.  Each field is (index array, value
    array, sigma array); any may be empty.  Indices: branches for flows,
    buses for injections/angles."""

    flow_idx: np.ndarray
    flow_val: np.ndarray
    flow_sigma: np.ndarray
    inj_idx: np.ndarray
    inj_val: np.ndarray
    inj_sigma: np.ndarray
    ang_idx: np.ndarray
    ang_val: np.ndarray
    ang_sigma: np.ndarray

    @classmethod
    def build(cls, flows=None, injections=None, angles=None):
        """Each argument: (indices, values, sigmas) or None."""
        def un(x):
            if x is None:
                return (np.zeros(0, np.int64), np.zeros(0), np.zeros(0))
            i, v, s = x
            i = np.asarray(i, dtype=np.int64)
            v = np.asarray(v, dtype=np.float64)
            s = np.broadcast_to(np.asarray(s, dtype=np.float64), v.shape)
            if not (i.shape == v.shape == s.shape):
                raise ValueError("index/value/sigma shapes differ")
            if (s <= 0).any():
                raise ValueError("sigmas must be positive")
            return i, v, np.asarray(s)

        f, j, a = un(flows), un(injections), un(angles)
        return cls(*f, *j, *a)

    @property
    def size(self) -> int:
        return len(self.flow_idx) + len(self.inj_idx) + len(self.ang_idx)


class SEResult(NamedTuple):
    theta: np.ndarray          # estimated bus angles (slack = 0), (n_bus,)
    residuals: np.ndarray      # z - H theta_hat, measurement order
    chi2: float                # sum of weighted squared residuals
    dof: int                   # measurements - states
    H: object                  # sparse measurement Jacobian (CSC, M x nb)
    G: object                  # gain matrix H^T W H (CSC, nb x nb)
    weights: np.ndarray        # 1/sigma^2, measurement order
    keep: np.ndarray           # non-slack bus indices (state ordering)
    factor: object             # SparseLDLT of G


def _jacobian(grid: Grid, meas: DCMeasurements, keep, red):
    """Sparse H (M x nb) over reduced angles, rows in measurement order
    (flows, injections, angles)."""
    bsus = 1.0 / np.asarray(grid.x, dtype=np.float64)
    f, t = np.asarray(grid.f), np.asarray(grid.t)
    rows_l, cols_l, vals_l = [], [], []
    r0 = 0

    li = meas.flow_idx
    if li.size:
        if li.min() < 0 or li.max() >= grid.n_branch:
            raise IndexError("flow measurement branch index out of range")
        r = np.arange(len(li)) + r0
        for end, sgn in ((red[f[li]], +1.0), (red[t[li]], -1.0)):
            live = end >= 0
            rows_l.append(r[live])
            cols_l.append(end[live])
            vals_l.append(sgn * bsus[li][live])
    r0 += len(li)

    bi = meas.inj_idx
    if bi.size:
        if bi.min() < 0 or bi.max() >= grid.n_bus:
            raise IndexError("injection measurement bus index out of range")
        # row for bus i: B'(i, :) = sum_l b_l (e_f - e_t)(e_f - e_t)^T row i
        for bus_end, oth_end in ((f, t), (t, f)):
            # branches whose `bus_end` is a measured bus contribute
            sel = np.flatnonzero(np.isin(bus_end, bi))
            if not len(sel):
                continue
            # map branch endpoint -> measurement row(s): a bus may be
            # measured once (indices unique per build contract)
            order = np.argsort(bi, kind="stable")
            pos = np.searchsorted(bi[order], bus_end[sel])
            r = order[pos] + r0
            # diagonal term: +b at the measured bus
            rows_l.append(r)
            cols_l.append(red[bus_end[sel]])
            vals_l.append(bsus[sel])
            # off-diagonal: -b at the other endpoint
            rows_l.append(r)
            cols_l.append(red[oth_end[sel]])
            vals_l.append(-bsus[sel])
    r0 += len(bi)

    ai = meas.ang_idx
    if ai.size:
        if ai.min() < 0 or ai.max() >= grid.n_bus:
            raise IndexError("angle measurement bus index out of range")
        rows_l.append(np.arange(len(ai)) + r0)
        cols_l.append(red[ai])
        vals_l.append(np.ones(len(ai)))
    r0 += len(ai)

    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0)
    live = cols >= 0  # slack-column entries vanish
    return construct.from_triplets(rows[live], cols[live], vals[live],
                                   (r0, len(keep)))


def dc_state_estimation(grid: Grid, meas: DCMeasurements,
                        ordering="amd") -> SEResult:
    """Solve the DC WLS normal equations ``(H^T W H) theta = H^T W z``.

    Raises ``ValueError`` when the system is unobservable (the gain matrix
    is singular — some state is not covered by any measurement path).
    """
    if meas.inj_idx.size and len(np.unique(meas.inj_idx)) != len(meas.inj_idx):
        raise ValueError("duplicate injection measurements at one bus; "
                         "combine them (average, sigma/sqrt(k)) first")
    n = grid.n_bus
    keep = np.flatnonzero(np.asarray(grid.bus_type) != SLACK)
    red = np.full(n, -1, dtype=np.int64)
    red[keep] = np.arange(len(keep))
    M = meas.size
    if M < len(keep):
        raise ValueError(
            f"underdetermined: {M} measurements for {len(keep)} states")

    H = _jacobian(grid, meas, keep, red)
    z = np.concatenate([meas.flow_val, meas.inj_val, meas.ang_val])
    sig = np.concatenate([meas.flow_sigma, meas.inj_sigma, meas.ang_sigma])
    w = 1.0 / sig**2

    # G = B^T B with B = sqrt(W) H, via the fused gram kernel on B^T.
    # Scaling/matvecs stay in host f64 (device dtype may be f32;
    # normal equations square the condition number — keep the estimate
    # exact and leave device work to the batched bad-data solves).
    ip, ix, dt = H.np_arrays()
    nb = len(keep)
    Bt = CSC(M, nb, ip, ix, dt * np.sqrt(w)[ix]).t()
    G = spgemm.gram(Bt)
    cols = construct.expand_indptr_np(ip)
    rhs = np.bincount(cols, weights=dt * (w * z)[ix], minlength=nb)

    fac = ldlt(G, ordering=ordering)
    if fac.is_singular:
        raise ValueError("unobservable system: gain matrix is singular "
                         f"(pivot failure at columns {fac.singular_cols[:8]})")
    th_r = fac.solve_host(rhs)

    r = z - np.bincount(ix, weights=dt * th_r[cols], minlength=M)
    theta = np.zeros(n)
    theta[keep] = th_r
    chi2 = float(np.sum(w * r * r))
    return SEResult(theta, r, chi2, M - len(keep), H, G, w, keep, fac)


def largest_normalized_residual(res: SEResult, chunk: int = 1024):
    """Bad-data identification: normalized residuals
    ``r_j / sqrt(Omega_jj)`` with ``Omega = R - H G^{-1} H^T`` (the
    residual covariance).  Returns ``(j_max, rN)`` — the suspect
    measurement index and the full normalized-residual vector.
    ``j_max`` is -1 when every measurement is critical (all rN zero):
    there is no validated suspect in that case.

    ``diag(H G^{-1} H^T)`` is one chunked multi-RHS solve against the
    already-computed LDL^T factor (device), never a dense inverse.
    """
    H, fac, w = res.H, res.factor, res.weights
    ip, ix, dt = H.np_arrays()
    M, nb = H.shape
    cols = construct.expand_indptr_np(ip)
    S = np.zeros(M)
    plan = fac.solve_plan()
    solve = jax.jit(lambda B: plan(B))
    Ht = H.t()
    tp, ti, tx = Ht.np_arrays()  # CSC of H^T: column j = measurement row j
    for s in range(0, M, chunk):
        e = min(s + chunk, M)
        rhs = np.zeros((nb, e - s))
        seg = slice(tp[s], tp[e])
        rhs[ti[seg], construct.expand_indptr_np(tp[s:e + 1] - tp[s])] = tx[seg]
        X = np.asarray(solve(jnp.asarray(rhs)))  # G^{-1} H^T chunk
        # S_j = h_j . X[:, j]
        S[s:e] = np.einsum("ij,ij->j", rhs, X)
    omega = 1.0 / w - S
    # numerical floor: critical (redundancy-1) measurements have omega ~ 0
    # and their residual is identically 0 — they cannot be validated
    ok = omega > 1e-10 / w
    rN = np.zeros(M)
    rN[ok] = np.abs(res.residuals[ok]) / np.sqrt(omega[ok])
    # all measurements critical (every rN == 0): no suspect — argmax would
    # silently present measurement 0 with no signal behind it
    if not rN.size or rN.max() == 0.0:
        return -1, rN
    return int(np.argmax(rN)), rN
