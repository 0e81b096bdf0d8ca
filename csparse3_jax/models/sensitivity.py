"""Linear DC sensitivity factors: PTDF, LODF, and LODF-based N-1 screening.

The reference library is the sparse engine under GridCal-class tools
(SURVEY "What the reference is"); PTDF/LODF screening is the standard
linear contingency-analysis workload those tools run on top of exactly
this kind of B'-matrix factorization (reference breadcrumb: the library's
intended use is `Ybus . V = I` solves, SURVEY scope note / csc.py:354-420
matvec paths).  Nothing here translates reference code — the reference has
no sensitivity layer; this is the device capability the solves exist
to serve.

Device shape of the computation:

* **PTDF** ``H = Bf . B_r^{-1}`` is computed as one multi-RHS solve
  ``B_r X = Bf_r^T`` through the level-scheduled device ``SolvePlan``
  (the BASELINE config-3/4 1024-RHS shape), chunked over branch columns.
* **LODF** is pure dense algebra on H (gathers + a rank-1 correction
  denominator) — one fused XLA kernel.
* **Screening** post-outage flows are a broadcasted axpy
  ``F_k = F0 + LODF[:, k] * F0[k]`` — a single (K, m) elementwise kernel,
  thousands of scenarios per millisecond; this is why production tools
  screen with LODF and only re-solve the violations (here:
  ``DCContingency`` for the re-solve).

Conventions: flows are in the from->to direction in p.u.; the slack bus
absorbs injection imbalance (PTDF columns at slack buses are 0).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..linalg import splu
from ..ops import construct
from .grids import SLACK, Grid

__all__ = ["ptdf", "lodf", "LinearContingency"]


def _reduced_susceptance(grid: Grid):
    """B' with slack rows/cols removed, plus the keep/reduction maps.

    Same assembly as ``DCContingency`` (models/contingency.py): branch
    susceptance 1/x stamped as a graph Laplacian.
    """
    n = grid.n_bus
    f, t = grid.f, grid.t
    bsus = 1.0 / np.asarray(grid.x, dtype=np.float64)
    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([t, f, f, t])
    vals = np.concatenate([-bsus, -bsus, bsus, bsus])
    B = construct.from_triplets(rows, cols, vals, (n, n))
    keep = np.flatnonzero(np.asarray(grid.bus_type) != SLACK)
    red = np.full(n, -1, dtype=np.int64)
    red[keep] = np.arange(len(keep))
    return B[keep, keep], keep, red, bsus


def ptdf(grid: Grid, branches=None, ordering="auto", chunk: int = 1024,
         dtype=np.float64):
    """Power Transfer Distribution Factors.

    ``H[l, i]`` = sensitivity of the flow on branch ``l`` (from->to) to a
    1 p.u. injection at bus ``i`` (withdrawn at the slack).  Shape
    ``(len(branches), n_bus)``; columns at slack buses are exactly 0.

    ``branches`` — monitored subset (default: all).  ``chunk`` — RHS
    columns per device solve (the multi-RHS batch size).
    """
    m = grid.n_branch
    branches = (np.arange(m) if branches is None
                else np.asarray(branches, dtype=np.int64))
    if branches.size and (branches.min() < 0 or branches.max() >= m):
        raise IndexError("branch index out of range")
    Br, keep, red, bsus = _reduced_susceptance(grid)
    # B' is a (regularized-by-reduction) diagonally dominant Laplacian:
    # the RCM no-pivot banded factorization + block-Thomas matmul sweeps
    # handle the 1024-wide RHS batches at matmul speed, where the
    # level-scheduled scalar plan is gather-bound
    plan = None
    if ordering in ("auto", "rcm"):
        try:
            lu0 = splu(Br, ordering="rcm", tol=0.0)
            # a grid that breaks B' diagonal dominance (series
            # compensation, 1/x < 0) can hit a zero/tiny no-pivot pivot
            # that is reported (or silently infs) rather than raised —
            # only a numerically sound factorization may skip pivoting
            if lu0.is_singular or not (
                    np.isfinite(np.asarray(lu0._h.Lx)).all()
                    and np.isfinite(np.asarray(lu0._h.Ux)).all()):
                raise ValueError("no-pivot factorization unstable")
            plan = lu0.banded_solve_plan()
        except (ValueError, np.linalg.LinAlgError) as e:
            # expected fallbacks only (stability/bandwidth checks); any
            # other exception is a real bug and must propagate instead
            # of silently degrading to the scalar level-scheduled plan
            import warnings

            warnings.warn(
                f"ptdf: banded fast path unavailable ({e}); falling "
                "back to the level-scheduled solve plan", stacklevel=2)
            plan = None
    if plan is None:
        lu = splu(Br, ordering=ordering)
        plan = lu.solve_plan()
    nb = len(keep)

    # B' is symmetric, so row l of H over kept buses is
    # x_l = B_r^{-1} rhs_l with rhs_l = (e_f - e_t) b_l  (reduced).
    rf = red[np.asarray(grid.f)[branches]]
    rt = red[np.asarray(grid.t)[branches]]
    bl = bsus[branches]

    H = np.zeros((len(branches), grid.n_bus), dtype=dtype)
    solve = jax.jit(lambda B: plan(B))
    for s in range(0, len(branches), chunk):
        e = min(s + chunk, len(branches))
        rhs = np.zeros((nb, e - s), dtype=dtype)
        cols = np.arange(e - s)
        lf, lt = rf[s:e], rt[s:e]
        livef, livet = lf >= 0, lt >= 0
        rhs[lf[livef], cols[livef]] += bl[s:e][livef]
        np.subtract.at(rhs, (lt[livet], cols[livet]), bl[s:e][livet])
        X = np.asarray(solve(jnp.asarray(rhs)))
        H[s:e, keep] = X.T
    return H


def lodf(grid: Grid, H=None, ordering="auto", tol: float = 1e-8):
    """Line Outage Distribution Factors.

    ``L[l, k]`` = fraction of branch ``k``'s pre-outage flow that shifts
    onto branch ``l`` when ``k`` trips.  ``L[k, k] = -1``.  Returns
    ``(L, ok)`` where ``ok[k]`` is False when tripping ``k`` islands the
    grid (the transfer denominator ``1 - PTDF_kk`` vanishes); the
    corresponding LODF column is zeroed (flows there are meaningless).

    Pass a precomputed full ``H = ptdf(grid)`` to reuse it.
    """
    if H is None:
        H = ptdf(grid, ordering=ordering)
    m = grid.n_branch
    if H.shape != (m, grid.n_bus):
        raise ValueError("H must be the full (n_branch, n_bus) PTDF")
    f = np.asarray(grid.f)
    t = np.asarray(grid.t)
    # Hbr[l, k] = flow change on l per unit pair-injection at k's terminals
    Hbr = H[:, f] - H[:, t]
    denom = 1.0 - np.diagonal(Hbr)
    ok = np.abs(denom) > tol
    safe = np.where(ok, denom, 1.0)
    L = Hbr / safe[None, :]
    L[:, ~ok] = 0.0
    np.fill_diagonal(L, -1.0)
    L[~ok, ~ok] = 0.0
    return L, ok


class LinearContingency:
    """LODF-based N-1 screening: ``flows_k = F0 + LODF[:, k] * F0[k]``.

    The linear-screening companion to ``DCContingency`` (which re-solves
    each scenario by device refactorization): exact for DC flows, O(m) per
    scenario after the one-time PTDF build, and embarrassingly scenario-
    parallel.  ``run``/``run_sharded`` mirror the ``DCContingency`` API
    and return ``(flows, ok)``.
    """

    def __init__(self, grid: Grid, ordering="auto", tol: float = 1e-8):
        self.grid = grid
        H = ptdf(grid, ordering=ordering)
        L, ok = lodf(grid, H=H, tol=tol)
        P = np.asarray(grid.pg) - np.asarray(grid.pd)
        # base flows directly from the PTDF: F0 = H P
        self.base_flows = H @ P
        self.H = H
        self.lodf = L
        self._ok = ok
        self._run = None

    @property
    def n_branch(self) -> int:
        return self.grid.n_branch

    def _build_run(self):
        L = jnp.asarray(self.lodf)
        F0 = jnp.asarray(self.base_flows)

        def run(ks):
            # (K, m): outage k shifts F0[k] through LODF column k
            fl = F0[None, :] + L[:, ks].T * F0[ks][:, None]
            fl = fl.at[jnp.arange(ks.shape[0]), ks].set(0.0)
            return fl

        self._run_raw = run
        return jax.jit(run)

    def run(self, outages=None):
        """Screen ``outages`` (default: every branch).  Returns
        ``(flows (K, n_branch), ok (K,))``; ``ok`` False = islanding
        outage (its flow row is not meaningful)."""
        if outages is None:
            outages = np.arange(self.n_branch)
        outages = np.asarray(outages, dtype=np.int64)
        if outages.size and (outages.min() < 0
                             or outages.max() >= self.n_branch):
            raise IndexError("outage branch index out of range")
        if len(outages) == 0:
            return np.zeros((0, self.n_branch)), np.zeros(0, dtype=bool)
        if self._run is None:
            self._run = self._build_run()
        flows = np.asarray(self._run(jnp.asarray(outages)))
        return flows, self._ok[outages]

    def run_sharded(self, mesh, outages=None, axis: str | None = None):
        """Scenario-data-parallel screening over a mesh axis (the outage
        list shards, LODF/base flows replicate — zero communication)."""
        from jax.sharding import NamedSharding, PartitionSpec

        if outages is None:
            outages = np.arange(self.n_branch)
        outages = np.asarray(outages, dtype=np.int64)
        if outages.size and (outages.min() < 0
                             or outages.max() >= self.n_branch):
            raise IndexError("outage branch index out of range")
        if len(outages) == 0:
            return np.zeros((0, self.n_branch)), np.zeros(0, dtype=bool)
        axis = axis or mesh.axis_names[0]
        S = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        K = len(outages)
        pad = (-K) % S
        ks = np.concatenate([outages, np.full(pad, outages[0])])
        shard = NamedSharding(mesh, PartitionSpec(axis))
        if self._run is None:
            self._run = self._build_run()
        fl = jax.jit(self._run_raw, in_shardings=shard,
                     out_shardings=shard)(
            jax.device_put(jnp.asarray(ks), shard))
        return np.asarray(fl)[:K], self._ok[outages]
