"""Power-flow solvers — the flagship workload (GridCal's use of the
reference library: solving Ybus-based power-flow systems, SURVEY scope
note).

Three solver families, all built on the framework's own kernels:

* ``dc_power_flow``   — linear B·theta = P, one LU factor + solve.
* ``FastDecoupled``   — FDXB fast-decoupled AC power flow: two constant
                        matrices B' / B'' factored ONCE on host, then every
                        iteration is {complex SpMV, two level-scheduled
                        triangular solves} — fully jittable, the
                        factor-once/solve-many pattern the device design
                        optimizes for (BASELINE configs 3-4).
* ``newton_raphson``  — full Newton with the exact sparse Jacobian
                        assembled from Ybus entry streams (fixed pattern,
                        device values); host refactorization per iteration.

Batched scenario solves (``FastDecoupled.solve_batch``) run many load
profiles against one factorization — the 1024-RHS benchmark shape.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..linalg import splu
from ..ops import construct, matvec
from ..types import CSC
from .grids import PQ, PV, SLACK, Grid, ybus

__all__ = [
    "sbus", "dc_power_flow", "FastDecoupled", "newton_raphson",
    "NewtonPowerFlow",
]


def sbus(grid: Grid):
    """Complex power injections (generation - load) per bus."""
    return (grid.pg - grid.pd) - 1j * grid.qd


def _make_yplan(Y, spmv):
    """Split-complex Ybus SpMV plan.

    'ell'        — gather-based SpMVPlan (the default)
    'dia'        — gather-free banded slabs (pair with models.grids.rcm_grid)
    'symdia'     — like 'dia' but stores only the upper diagonals; Ybus is
                   complex symmetric when taps are real (no phase
                   shifters), halving slab traffic. Raises if Y is not
                   symmetric.
    """
    if spmv == "ell":
        return matvec.SplitSpMV(Y)
    if spmv == "dia":
        return matvec.SplitDIA(Y)
    if spmv == "symdia":
        return matvec.SplitSymDIA(Y, tol=1e-12)
    raise ValueError(f"unknown spmv plan {spmv!r}: "
                     "expected 'ell', 'dia' or 'symdia'")


# ---------------------------------------------------------------------------
# DC power flow
# ---------------------------------------------------------------------------

def dc_power_flow(grid: Grid, ordering="auto"):
    """theta = B^{-1} P with the slack row/column removed; returns bus
    angles (radians, slack = 0)."""
    n = grid.n_bus
    bsus = 1.0 / grid.x
    f, t = grid.f, grid.t
    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([f, t, t, f])
    vals = np.concatenate([bsus, bsus, -bsus, -bsus])
    B = construct.from_triplets(rows, cols, vals, (n, n))
    keep = np.flatnonzero(grid.bus_type != SLACK)
    Br = B[keep, keep]
    P = (grid.pg - grid.pd)[keep]
    lu = splu(Br, ordering=ordering)
    th = np.zeros(n)
    th[keep] = np.asarray(lu.solve(P))
    return th


# ---------------------------------------------------------------------------
# Fast-decoupled power flow (XB scheme)
# ---------------------------------------------------------------------------

class FastDecoupled:
    """Factor-once fast-decoupled AC power flow.

    Construction does the host work (Ybus, B', B'' assembly + two LU
    factorizations); ``step``/``run`` are pure jax on device.
    """

    def __init__(self, grid: Grid, ordering="auto", tol=1e-8, max_iter=50,
                 spmv="ell", solver="level"):
        """spmv: 'ell' (gather-based; CPU/GPU-friendly), 'dia'
        (gather-free banded slabs — reorder the grid with
        models.grids.rcm_grid first so Ybus is banded), or 'symdia'
        (dia with only the upper diagonals stored; valid when Ybus is
        complex symmetric, i.e. no phase shifters).
        solver: 'level' (level-scheduled TriSolvePlan), 'banded'
        (block-bidiagonal matmul sweeps over the sparse factors; factors
        with ordering='rcm', tol=0), or 'blocklu' (linalg.BandedLU block
        Thomas — no sparse factorization at all; the fast path at
        >=50k buses where the scalar no-exchange factor dominates
        build time)."""
        self.grid = grid
        self.tol = tol
        self.max_iter = max_iter
        n = grid.n_bus
        self.Y, _, _ = ybus(grid)
        self.pvpq = np.concatenate([grid.pv, grid.pq])
        self.pq = grid.pq
        self.slack = grid.slack

        # B': series susceptance only (r=0, b=0, tap=1), slack removed
        bp = 1.0 / grid.x
        f, t = grid.f, grid.t
        rows = np.concatenate([f, t, f, t])
        cols = np.concatenate([f, t, t, f])
        vals = np.concatenate([bp, bp, -bp, -bp])
        Bp_full = construct.from_triplets(rows, cols, vals, (n, n))
        Bp = Bp_full[self.pvpq, self.pvpq]

        # B'': -imag(Ybus) on PQ buses
        ipY, ixY, dtY = self.Y.np_arrays()
        colsY = np.repeat(np.arange(n), np.diff(ipY))
        Bpp_full = construct.from_triplets(ixY, colsY, -dtY.imag, (n, n))
        Bpp = Bpp_full[self.pq, self.pq]

        if solver == "blocklu":
            from ..linalg import BandedLU

            self.lu_bp = self._bp_plan = BandedLU(Bp)
            self.lu_bpp = self._bpp_plan = BandedLU(Bpp)
        elif solver == "banded":
            self.lu_bp = splu(Bp, ordering="rcm", tol=0.0)
            self.lu_bpp = splu(Bpp, ordering="rcm", tol=0.0)
            self._bp_plan = self.lu_bp.banded_solve_plan()
            self._bpp_plan = self.lu_bpp.banded_solve_plan()
        else:
            self.lu_bp = splu(Bp, ordering=ordering)
            self.lu_bpp = splu(Bpp, ordering=ordering)
            self._bp_plan = self.lu_bp.solve_plan()
            self._bpp_plan = self.lu_bpp.solve_plan()
        # split-complex Ybus action: all device arithmetic is REAL pairs
        # (split-complex real pairs; see ops.matvec.SplitSpMV / SplitDIA)
        self._yplan = _make_yplan(self.Y, spmv)
        sb = sbus(grid)
        self._sbr = jnp.asarray(sb.real)
        self._sbi = jnp.asarray(sb.imag)
        self._vm0 = jnp.asarray(grid.vm0)
        self._pvpq_j = jnp.asarray(self.pvpq)
        self._pq_j = jnp.asarray(self.pq)

    # -- jittable pieces ----------------------------------------------------
    def mismatch(self, vm, va, sbr=None, sbi=None):
        """Power mismatch dS = (S(V) - Sbus) / Vm as (real, imag) parts."""
        sbr = self._sbr if sbr is None else sbr
        sbi = self._sbi if sbi is None else sbi
        vr = vm * jnp.cos(va)
        vi = vm * jnp.sin(va)
        yr, yi = self._yplan(vr, vi)
        # s = v * conj(Y v)
        sr = vr * yr + vi * yi
        si = vi * yr - vr * yi
        return (sr - sbr) / vm, (si - sbi) / vm

    def step(self, carry):
        """One P-theta / Q-V half-iteration pair (jittable)."""
        vm, va, sbr, sbi = carry
        mr, _ = self.mismatch(vm, va, sbr, sbi)
        dva = -self._bp_plan(mr[self._pvpq_j])
        va = va.at[self._pvpq_j].add(dva)
        _, mi = self.mismatch(vm, va, sbr, sbi)
        dvm = -self._bpp_plan(mi[self._pq_j])
        vm = vm.at[self._pq_j].add(dvm)
        return (vm, va, sbr, sbi)

    def residual(self, vm, va, sbr=None, sbi=None):
        mr, mi = self.mismatch(vm, va, sbr, sbi)
        r = jnp.concatenate([mr[self._pvpq_j], mi[self._pq_j]])
        return jnp.max(jnp.abs(r)) if r.shape[0] else jnp.zeros((), vm.dtype)

    # -- functional export (state as explicit pytree, not closures) ---------
    @property
    def plans(self):
        """All device state as one pytree — pass to ``functional_step`` so
        jitted callers carry the solver state as *arguments* instead of
        trace-time closure constants."""
        return (
            self._bp_plan, self._bpp_plan, self._yplan,
            self._pvpq_j, self._pq_j,
        )

    @staticmethod
    def functional_step(plans, vm, va, sbr, sbi):
        """Pure-function twin of ``step`` (same math, no self capture)."""
        bp_plan, bpp_plan, yplan, pvpq, pq = plans

        def mismatch(vm, va):
            vr = vm * jnp.cos(va)
            vi = vm * jnp.sin(va)
            yr, yi = yplan(vr, vi)
            sr = vr * yr + vi * yi
            si = vi * yr - vr * yi
            return (sr - sbr) / vm, (si - sbi) / vm

        mr, _ = mismatch(vm, va)
        va = va.at[pvpq].add(-bp_plan(mr[pvpq]))
        _, mi = mismatch(vm, va)
        vm = vm.at[pq].add(-bpp_plan(mi[pq]))
        return vm, va

    @partial(jax.jit, static_argnums=0)
    def run(self, vm0, va0, sbr, sbi):
        """Full solve under jit: while_loop until tol or max_iter."""

        def cond(state):
            (vm, va, sr, si), it = state
            return jnp.logical_and(self.residual(vm, va, sr, si) > self.tol,
                                   it < self.max_iter)

        def body(state):
            carry, it = state
            return self.step(carry), it + 1

        (vm, va, _, _), iters = jax.lax.while_loop(
            cond, body, ((vm0, va0, sbr, sbi), 0)
        )
        return vm, va, iters

    def solve(self, flat_start=True):
        n = self.grid.n_bus
        vm0 = self._vm0
        va0 = jnp.zeros(n)
        vm, va, iters = self.run(vm0, va0, self._sbr, self._sbi)
        res = float(self.residual(vm, va))
        return np.asarray(vm), np.asarray(va), int(iters), res

    def solve_batch(self, sb_batch):
        """Solve many scenarios (k, n) against the single factorization —
        vmapped run (BASELINE config 4 shape)."""
        n = self.grid.n_bus
        k = sb_batch.shape[0]
        sb_batch = np.asarray(sb_batch)
        vm0 = jnp.broadcast_to(self._vm0, (k, n))
        va0 = jnp.zeros((k, n))
        return jax.vmap(self.run)(
            vm0, va0, jnp.asarray(sb_batch.real), jnp.asarray(sb_batch.imag)
        )


# ---------------------------------------------------------------------------
# Newton-Raphson with exact sparse Jacobian
# ---------------------------------------------------------------------------

def _jacobian(Y: CSC, v, ibus, pvpq, pq):
    """Sparse power-flow Jacobian from Ybus entry streams (fixed pattern).

    dS/dVa (i,k) = j V_i (delta_ik conj(I_i) - conj(y_ik) conj(V_k))
    dS/dVm (i,k) = V_i conj(y_ik) conj(V_k)/|V_k| + delta_ik conj(I_i) V_i/|V_i|
    """
    # host path: np_arrays uses the host cache — the lazy device
    # properties would round-trip the complex Ybus through the device
    ip, rows, y = Y.np_arrays()
    ip = np.asarray(ip)
    cols = np.repeat(np.arange(Y.n), np.diff(ip))
    v = np.asarray(v)
    ibus = np.asarray(ibus)
    vm = np.abs(v)

    dva = -1j * v[rows] * np.conj(y) * np.conj(v[cols])
    dvm = v[rows] * np.conj(y) * np.conj(v[cols]) / vm[cols]
    diag = rows == cols
    dva[diag] += 1j * v[rows[diag]] * np.conj(ibus[rows[diag]])
    dvm[diag] += np.conj(ibus[rows[diag]]) * v[rows[diag]] / vm[rows[diag]]

    n = Y.n
    # index maps: bus id -> position in pvpq / pq (or -1)
    pos_pvpq = np.full(n, -1)
    pos_pvpq[pvpq] = np.arange(len(pvpq))
    pos_pq = np.full(n, -1)
    pos_pq[pq] = np.arange(len(pq))

    npvpq, npq = len(pvpq), len(pq)
    blocks = []
    # J11 = real(dSdVa)[pvpq, pvpq]
    for vals, rsel, csel, roff, coff, part in [
        (dva, pos_pvpq, pos_pvpq, 0, 0, np.real),
        (dvm, pos_pvpq, pos_pq, 0, npvpq, np.real),
        (dva, pos_pq, pos_pvpq, npvpq, 0, np.imag),
        (dvm, pos_pq, pos_pq, npvpq, npvpq, np.imag),
    ]:
        keep = (rsel[rows] >= 0) & (csel[cols] >= 0)
        blocks.append((
            rsel[rows[keep]] + roff,
            csel[cols[keep]] + coff,
            part(vals[keep]),
        ))
    jr = np.concatenate([b[0] for b in blocks])
    jc = np.concatenate([b[1] for b in blocks])
    jv = np.concatenate([b[2] for b in blocks])
    dim = npvpq + npq
    return construct.from_triplets(jr, jc, jv, (dim, dim))


@jax.tree_util.register_pytree_node_class
class NewtonPowerFlow:
    """Fully-jittable Newton power flow.

    The Jacobian PATTERN is fixed by the Ybus pattern, so: factor it once
    on host (symbolic + pivoting), then every Newton iteration runs on
    device — Jacobian values assembled from Ybus entry streams, numeric
    refactorization via linalg.RefactorPlan (KLU-style), level-scheduled
    solve, state update — inside one ``lax.while_loop``.  No host
    round-trip per iteration, unlike ``newton_raphson`` (the host
    reference implementation kept below).

    The class is a registered pytree: pass the instance to
    ``jax.jit(NewtonPowerFlow.run_fn)`` as an ARGUMENT so the plan's
    index maps enter the program as operands — ``run`` (static self)
    bakes them in as HLO literals, which at 10k nodes makes the program
    tens of MB and slows compilation.
    """

    def tree_flatten(self):
        ch = (self._rp, self._yplan, self._sbr, self._sbi, self._y_rows,
              self._y_cols, self._ygr, self._ygi, self._diag_mask,
              tuple(self._keep), self._perm, self._pvpq, self._pq)
        aux = (self.tol, self.max_iter, self._npvpq,
               self.growth_limit, self.piv_rtol)
        return ch, aux

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        (obj._rp, obj._yplan, obj._sbr, obj._sbi, obj._y_rows,
         obj._y_cols, obj._ygr, obj._ygi, obj._diag_mask, keep,
         obj._perm, obj._pvpq, obj._pq) = ch
        obj._keep = list(keep)
        (obj.tol, obj.max_iter, obj._npvpq,
         obj.growth_limit, obj.piv_rtol) = aux
        obj.grid = obj.Y = None  # host-only state, not needed in jit
        return obj

    def __init__(self, grid: Grid, tol=1e-10, max_iter=20, ordering="auto",
                 spmv="ell", solver="level",
                 growth_limit=1e7, piv_rtol=1e-10):
        """spmv: 'ell', 'dia' (gather-free banded slabs; pair with
        models.grids.rcm_grid so Ybus is banded), or 'symdia' (see
        FastDecoupled).
        solver: 'level' (KLU-style RefactorPlan + level-scheduled solve),
        'blocklu' (block-Thomas BandedRefactor: the Jacobian, RCM-
        reordered, refactors as dense matmul block recurrences — the
        scalable per-iteration path on banded grids), or 'multifrontal'
        (no-pivot ND factorization + MultifrontalRefactor: per-iteration
        refactorization as matmul extend-add fronts — static pivoting,
        the standard power-flow practice, so the Jacobian must factor
        stably without row exchanges)."""
        self.grid = grid
        self.tol = tol
        self.max_iter = max_iter
        # pivot-growth gate for the 'multifrontal' solver: within-front pivoting can't reach rows outside the
        # front, so a factorization whose element growth escapes that
        # legality class is flagged in-loop and the caller falls back
        # to a host factorization with TRUE partial pivoting (splu) —
        # the SuperLU info!=0 pattern (reference:
        # src/research/scipy_wrappers.py:7-10)
        self.growth_limit = float(growth_limit)
        self.piv_rtol = float(piv_rtol)
        n = grid.n_bus
        self.Y, _, _ = ybus(grid)
        self._yplan = _make_yplan(self.Y, spmv)
        sb = sbus(grid)
        self._sbr = jnp.asarray(sb.real)
        self._sbi = jnp.asarray(sb.imag)
        pvpq = np.concatenate([grid.pv, grid.pq])
        pq = grid.pq
        self._pvpq = jnp.asarray(pvpq)
        self._pq = jnp.asarray(pq)
        npvpq, npq = len(pvpq), len(pq)
        self._npvpq = npvpq

        # ---- fixed Jacobian structure from Ybus entry streams ------------
        ipY, ixY, dtY = self.Y.np_arrays()
        rows = ixY.astype(np.int64)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ipY))
        self._y_rows = jnp.asarray(rows)
        self._y_cols = jnp.asarray(cols)
        self._ygr = jnp.asarray(np.ascontiguousarray(dtY.real))
        self._ygi = jnp.asarray(np.ascontiguousarray(dtY.imag))
        self._diag_mask = jnp.asarray(rows == cols)

        pos_pvpq = np.full(n, -1)
        pos_pvpq[pvpq] = np.arange(npvpq)
        pos_pq = np.full(n, -1)
        pos_pq[pq] = np.arange(npq)

        keeps, jr_l, jc_l, segs = [], [], [], []
        for bi, (rsel, csel, roff, coff) in enumerate([
            (pos_pvpq, pos_pvpq, 0, 0),       # J11 real(dS/dVa)
            (pos_pvpq, pos_pq, 0, npvpq),     # J12 real(dS/dVm)
            (pos_pq, pos_pvpq, npvpq, 0),     # J21 imag(dS/dVa)
            (pos_pq, pos_pq, npvpq, npvpq),   # J22 imag(dS/dVm)
        ]):
            keep = np.flatnonzero((rsel[rows] >= 0) & (csel[cols] >= 0))
            keeps.append(keep)
            jr_l.append(rsel[rows[keep]] + roff)
            jc_l.append(csel[cols[keep]] + coff)
            segs.append(len(keep))
        jr = np.concatenate(jr_l)
        jc = np.concatenate(jc_l)
        dim = npvpq + npq
        # canonical-order permutation: J.data[i] = stream[perm[i]]
        perm = np.argsort(jc.astype(np.int64) * dim + jr, kind="stable")
        self._keep = [jnp.asarray(k) for k in keeps]
        self._perm = jnp.asarray(perm)
        self._segs = segs

        # host: factor the pattern once (values at flat start).  ibus0
        # is computed host-side — a device SpMV here cost a ~7 s
        # compile plus two device->host downloads on the critical build
        # path, for a product the host Ybus does in microseconds
        v0 = grid.vm0.astype(np.complex128)
        ibus0 = self.Y.to_scipy().tocsr() @ v0
        J0 = _jacobian(self.Y, v0, ibus0, pvpq, pq)
        if solver == "blocklu":
            from ..linalg import BandedLU

            self._rp = BandedLU(J0).refactor_plan(J0)
        elif solver == "multifrontal":
            # FROM-SCRATCH front-form LU with within-front partial
            # pivoting: no host pivot order to freeze (the r3 isfinite
            # hazard disappears — pivoting happens per iteration, on
            # device), and the front-form solve replaces the
            # level-scheduled scalar solve that dominated each Newton
            # iteration at 10k (measured 9.8 s -> ~0.3 s per solve)
            from ..linalg.multifrontal import MultifrontalLU

            self._rp = MultifrontalLU.from_matrix(
                J0, ordering="nd" if ordering == "auto" else ordering)
        else:
            lu = splu(J0, ordering=ordering)
            self._rp = lu.refactor_plan(J0)

    # -- device Jacobian values (fixed pattern, split-complex real math) ----
    def _jac_data(self, vr, vi, vm, ir, ii, ygr=None, ygi=None):
        """Real/imag parts of dS/dVa and dS/dVm per Ybus entry, expanded to
        real arithmetic (no complex dtypes on device):

          t = conj(y) conj(v_col);  dVa = -i v_row t (+ i v conj(I) on diag)
          dVm = v_row t / |v_col|   (+ conj(I) v/|v| on diag)
        """
        rows, cols = self._y_rows, self._y_cols
        gr = self._ygr if ygr is None else ygr
        gi = self._ygi if ygi is None else ygi
        vrr, vri = vr[rows], vi[rows]
        vcr, vci = vr[cols], vi[cols]
        t_r = gr * vcr - gi * vci
        t_i = -(gr * vci + gi * vcr)
        # p + iq = v_row * t
        p = vrr * t_r - vri * t_i
        q = vrr * t_i + vri * t_r
        dva_r, dva_i = q, -p
        dvm_r, dvm_i = p / vm[cols], q / vm[cols]
        irr, iir = ir[rows], ii[rows]
        dva_r = jnp.where(self._diag_mask, dva_r + vrr * iir - vri * irr, dva_r)
        dva_i = jnp.where(self._diag_mask, dva_i + vrr * irr + vri * iir, dva_i)
        dvm_r = jnp.where(
            self._diag_mask, dvm_r + (vrr * irr + vri * iir) / vm[rows], dvm_r
        )
        dvm_i = jnp.where(
            self._diag_mask, dvm_i + (vri * irr - vrr * iir) / vm[rows], dvm_i
        )
        stream = jnp.concatenate([
            dva_r[self._keep[0]],
            dvm_r[self._keep[1]],
            dva_i[self._keep[2]],
            dvm_i[self._keep[3]],
        ])
        # canonical-order permutation via the rowgather substrate: the
        # plain stream[perm] lowered to XLA's near-scalar gather and
        # traced at ~1.4 ms/iteration at 10k (197k elements)
        from ..ops.gather import rowgather

        return rowgather(stream, self._perm)

    def _mismatch_f(self, vm, va, sbr, sbi, ygr=None, ygi=None):
        vr = vm * jnp.cos(va)
        vi = vm * jnp.sin(va)
        if ygr is None:
            ir, ii = self._yplan(vr, vi)
        else:
            # per-scenario Ybus values (AC contingency): the SpMV plan has
            # the base values baked in, so compute I = Y v from the raw
            # entry streams instead (one fused segment-sum per part)
            rows, cols = self._y_rows, self._y_cols
            vcr, vci = vr[cols], vi[cols]
            n = vm.shape[0]
            ir = jnp.zeros(n, vr.dtype).at[rows].add(ygr * vcr - ygi * vci)
            ii = jnp.zeros(n, vr.dtype).at[rows].add(ygr * vci + ygi * vcr)
        mis_r = vr * ir + vi * ii - sbr
        mis_i = vi * ir - vr * ii - sbi
        f = jnp.concatenate([mis_r[self._pvpq], mis_i[self._pq]])
        return f, (vr, vi), (ir, ii)

    def run_fn(self, vm0, va0, sbr, sbi, ygr=None, ygi=None):
        """Solve to tolerance; returns (vm, va, iterations, residual,
        bad) where ``bad`` is True iff a 'multifrontal' factorization
        tripped the pivot-growth gate (the loop stops WITHOUT applying
        the suspect update; the caller must fall back to a true-pivoting
        host factorization — ``solve``/``solve_batch`` do).
        ``ygr/ygi`` override the Ybus entry values (same pattern) — the
        AC-contingency hook: vmap over per-scenario value arrays.

        Undecorated body: jit as ``jax.jit(NewtonPowerFlow.run_fn)``
        with the instance passed as a pytree argument (see class
        docstring), or use ``run`` (static self, convenient at small
        n)."""

        def cond(state):
            vm, va, it, bad = state
            f, _, _ = self._mismatch_f(vm, va, sbr, sbi, ygr, ygi)
            nrm = jnp.max(jnp.abs(f)) if f.shape[0] else jnp.zeros(())
            return jnp.logical_and(
                jnp.logical_and(nrm > self.tol, it < self.max_iter),
                jnp.logical_not(bad))

        from ..linalg.multifrontal import MultifrontalLU

        def body(state):
            vm, va, it, bad = state
            f, (vr, vi), (ir, ii) = self._mismatch_f(vm, va, sbr, sbi,
                                                     ygr, ygi)
            jd = self._jac_data(vr, vi, vm, ir, ii, ygr, ygi)
            if isinstance(self._rp, MultifrontalLU):
                fac, stats = self._rp.factor_piv(jd)
                dx = self._rp.solve_piv(fac, -f)
                # growth gate: within-front pivoting is restricted to
                # fully-summed rows; escape is detected as (a) a pivot
                # collapsing relative to the factor's magnitude, or
                # (b) element growth vs the input Jacobian beyond
                # growth_limit, or (c) non-finite factors
                scale = jnp.max(jnp.abs(jd)) + jnp.asarray(
                    np.finfo(np.float64).tiny, jd.dtype)
                bad_it = (
                    (stats["min_pivot"] < self.piv_rtol * stats["max_u"])
                    | (stats["max_u"] > self.growth_limit * scale)
                    | ~jnp.isfinite(stats["max_u"]))
                # a gated iteration must NOT corrupt the state with the
                # suspect direction
                dx = jnp.where(bad_it, jnp.zeros_like(dx), dx)
                bad = jnp.logical_or(bad, bad_it)
            else:
                plan = self._rp.refactor(jd)
                dx = plan(-f)
            va = va.at[self._pvpq].add(dx[: self._npvpq])
            vm = vm.at[self._pq].add(dx[self._npvpq :])
            return (vm, va, it + 1, bad)

        vm, va, it, bad = jax.lax.while_loop(
            cond, body, (vm0, va0, 0, jnp.zeros((), bool)))
        f, _, _ = self._mismatch_f(vm, va, sbr, sbi, ygr, ygi)
        res = jnp.max(jnp.abs(f)) if f.shape[0] else jnp.zeros(())
        return vm, va, it, res, bad

    run = partial(jax.jit, static_argnums=0)(run_fn)

    def _host_newton(self, vm, va, sb=None):
        """Continue Newton on host with TRUE partial pivoting (splu per
        iteration) from (vm, va) — the growth-gate fallback path."""
        import warnings

        vm = np.asarray(vm, np.float64).copy()
        va = np.asarray(va, np.float64).copy()
        if self.grid is None or self.Y is None:
            raise RuntimeError(
                "growth fallback needs the host-side grid/Ybus state "
                "(unavailable on an unflattened pytree copy)")
        warnings.warn(
            "multifrontal pivot-growth gate engaged: falling back to "
            "host factorization with true partial pivoting",
            RuntimeWarning, stacklevel=3)
        y_csr = self.Y.to_scipy().tocsr()
        sb = sbus(self.grid) if sb is None else sb
        pvpq = np.asarray(self._pvpq)
        pq = np.asarray(self._pq)
        it = 0
        nrm = np.inf
        for it in range(self.max_iter):
            v = vm * np.exp(1j * va)
            ibus = y_csr @ v
            mis = v * np.conj(ibus) - sb
            f = np.concatenate([mis.real[pvpq], mis.imag[pq]])
            nrm = np.max(np.abs(f)) if f.size else 0.0
            if nrm < self.tol:
                break
            J = _jacobian(self.Y, v, ibus, pvpq, pq)
            lu = splu(J, ordering="auto")   # true partial pivoting
            dx = np.asarray(lu.solve_host(-f))
            va[pvpq] += dx[: self._npvpq]
            vm[pq] += dx[self._npvpq:]
        return vm, va, it, nrm

    def solve(self, flat_start=True):
        n = self.grid.n_bus
        vm0 = jnp.asarray(self.grid.vm0.astype(np.float64))
        va0 = jnp.zeros(n)
        vm, va, it, res, bad = self.run(vm0, va0, self._sbr, self._sbi)
        if bool(bad):
            vm, va, it2, res = self._host_newton(vm, va)
            return np.asarray(vm), np.asarray(va), int(it) + int(it2), \
                float(res)
        return np.asarray(vm), np.asarray(va), int(it), float(res)

    def solve_batch(self, sb_batch):
        """Many load scenarios against one symbolic factorization —
        vmapped device Newton (every scenario refactors on device).
        Scenarios whose factorization trips the growth gate are
        re-solved on host with true partial pivoting."""
        n = self.grid.n_bus
        k = sb_batch.shape[0]
        sb_batch = np.asarray(sb_batch)
        vm0 = jnp.broadcast_to(jnp.asarray(self.grid.vm0.astype(np.float64)), (k, n))
        va0 = jnp.zeros((k, n))
        vm, va, it, res, bad = jax.vmap(self.run)(
            vm0, va0, jnp.asarray(sb_batch.real), jnp.asarray(sb_batch.imag)
        )
        bad_np = np.asarray(bad)
        if bad_np.any():
            vm = np.asarray(vm).copy()
            va = np.asarray(va).copy()
            it = np.asarray(it).copy()
            res = np.asarray(res).copy()
            for s in np.flatnonzero(bad_np):
                vms, vas, its, rs = self._host_newton(
                    vm[s], va[s], sb=sb_batch[s])
                vm[s], va[s] = vms, vas
                it[s] += its
                res[s] = rs
        return vm, va, it, res


def newton_raphson(grid: Grid, tol=1e-10, max_iter=20, ordering="auto"):
    """Full Newton power flow; returns (vm, va, iterations, residual)."""
    n = grid.n_bus
    Y, _, _ = ybus(grid)
    yplan = matvec.SpMVPlan(Y)
    sb = sbus(grid)
    pvpq = np.concatenate([grid.pv, grid.pq])
    pq = grid.pq
    vm = grid.vm0.astype(np.float64).copy()
    va = np.zeros(n)

    for it in range(max_iter):
        v = vm * np.exp(1j * va)
        ibus = np.asarray(yplan(jnp.asarray(v)))
        mis = v * np.conj(ibus) - sb
        f = np.concatenate([mis.real[pvpq], mis.imag[pq]])
        nrm = np.max(np.abs(f)) if f.size else 0.0
        if nrm < tol:
            return vm, va, it, nrm
        J = _jacobian(Y, v, ibus, pvpq, pq)
        lu = splu(J, ordering=ordering)
        dx = np.asarray(lu.solve(-f))
        va[pvpq] += dx[: len(pvpq)]
        vm[pq] += dx[len(pvpq) :]
    v = vm * np.exp(1j * va)
    mis = v * np.conj(np.asarray(yplan(jnp.asarray(v)))) - sb
    f = np.concatenate([mis.real[pvpq], mis.imag[pq]])
    return vm, va, max_iter, float(np.max(np.abs(f)))
