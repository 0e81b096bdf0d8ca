"""N-1 contingency screening — batched same-pattern refactorization.

THE canonical power-systems batch workload (what GridCal-class tools run
all day): for every branch outage, re-solve the network and check the
post-outage flows.  The device formulation makes the whole sweep one
compiled program:

* A branch outage never changes the B' PATTERN — only four values (the
  ff/tt diagonals and the ft/tf couplings lose that branch's
  susceptance).  So the base case is factored ONCE on host (pattern +
  pivot order frozen), and every contingency is a device NUMERIC
  refactorization (linalg.RefactorPlan, the KLU-style wavefront) —
  ``vmap`` over the per-outage value arrays batches all scenarios onto
  the matrix units with zero host round-trips.

* Islanding detection: an outage that splits the grid makes the reduced
  B' singular.  With frozen pivots the zero pivot is often exact
  (inf/nan floods the scenario), but cancellation can leave round-off
  noise instead, producing finite garbage that is backward-stable — so
  finiteness and residual checks both miss it.  ``ok`` therefore uses
  the KLU-style pivot-ratio estimate min|U_kk| / max|U_kk| of each
  scenario's own refactorization (free: the diagonal is already
  computed), thresholded at a dtype-scaled tolerance.

Reference counterpart: none (the reference is the sparse engine such
tools sit on; SURVEY §2.4).  This module is the model-family layer the
north star's "batched power-flow solves" config (BASELINE config 4)
points at.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..linalg import splu
from ..ops import construct
from ..ops.slicing import sample_offsets
from .grids import SLACK, Grid

__all__ = ["ACContingency", "DCContingency"]


def _check_outages(outages, n_branch):
    """Validate + normalize an outage index list (XLA gathers would
    silently CLAMP out-of-range scenario ids to the last branch)."""
    outages = np.asarray(outages, dtype=np.int64)
    if outages.size and ((outages < 0) | (outages >= n_branch)).any():
        bad = outages[(outages < 0) | (outages >= n_branch)]
        raise IndexError(
            f"outage ids out of range [0, {n_branch}): {bad[:5]}...")
    return outages


class ACContingency:
    """Full-AC N-1 screening: one vmapped device Newton per outage.

    Same principle as ``DCContingency`` — a branch outage changes only
    the four Ybus stamp values (yff/yft/ytf/ytt) of that branch, never
    the pattern — so one base-case symbolic factorization serves every
    scenario, and each contingency runs the fully-jittable Newton
    (``NewtonPowerFlow.run`` with per-scenario Ybus value overrides:
    device Jacobian assembly + device refactorization per iteration)
    entirely on device.  ``ok`` is the Newton convergence flag: an
    islanding outage leaves no solution (no slack in the island) and the
    mismatch — evaluated against the scenario's OWN admittances — stays
    large.
    """

    def __init__(self, grid: Grid, tol=None, max_iter=20, **pf_kwargs):
        from .grids import branch_admittances
        from .powerflow import NewtonPowerFlow

        if tol is None:
            # f32 device Newton bottoms out around 1e-6 mismatch; 1e-8 is
            # an x64-only target
            tol = 1e-8 if jax.config.jax_enable_x64 else 3e-5
        self.pf = NewtonPowerFlow(grid, tol=tol, max_iter=max_iter,
                                  **pf_kwargs)
        self.grid = grid
        self.tol = tol
        Y = self.pf.Y
        f, t = np.asarray(grid.f), np.asarray(grid.t)
        yff, yft, ytf, ytt = branch_admittances(grid)
        pos = np.stack([
            sample_offsets(Y, f, f), sample_offsets(Y, f, t),
            sample_offsets(Y, t, f), sample_offsets(Y, t, t),
        ], axis=1)
        if (pos < 0).any():
            raise RuntimeError("branch stamp missing from assembled Ybus")
        self._pos = pos                                       # (m, 4)
        self._delta = np.stack([yff, yft, ytf, ytt], axis=1)  # (m, 4)
        self._run = None
        self._run_raw = None

    @property
    def n_branch(self) -> int:
        return self.grid.n_branch

    def _build_run(self):
        pf = self.pf
        pos = jnp.asarray(self._pos)
        dre = jnp.asarray(np.ascontiguousarray(self._delta.real))
        dim = jnp.asarray(np.ascontiguousarray(self._delta.imag))
        base_r, base_i = pf._ygr, pf._ygi
        n = self.grid.n_bus
        vm0 = jnp.asarray(np.asarray(self.grid.vm0, dtype=np.float64))
        va0 = jnp.zeros(n)

        def one(k):
            ygr = base_r.at[pos[k]].add(-dre[k])
            ygi = base_i.at[pos[k]].add(-dim[k])
            vm, va, it, res, bad = pf.run(vm0, va0, pf._sbr, pf._sbi,
                                          ygr, ygi)
            # a growth-gated scenario surfaces as res > tol -> ok=False
            # downstream (same as a non-converged outage)
            return vm, va, it, jnp.where(bad, jnp.inf, res)

        def run(ks):
            return jax.vmap(one)(ks)

        self._run_raw = run
        return jax.jit(run)

    def run_sharded(self, mesh, outages=None, axis: str | None = None):
        """Distribute the AC sweep over a mesh axis (scenario data
        parallel, zero communication — same scheme as
        DCContingency.run_sharded).  Pads to a mesh-size multiple with
        repeats of the first outage and drops them on return."""
        from jax.sharding import NamedSharding, PartitionSpec

        if outages is None:
            outages = np.arange(self.n_branch)
        outages = _check_outages(outages, self.n_branch)
        n = self.grid.n_bus
        if len(outages) == 0:
            z = np.zeros((0, n))
            return z, z, np.zeros(0, int), np.zeros(0, bool)
        axis = axis or mesh.axis_names[0]
        S = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        K = len(outages)
        pad = (-K) % S
        ks = np.concatenate([outages, np.full(pad, outages[0])])
        shard = NamedSharding(mesh, PartitionSpec(axis))
        if self._run is None:
            self._run = self._build_run()
        vm, va, it, res = jax.jit(
            self._run_raw, in_shardings=shard,
            out_shardings=(shard, shard, shard, shard),
        )(jax.device_put(jnp.asarray(ks), shard))
        vm, va = np.asarray(vm)[:K], np.asarray(va)[:K]
        iters, res = np.asarray(it)[:K], np.asarray(res)[:K]
        ok = np.isfinite(res) & (res < 10 * self.tol)
        return vm, va, iters, ok

    def run(self, outages=None, batch: int | None = None):
        """Returns (vm (K, n), va (K, n), iters (K,), ok (K,))."""
        if outages is None:
            outages = np.arange(self.n_branch)
        outages = _check_outages(outages, self.n_branch)
        n = self.grid.n_bus
        if len(outages) == 0:
            z = np.zeros((0, n))
            return z, z, np.zeros(0, int), np.zeros(0, bool)
        if self._run is None:
            self._run = self._build_run()
        vms, vas, its, ress = [], [], [], []
        step = batch or len(outages)
        for s in range(0, len(outages), step):
            vm, va, it, res = self._run(jnp.asarray(outages[s:s + step]))
            vms.append(np.asarray(vm))
            vas.append(np.asarray(va))
            its.append(np.asarray(it))
            ress.append(np.asarray(res))
        vm = np.concatenate(vms)
        va = np.concatenate(vas)
        iters = np.concatenate(its)
        res = np.concatenate(ress)
        ok = np.isfinite(res) & (res < 10 * self.tol)
        return vm, va, iters, ok


class DCContingency:
    """DC (B' theta = P) N-1 screening for a grid.

    ``run(outages)`` returns (flows, theta, ok): per-scenario branch
    flows (K, n_branch), bus angles (K, n_bus, slack = 0), and a
    finite-solution mask (False = the outage islands the grid).
    """

    def __init__(self, grid: Grid, ordering="auto"):
        n = grid.n_bus
        f, t = grid.f, grid.t
        bsus = 1.0 / grid.x
        rows = np.concatenate([f, t, f, t])
        cols = np.concatenate([t, f, f, t])
        vals = np.concatenate([-bsus, -bsus, bsus, bsus])
        B = construct.from_triplets(rows, cols, vals, (n, n))
        keep = np.flatnonzero(np.asarray(grid.bus_type) != SLACK)
        red = np.full(n, -1, dtype=np.int64)
        red[keep] = np.arange(len(keep))
        Br = B[keep, keep]

        # B' is a diagonally dominant reduced Laplacian: a no-pivot ND
        # factorization is stable and lets the vmapped per-scenario
        # refactorization ride the multifrontal matmul-extend-add path
        # (linalg/multifrontal.py) instead of the scalar level-scheduled
        # plan; fall back to RefactorPlan for anything it refuses.
        self._rp = None
        if ordering in ("auto", "nd", "amd", "rcm"):
            try:
                from ..linalg.multifrontal import MultifrontalRefactor

                lu0 = splu(
                    Br, ordering="nd" if ordering == "auto" else ordering,
                    tol=0.0)
                # the no-pivot factorization must be NUMERICALLY sound
                # before its pivots are frozen: a grid that breaks B'
                # diagonal dominance (e.g. series compensation, 1/x < 0)
                # can hit a zero/tiny pivot that lu_factor_host reports
                # (or silently infs) rather than raises
                if lu0.is_singular or not (
                        np.isfinite(np.asarray(lu0._h.Lx)).all()
                        and np.isfinite(np.asarray(lu0._h.Ux)).all()):
                    raise ValueError("no-pivot base factorization unstable")
                self._rp = MultifrontalRefactor(lu0._h, Br)
            except (ValueError, AssertionError):
                self._rp = None
        if self._rp is None:
            lu = splu(Br, ordering=ordering)
            self._rp = lu.refactor_plan(Br)
        _, _, base = Br.np_arrays()

        # per-branch outage stamp: up to 4 (position, delta) pairs in the
        # reduced matrix; entries touching the slack simply vanish
        m = grid.n_branch
        rf, rt = red[f], red[t]
        ls = []
        for rr, cc, sgn in ((rf, rf, +1.0), (rt, rt, +1.0),
                            (rf, rt, -1.0), (rt, rf, -1.0)):
            live = (rr >= 0) & (cc >= 0)
            pos = np.zeros(m, dtype=np.int64)
            pos[live] = sample_offsets(Br, rr[live], cc[live])
            delta = np.where(live, sgn * bsus, 0.0)
            if (pos[live] < 0).any():
                # a structurally-live entry must exist in the assembled B'
                raise RuntimeError(
                    "branch stamp position missing from the assembled B' "
                    "(entry eliminated during assembly?)")
            ls.append((pos, delta))
        self._pos = np.stack([p for p, _ in ls], axis=1)      # (m, 4)
        self._delta = np.stack([d for _, d in ls], axis=1)    # (m, 4)

        self.grid = grid
        self.keep = keep
        self._base = base
        self._P = (np.asarray(grid.pg) - np.asarray(grid.pd))[keep]
        self._binv_x = 1.0 / np.asarray(grid.x)
        self._f, self._t = np.asarray(f), np.asarray(t)
        self._red = red
        self._run = None
        self._run_raw = None
        self._base_solve = None

    @property
    def n_branch(self) -> int:
        return self.grid.n_branch

    def base_theta(self):
        """Pre-contingency angles (device solve with the base values)."""
        th = np.zeros(self.grid.n_bus)
        # jit the composite: eagerly, the multi-level refactor+solve is
        # hundreds of individually dispatched ops; compiled it is one
        # program.  Cached on self (with the plan as a pytree ARG) so
        # repeated calls hit the compiled executable
        if self._base_solve is None:
            self._base_solve = jax.jit(lambda rp, d, P: rp.refactor(d)(P))
        th[self.keep] = np.asarray(self._base_solve(
            self._rp, jnp.asarray(self._base), jnp.asarray(self._P)))
        return th

    def _build_run(self):
        rp = self._rp
        P = jnp.asarray(self._P)
        pos = jnp.asarray(self._pos)
        delta = jnp.asarray(self._delta)
        base = jnp.asarray(self._base)
        red_f = jnp.asarray(self._red[self._f])
        red_t = jnp.asarray(self._red[self._t])
        binv_x = jnp.asarray(self._binv_x)
        nb = len(self.keep)

        def one(k):
            data = base.at[pos[k]].add(-delta[k])
            plan, u_diag = rp.refactor(data, with_diag=True)
            th_r = plan(P)
            # KLU-style singularity estimate: frozen pivots turn islanding
            # into a zero-or-noise pivot whose SOLUTION is backward-stable
            # garbage — only the pivot ratio exposes it
            au = jnp.abs(u_diag)
            rcond = jnp.min(au) / jnp.maximum(jnp.max(au), 1e-30)
            # angles at slack buses are 0; gather with a guard row
            th_pad = jnp.concatenate([th_r, jnp.zeros(1, th_r.dtype)])
            gf = jnp.where(red_f >= 0, red_f, nb)
            gt = jnp.where(red_t >= 0, red_t, nb)
            flows = binv_x * (th_pad[gf] - th_pad[gt])
            flows = flows.at[k].set(0.0)  # the outaged branch carries none
            return flows, th_r, rcond

        def run(ks):
            return jax.vmap(one)(ks)

        self._run_raw = run
        return jax.jit(run)

    def run_sharded(self, mesh, outages=None, axis: str | None = None):
        """Distribute the sweep over a mesh axis (data parallel: scenarios
        are independent, so the outage list shards and the frozen plan
        replicates — zero communication).  Returns (flows, theta, ok) like
        ``run``.  Pads the scenario count to a mesh-size multiple; padding
        scenarios recompute outage 0 and are dropped."""
        from jax.sharding import NamedSharding, PartitionSpec

        if outages is None:
            outages = np.arange(self.n_branch)
        outages = _check_outages(outages, self.n_branch)
        if len(outages) == 0:
            return self._empty_result()
        axis = axis or mesh.axis_names[0]
        S = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        K = len(outages)
        pad = (-K) % S
        ks = np.concatenate([outages, np.full(pad, outages[0])])
        shard = NamedSharding(mesh, PartitionSpec(axis))
        if self._run is None:
            self._run = self._build_run()
        fl, th_r, rs = jax.jit(self._run_raw,
                               in_shardings=shard,
                               out_shardings=(shard, shard, shard))(
            jax.device_put(jnp.asarray(ks), shard))
        return self._assemble(outages, np.asarray(fl)[:K],
                              np.asarray(th_r)[:K], np.asarray(rs)[:K])

    def run(self, outages=None, batch: int | None = None):
        """Screen ``outages`` (default: every branch).  Returns
        (flows (K, n_branch), theta (K, n_bus), ok (K,))."""
        if outages is None:
            outages = np.arange(self.n_branch)
        outages = _check_outages(outages, self.n_branch)
        if len(outages) == 0:
            return self._empty_result()
        if self._run is None:
            self._run = self._build_run()
        chunks_f, chunks_t, chunks_r = [], [], []
        step = batch or len(outages)
        for s in range(0, len(outages), step):
            fl, th, rc = self._run(jnp.asarray(outages[s:s + step]))
            chunks_f.append(np.asarray(fl))
            chunks_t.append(np.asarray(th))
            chunks_r.append(np.asarray(rc))
        flows = np.concatenate(chunks_f)
        th_r = np.concatenate(chunks_t)
        rcond = np.concatenate(chunks_r)
        return self._assemble(outages, flows, th_r, rcond)

    def _empty_result(self):
        return (np.zeros((0, self.n_branch)),
                np.zeros((0, self.grid.n_bus)),
                np.zeros(0, dtype=bool))

    def _assemble(self, outages, flows, th_r, rcond):
        theta = np.zeros((len(outages), self.grid.n_bus))
        theta[:, self.keep] = th_r
        # dtype-scaled pivot-ratio threshold: a noise pivot sits at
        # O(eps) relative, healthy grid pivots orders of magnitude above
        tol = 1000.0 * float(np.finfo(th_r.dtype).eps)
        ok = (np.isfinite(flows).all(axis=1)
              & np.isfinite(th_r).all(axis=1)
              & np.isfinite(rcond) & (rcond > tol))
        return flows, theta, ok
