"""Distributed linear solves over a device mesh.

The reference has no solver at all (SURVEY scope note); the north-star
config 5 asks for "row-partitioned SpMV + distributed LU-solve ... with
halo overlap".  The decomposition used here:

* **BlockJacobi** — each shard LU-factors its own diagonal block
  (host, linalg.splu per block) and applies it on device as a
  level-scheduled triangular solve (linalg.trisolve.TriSolvePlan).  Per-
  shard plans are padded to a common static shape and stacked on the
  shard axis, so one SPMD program serves every shard.  This is the
  distributed-LU building block: applying M^{-1} is an embarrassingly
  parallel *exact* LU solve of the block-diagonal part of A.

* **dist_cg / dist_bicgstab** — preconditioned Krylov loops run entirely
  inside one ``shard_map``: the matrix action is the halo-ring SpMV
  (parallel/spmv.spmv_local), inner products are ``psum`` over the mesh
  axis, and the preconditioner is the stacked block LU solve.  For
  diagonally dominant admittance systems (Ybus), block-Jacobi-CG
  converges in a few dozen halo exchanges, each of which moves only
  neighbor boundary slices over ICI.

Everything is jittable with static shapes; ``lax.while_loop`` carries the
Krylov state so iteration count is data-dependent but bounded.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..linalg.trisolve import TriSolvePlan
from ..types import CSC
from .partition import RowPartition, _entry_streams_np
from .spmv import _part_specs, spmv_local

__all__ = ["BlockJacobi", "dist_cg", "dist_bicgstab"]


def _padn(a, shape, fill):
    out = np.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


@jax.tree_util.register_pytree_node_class
class BlockJacobi:
    """Stacked per-shard LU solve plans: M^{-1} = diag(A_00^{-1} ... )."""

    _FIELDS = (
        "l_er", "l_ec", "l_ev", "l_rr", "l_rd",
        "u_er", "u_ec", "u_ev", "u_rr", "u_rd",
        "perm_r", "perm_c",
    )

    def __init__(self, mloc, leaves):
        self.mloc = mloc
        for name, leaf in zip(self._FIELDS, leaves):
            setattr(self, name, leaf)

    def tree_flatten(self):
        return tuple(getattr(self, f) for f in self._FIELDS), (self.mloc,)

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(aux[0], ch)

    @classmethod
    def build(cls, a: CSC, part: RowPartition, ordering="amd", tol=1.0):
        """Host: factor each shard's diagonal block and stack the plans."""
        from ..linalg import splu
        from ..ops import construct

        S, mloc, m = part.S, part.mloc, part.m
        rows, cols, vals = _entry_streams_np(a)
        shard = rows // mloc
        plans = []
        for s in range(S):
            lo, hi = s * mloc, (s + 1) * mloc
            keep = (shard == s) & (cols >= lo) & (cols < hi)
            br = rows[keep] - lo
            bc = cols[keep] - lo
            bv = vals[keep]
            # unit diagonal on rows past m (padding) so the block stays
            # nonsingular
            padded = np.arange(max(0, min(hi, S * mloc) - max(lo, m)))
            if len(padded):
                start = max(lo, m) - lo
                br = np.concatenate([br, padded + start])
                bc = np.concatenate([bc, padded + start])
                bv = np.concatenate([bv, np.ones(len(padded), dtype=bv.dtype)])
            block = construct.from_triplets(br, bc, bv, (mloc, mloc))
            plans.append(
                splu(block, ordering=ordering, tol=tol).solve_plan("level")
            )  # slab leaves are stacked below: needs the level-plan layout

        # pad plan slabs to common static shapes across shards
        def stack(get, fill):
            arrs = [np.asarray(get(p)) for p in plans]
            shape = tuple(
                max(x.shape[d] for x in arrs) for d in range(arrs[0].ndim)
            )
            return jnp.asarray(np.stack([_padn(x, shape, fill) for x in arrs]))

        leaves = (
            stack(lambda p: p.lplan.e_rows, mloc),
            stack(lambda p: p.lplan.e_cols, mloc),
            stack(lambda p: p.lplan.e_vals, 0),
            stack(lambda p: p.lplan.r_rows, mloc),
            stack(lambda p: p.lplan.r_dinv, 1),
            stack(lambda p: p.uplan.e_rows, mloc),
            stack(lambda p: p.uplan.e_cols, mloc),
            stack(lambda p: p.uplan.e_vals, 0),
            stack(lambda p: p.uplan.r_rows, mloc),
            stack(lambda p: p.uplan.r_dinv, 1),
            jnp.asarray(np.stack([np.asarray(p.perm_r) for p in plans])),
            jnp.asarray(np.stack([np.asarray(p.perm_c) for p in plans])),
        )
        return cls(mloc, leaves)

    def specs(self, axis: str):
        """shard_map in_specs pytree (leading dim = shard axis)."""
        leaves = tuple(
            P(axis, *([None] * (getattr(self, f).ndim - 1))) for f in self._FIELDS
        )
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(self), leaves
        )

    def apply_local(self, b_local):
        """Per-shard M^{-1} b (inside shard_map; leaves have leading dim 1)."""
        mloc = self.mloc

        def plan(er, ec, ev, rr, rd):
            obj = object.__new__(TriSolvePlan)
            obj.n, obj.lower = mloc, True  # `lower` unused by solve()
            obj.e_rows, obj.e_cols, obj.e_vals = er[0], ec[0], ev[0]
            obj.r_rows, obj.r_dinv = rr[0], rd[0]
            return obj

        lp = plan(self.l_er, self.l_ec, self.l_ev, self.l_rr, self.l_rd)
        up = plan(self.u_er, self.u_ec, self.u_ev, self.u_rr, self.u_rd)
        bp = b_local[self.perm_r[0]]
        z = up.solve(lp.solve(bp))
        x = jnp.zeros_like(z)
        return x.at[self.perm_c[0]].set(z)


@jax.tree_util.register_pytree_node_class
class DiagJacobi:
    """Point-Jacobi preconditioner: M^{-1} = diag(A)^{-1}.

    The memory-light companion to ``BlockJacobi``: per-shard DIRECT
    factors fill at ~n_loc x bandwidth (measured 113M nnz per 125k-row
    shard of the 1M-node RCM'd B' — ~130 GB across 8 stacked level
    plans), while this stores one vector.  More iterations, bounded
    memory — the right trade at the config-5 scale."""

    def __init__(self, dinv):
        self.dinv = dinv          # (S, mloc) stacked inverse diagonals

    def tree_flatten(self):
        return (self.dinv,), ()

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(ch[0])

    @classmethod
    def build(cls, a: CSC, part: RowPartition):
        from ..ops.reductions import diagonal

        S, mloc, m = part.S, part.mloc, part.m
        d = np.asarray(diagonal(a))
        dp = np.ones(S * mloc, dtype=d.dtype)
        dp[:m] = np.where(d != 0, d, 1.0)
        return cls(jnp.asarray((1.0 / dp).reshape(S, mloc)))

    def specs(self, axis: str):
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(self), (P(axis, None),))

    def apply_local(self, b_local):
        return b_local * self.dinv[0]


def _identity_prec(b_local):
    return b_local


# ---------------------------------------------------------------------------
# distributed Krylov loops (SPMD bodies + shard_map wrappers)
# ---------------------------------------------------------------------------

def _cg_body(part, prec, b, x0, *, axis, tol, maxiter):
    A = lambda v: spmv_local(part, v, axis)
    M = prec.apply_local if hasattr(prec, "apply_local") else _identity_prec
    dot = lambda u, v: jax.lax.psum(jnp.vdot(u, v).real, axis)

    r0 = b - A(x0)
    z0 = M(r0)
    bnrm = jnp.sqrt(dot(b, b))
    stop2 = (jnp.maximum(bnrm, 1e-300) * tol) ** 2

    def cond(st):
        x, r, z, p, rz, it = st
        return jnp.logical_and(dot(r, r) > stop2, it < maxiter)

    def body(st):
        x, r, z, p, rz, it = st
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, it + 1)

    x, r, *_rest, it = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, dot(r0, z0), 0)
    )
    return x, jnp.sqrt(dot(r, r)), it


def _bicgstab_body(part, prec, b, x0, *, axis, tol, maxiter):
    A = lambda v: spmv_local(part, v, axis)
    M = prec.apply_local if hasattr(prec, "apply_local") else _identity_prec
    dot = lambda u, v: jax.lax.psum(jnp.vdot(u, v), axis)

    r0 = b - A(x0)
    rhat = r0
    bnrm = jnp.sqrt(dot(b, b).real)
    stop2 = (jnp.maximum(bnrm, 1e-300) * tol) ** 2
    one = jnp.ones((), r0.dtype)

    def cond(st):
        x, r, p, v, rho, alpha, omega, it = st
        return jnp.logical_and(dot(r, r).real > stop2, it < maxiter)

    def body(st):
        x, r, p, v, rho, alpha, omega, it = st
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = dot(t, s) / dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, it + 1)

    x, r, *_rest, it = jax.lax.while_loop(
        cond, body, (x0, r0, jnp.zeros_like(r0), jnp.zeros_like(r0),
                     one, one, one, 0)
    )
    return x, jnp.sqrt(dot(r, r).real), it


def _dist_solve(body, part, b, mesh, axis, prec, x0, tol, maxiter):
    b = part.pad_vector(jnp.asarray(b))
    x0 = part.pad_vector(jnp.asarray(x0)) if x0 is not None else jnp.zeros_like(b)
    pspec = P(axis)
    prec_in = prec if prec is not None else 0
    prec_spec = prec.specs(axis) if prec is not None else P()
    f = jax.shard_map(
        partial(
            lambda pt, pr, bb, xx: body(
                pt, pr if isinstance(pr, BlockJacobi) else None, bb, xx,
                axis=axis, tol=tol, maxiter=maxiter,
            )
        ),
        mesh=mesh,
        in_specs=(_part_specs(part, axis), prec_spec, pspec, pspec),
        out_specs=(pspec, P(), P()),
    )
    x, res, it = f(part, prec_in, b, x0)
    return part.trim_vector(x), res, it


def dist_cg(part, b, mesh: Mesh, axis="rows", prec: BlockJacobi | None = None,
            x0=None, tol=1e-10, maxiter=1000):
    """Distributed (preconditioned) conjugate gradients for SPD systems.
    Returns (x, residual_norm, iterations)."""
    return _dist_solve(_cg_body, part, b, mesh, axis, prec, x0, tol, maxiter)


def dist_bicgstab(part, b, mesh: Mesh, axis="rows",
                  prec: BlockJacobi | None = None, x0=None, tol=1e-10,
                  maxiter=1000):
    """Distributed BiCGSTAB for general (non-symmetric) systems.
    Returns (x, residual_norm, iterations)."""
    return _dist_solve(
        _bicgstab_body, part, b, mesh, axis, prec, x0, tol, maxiter
    )
