"""Triangular solves.

Two tiers:

* Host reference solves ``lsolve`` / ``usolve`` / ``ltsolve`` / ``utsolve``
  — the cs_lsolve/cs_usolve API the original CSparse has and the reference
  Python port never reached (SURVEY scope note).  Column-oriented numpy
  loops, used as oracles and for tiny systems.

* **Device level-scheduled solves** (``TriSolvePlan``): rows of the
  triangular factor are grouped into dependency levels
  (level(i) = 1 + max level over the rows i reads).  All rows in a level
  are independent, so each level is one gather + segment-update; the
  whole solve is a ``lax.scan`` over level slabs padded to uniform width —
  static shapes, fully jittable, multi-RHS batched so the per-level update
  is a wide vector/matmul operation instead of a scalar recurrence.  This is the
  device replacement for the sequential forward/back substitution loop
  (SURVEY §5.7: "level-scheduled distributed triangular solves").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "lsolve", "usolve", "ltsolve", "utsolve", "TriSolvePlan",
    "DenseTailTriSolvePlan", "choose_dense_tail", "level_schedule",
]


# ---------------------------------------------------------------------------
# host reference solves (CSC, column-oriented like cs_lsolve/cs_usolve)
# ---------------------------------------------------------------------------

def lsolve(Lp, Li, Lx, b):
    """x = L^{-1} b for lower-triangular CSC L with explicit diagonal
    (diagonal entry first in each column).  b: (n,) or (n, k)."""
    x = np.array(b, copy=True)
    n = len(Lp) - 1
    vec = x.ndim == 1
    for j in range(n):
        lo, hi = Lp[j], Lp[j + 1]
        x[j] /= Lx[lo]
        rows = Li[lo + 1 : hi]
        coeff = Lx[lo + 1 : hi]
        if vec:
            x[rows] -= coeff * x[j]
        else:
            x[rows] -= coeff[:, None] * x[j][None, :]
    return x


def usolve(Up, Ui, Ux, b):
    """x = U^{-1} b for upper-triangular CSC U (diagonal entry last).
    b: (n,) or (n, k)."""
    x = np.array(b, copy=True)
    n = len(Up) - 1
    vec = x.ndim == 1
    for j in range(n - 1, -1, -1):
        lo, hi = Up[j], Up[j + 1]
        x[j] /= Ux[hi - 1]
        rows = Ui[lo : hi - 1]
        coeff = Ux[lo : hi - 1]
        if vec:
            x[rows] -= coeff * x[j]
        else:
            x[rows] -= coeff[:, None] * x[j][None, :]
    return x


def ltsolve(Lp, Li, Lx, b):
    """x = L^{-T} b."""
    x = np.array(b, copy=True)
    n = len(Lp) - 1
    for j in range(n - 1, -1, -1):
        lo, hi = Lp[j], Lp[j + 1]
        x[j] -= np.dot(Lx[lo + 1 : hi], x[Li[lo + 1 : hi]])
        x[j] /= Lx[lo]
    return x


def utsolve(Up, Ui, Ux, b):
    """x = U^{-T} b."""
    x = np.array(b, copy=True)
    n = len(Up) - 1
    for j in range(n):
        lo, hi = Up[j], Up[j + 1]
        x[j] -= np.dot(Ux[lo : hi - 1], x[Ui[lo : hi - 1]])
        x[j] /= Ux[hi - 1]
    return x


# ---------------------------------------------------------------------------
# level scheduling (host analysis)
# ---------------------------------------------------------------------------

def level_schedule(n, rows, cols, lower: bool):
    """Dependency levels for a triangular matrix given in (row, col) entry
    streams with the diagonal EXCLUDED.  For lower solves row i depends on
    cols < i; for upper solves on cols > i.  Returns level[i] per row.

    Exact and O(nnz + n): vectorized Kahn topological waves — wave 0 is
    every row with no off-diagonal entries; releasing a wave decrements the
    indegree of the rows that read it (one grouped gather per wave)."""
    lev = np.zeros(n, dtype=np.int64)
    nnz = len(rows)
    if nnz == 0:
        return lev
    indeg = np.bincount(rows, minlength=n)
    # group entries by column for "who reads row c" lookups
    order = np.argsort(cols, kind="stable")
    rows_by_col = rows[order]
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(colptr, cols + 1, 1)
    colptr = np.cumsum(colptr)

    frontier = np.flatnonzero(indeg == 0)
    level = 0
    assigned = len(frontier)
    while frontier.size:
        lev[frontier] = level
        # entries whose col is in the frontier
        starts = colptr[frontier]
        counts = colptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(total) + np.repeat(starts - offs[:-1], counts)
        touched = rows_by_col[pos]
        dec = np.bincount(touched, minlength=n)
        indeg -= dec
        frontier = np.unique(touched[indeg[touched] == 0])
        level += 1
        assigned += len(frontier)
    if assigned < n and nnz:
        # rows never released -> cyclic dependency (not triangular)
        remaining = indeg > 0
        if remaining.any():
            raise ValueError("level_schedule: matrix is not triangular (cycle)")
    return lev


class _Slabs(NamedTuple):
    e_rows: np.ndarray  # (nlev, We) entry rows, pad n
    e_cols: np.ndarray  # (nlev, We) entry cols, pad n
    e_vals: np.ndarray  # (nlev, We) entry vals, pad 0
    r_rows: np.ndarray  # (nlev, Wr) rows finalized at each level; padding
    #                       uses n+1 — OUT of the (n+1)-slot workspace, so
    #                       mode="drop" discards it and the written indices
    #                       are genuinely unique (unique_indices=True is
    #                       then sound, which scatter-mul GRADIENTS require)
    r_dinv: np.ndarray  # (nlev, Wr) 1/diag for those rows, pad 1


def _build_slabs(n, rows, cols, vals, diag, lower: bool) -> _Slabs:
    lev = level_schedule(n, rows, cols, lower)
    nlev = int(lev.max()) + 1 if n else 1

    def pad_group(ids, payloads, pads, width=None):
        order = np.argsort(ids, kind="stable")
        ids_s = ids[order]
        counts = np.bincount(ids_s, minlength=nlev)
        W = int(counts.max()) if width is None and counts.size else (width or 1)
        W = max(W, 1)
        outs = []
        offs = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(ids_s)) - offs[ids_s]
        for p, padval in zip(payloads, pads):
            buf = np.full((nlev, W), padval, dtype=p.dtype)
            buf[ids_s, slot] = p[order]
            outs.append(buf)
        return outs

    elev = lev[rows]
    e_rows, e_cols, e_vals = pad_group(
        elev,
        [rows.astype(np.int64), cols.astype(np.int64), vals],
        [n, n, 0],
    ) if len(rows) else (
        np.full((nlev, 1), n), np.full((nlev, 1), n),
        np.zeros((nlev, 1), dtype=vals.dtype),
    )
    all_rows = np.arange(n, dtype=np.int64)
    with np.errstate(divide="ignore"):  # zero pivot -> inf (SuperLU-style)
        dinv = (1.0 / diag).astype(diag.dtype)
    r_rows, r_dinv = pad_group(
        lev, [all_rows, dinv], [n + 1, 1]
    ) if n else (np.full((1, 1), n + 1), np.ones((1, 1), dtype=diag.dtype))
    return _Slabs(e_rows, e_cols, e_vals, r_rows, r_dinv)


# ---------------------------------------------------------------------------
# device plan
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class TriSolvePlan:
    """Jittable level-scheduled triangular solve for one factor.

    Built from CSC factor arrays on host; ``solve(b)`` runs on device with
    static shapes (b may be (n,) or (n, k) for batched RHS).
    """

    def __init__(self, n, Fp, Fi, Fx, lower: bool, unit_diag_value=None,
                 unroll: int = 8):
        Fp = np.asarray(Fp)
        Fi = np.asarray(Fi)
        Fx = np.asarray(Fx)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
        rows = Fi.astype(np.int64)
        on_diag = rows == cols
        diag = np.ones(n, dtype=Fx.dtype)
        diag[rows[on_diag]] = Fx[on_diag]
        off = ~on_diag
        slabs = _build_slabs(n, rows[off], cols[off], Fx[off], diag, lower)
        self.n = n
        self.lower = lower
        # Unroll K dependency levels into each scan step: sparse-factor
        # levels are narrow, so at small/medium n the solve is bound by
        # per-scan-iteration dispatch latency, not flops.  Shapes go from
        # (nlev, W) to (ceil(nlev/K), K, W); padding levels are all-dummy
        # (row n = drop slot, dinv 1).
        K = max(int(unroll), 1)
        nlev = slabs.e_rows.shape[0]
        nsteps = -(-nlev // K)
        pad = nsteps * K - nlev

        def pad_lev(a, padval):
            if pad:
                fill = np.full((pad, a.shape[1]), padval, dtype=a.dtype)
                a = np.concatenate([a, fill], axis=0)
            return a.reshape(nsteps, K, a.shape[1])

        # kept as HOST numpy: under jit-with-plan-as-closure they embed as
        # HLO constants with no host->device transfer (complex factors then
        # never cross the transfer boundary); as jit arguments they upload
        # like any pytree leaf
        self.e_rows = pad_lev(slabs.e_rows, n)
        self.e_cols = pad_lev(slabs.e_cols, n)
        self.e_vals = pad_lev(slabs.e_vals, 0)
        self.r_rows = pad_lev(slabs.r_rows, n + 1)  # n+1: dropped, stays unique
        self.r_dinv = pad_lev(slabs.r_dinv, 1)
        self._nlev = nlev

    # pytree
    def tree_flatten(self):
        return (
            (self.e_rows, self.e_cols, self.e_vals, self.r_rows, self.r_dinv),
            (self.n, self.lower, self._nlev),
        )

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.n, obj.lower, obj._nlev = aux
        obj.e_rows, obj.e_cols, obj.e_vals, obj.r_rows, obj.r_dinv = ch
        return obj

    @property
    def nlevels(self):
        return self._nlev

    @property
    def unroll(self):
        return self.e_rows.shape[1]

    def solve(self, b):
        """x = F^{-1} b, device, O(nlevels / unroll) sequential scan steps."""
        b = jnp.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        k = b.shape[1]
        # workspace with one dummy slot at index n
        x = jnp.zeros((self.n + 1, k), dtype=jnp.result_type(b.dtype, self.e_vals.dtype))
        x = x.at[: self.n].set(b)
        K = self.e_rows.shape[1]

        def body(x, slab):
            er, ec, ev, rr, rd = slab
            for i in range(K):  # unrolled in-trace
                contrib = ev[i][:, None] * x[ec[i]]
                x = x.at[er[i]].add(-contrib, mode="drop")
                x = x.at[rr[i]].multiply(rd[i][:, None], mode="drop",
                                         unique_indices=True)
            return x, None

        x, _ = jax.lax.scan(
            body, x, (self.e_rows, self.e_cols, self.e_vals, self.r_rows, self.r_dinv)
        )
        out = x[: self.n]
        return out[:, 0] if squeeze else out

    def __call__(self, b):
        return self.solve(b)


# ---------------------------------------------------------------------------
# dense-tail hybrid plan
# ---------------------------------------------------------------------------

def choose_dense_tail(n, Fp, Fi, max_tail=4096, min_tail=512,
                      min_density=0.15, block=256):
    """Pick a trailing-block size T (multiple of ``block``) such that the
    T x T corner of the factor is at least ``min_density`` dense — the
    signature of the final separator clique under amd/nd orderings.
    Returns 0 when no worthwhile tail exists."""
    Fp = np.asarray(Fp)
    Fi = np.asarray(Fi).astype(np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
    best = 0
    T = min(max_tail, (n // 2) // block * block)
    while T >= min_tail:
        k0 = n - T
        cnt = int(((cols >= k0) & (Fi >= k0)).sum())
        if cnt >= min_density * (T * T / 2):
            best = T
            break
        T -= block if T - block >= min_tail else T
    return best


@jax.tree_util.register_pytree_node_class
class DenseTailTriSolvePlan:
    """Triangular solve = level-scheduled head + dense matmul-blocked tail.

    Under fill-reducing orderings the trailing separator clique is dense
    and carries the deepest dependency chains; solving it as s x s blocked
    dense substitution (precomputed block inverses, (s,s)@(s,B) matmuls)
    removes most sequential levels, while the sparse head keeps the
    level-scheduled path.  Same ``solve`` interface / pytree behavior as
    ``TriSolvePlan``; used automatically by ``SparseLU.solve_plan`` when
    ``choose_dense_tail`` finds a qualifying corner.
    """

    def __init__(self, n, Fp, Fi, Fx, lower: bool, tail: int,
                 block: int = 256, unroll: int = 8):
        Fp = np.asarray(Fp)
        Fi = np.asarray(Fi).astype(np.int64)
        Fx = np.asarray(Fx)
        s = block
        T_pad = -(-tail // s) * s
        n_head = n - tail
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
        rows = Fi

        # lower: head-internal needs both row and col in the head; upper:
        # rows <= col < n_head is implied by the column test
        head = (cols < n_head) & (rows < n_head) if lower else (cols < n_head)
        cross = ((cols < n_head) & (rows >= n_head)) if lower else (
            (cols >= n_head) & (rows < n_head))
        tail_m = (cols >= n_head) if lower else ((cols >= n_head) & (rows >= n_head))

        # head sub-CSC (square n_head)
        hc, hr, hv = cols[head], rows[head], Fx[head]
        hp = np.zeros(n_head + 1, dtype=np.int64)
        np.add.at(hp, hc + 1, 1)
        hp = np.cumsum(hp)
        order = np.argsort(hc, kind="stable")
        self._head = TriSolvePlan(n_head, hp, hr[order], hv[order],
                                  lower=lower, unroll=unroll)

        # cross entry streams (local tail row ids; pad slot T_pad unused)
        if lower:
            cr, cc, cv = rows[cross] - n_head, cols[cross], Fx[cross]
        else:
            cr, cc, cv = rows[cross], cols[cross] - n_head, Fx[cross]
        self.c_rows = cr
        self.c_cols = cc
        self.c_vals = cv

        # dense tail blocks
        dense = np.zeros((T_pad, T_pad), dtype=Fx.dtype)
        dense[rows[tail_m] - n_head, cols[tail_m] - n_head] = Fx[tail_m]
        for i in range(tail, T_pad):
            dense[i, i] = 1.0
        nb = T_pad // s
        invd = np.empty((nb, s, s), dtype=Fx.dtype)
        strips = np.zeros((nb, T_pad, s), dtype=Fx.dtype)
        for b in range(nb):
            lo, hi = b * s, (b + 1) * s
            invd[b] = np.linalg.inv(dense[lo:hi, lo:hi])
            st = dense[:, lo:hi].copy()
            if lower:
                st[:hi] = 0  # rows handled by this or earlier blocks
            else:
                st[lo:] = 0
            strips[b] = st
        self.invd = invd  # host numpy, see TriSolvePlan note
        self.strips = strips
        self.n = n
        self.lower = lower
        self.tail = tail
        self.s = s

    # pytree
    def tree_flatten(self):
        return (
            (self._head, self.c_rows, self.c_cols, self.c_vals,
             self.invd, self.strips),
            (self.n, self.lower, self.tail, self.s),
        )

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.n, obj.lower, obj.tail, obj.s = aux
        (obj._head, obj.c_rows, obj.c_cols, obj.c_vals,
         obj.invd, obj.strips) = ch
        return obj

    @property
    def nlevels(self):
        return self._head.nlevels + self.invd.shape[0]

    def _dense_solve(self, r):
        """Blocked substitution on the (T_pad, B) rhs ``r``."""
        s = self.s
        nb = self.invd.shape[0]
        idx = jnp.arange(nb) * s

        # HIGHEST: full-f32 products; the default f32 matmul may run in
        # TF32 on the GPU, and that rounding compounds through the
        # blocked substitution recurrence
        with jax.default_matmul_precision("highest"):
            def step(r, blk):
                invd, strip, off = blk
                r_b = jax.lax.dynamic_slice_in_dim(r, off, s, axis=0)
                x_b = invd @ r_b
                r = r - strip @ x_b
                return r, x_b

            # scan's stacked outputs align with xs order even if reversed
            _, xs = jax.lax.scan(
                step, r, (self.invd, self.strips, idx),
                reverse=not self.lower
            )
        return xs.reshape(nb * s, -1)

    def solve(self, b):
        b = jnp.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        B = b.shape[1]
        n_head = self.n - self.tail
        T_pad = self.invd.shape[0] * self.s
        dt = jnp.result_type(b.dtype, self.invd.dtype)
        if self.lower:
            xh = self._head.solve(b[:n_head])
            r = jnp.zeros((T_pad, B), dtype=dt).at[: self.tail].set(b[n_head:])
            contrib = self.c_vals[:, None] * xh[self.c_cols]
            r = r.at[self.c_rows].add(-contrib, mode="drop")
            xt = self._dense_solve(r)[: self.tail]
            out = jnp.concatenate([xh, xt], axis=0)
        else:
            r = jnp.zeros((T_pad, B), dtype=dt).at[: self.tail].set(b[n_head:])
            xt = self._dense_solve(r)[: self.tail]
            contrib = self.c_vals[:, None] * xt[self.c_cols]
            bh = jnp.asarray(b[:n_head], dtype=dt).at[self.c_rows].add(
                -contrib, mode="drop")
            xh = self._head.solve(bh)
            out = jnp.concatenate([xh, xt], axis=0)
        return out[:, 0] if squeeze else out

    def __call__(self, b):
        return self.solve(b)
