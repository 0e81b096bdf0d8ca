"""Distributed direct solve: Schur-complement domain decomposition.

The "distributed LU-solve" of the north star (BASELINE config 5) as a
direct method, not a preconditioned Krylov loop.  Rows are split into S
contiguous blocks (order the matrix with RCM/ND first so blocks are
graph-local); the **interface** Γ is every row incident to a cross-block
entry.  With interiors first and Γ last the matrix is bordered block
diagonal:

    [ A_0          E_0 ]        A_s : interior of shard s (decoupled!)
    [      ..      ..  ]        E_s : interior -> interface coupling
    [         A_S  E_S ]        F_s : interface -> interior coupling
    [ F_0  ..  F_S  C  ]        C   : interface block

Factorization (host, once):
  * splu(A_s) per shard (interiors are identity-padded to a common local
    size so the per-shard device plans stack into uniform SPMD leaves),
  * W_s = A_s^{-1} E_s  (one batched multi-RHS solve per shard),
  * Sc = C - Σ_s F_s W_s  (the interface Schur complement),
  * splu(Sc) — its trailing density is exactly what the dense-tail matmul
    solve plan handles.

Solve (jittable; SPMD under ``shard_map`` via ``dist_solve``):
  y_s = A_s^{-1} b_s                   per-shard level-scheduled plan
  g   = b_Γ - Σ_s F_s y_s              entry scatter + psum over shards
  x_Γ = Sc^{-1} g                      replicated interface solve
  x_s = y_s - W_s x_Γ                  one (mloc x nΓ) @ (nΓ x B) matmul

W_s is stored dense — the method targets interfaces small relative to the
domain (the constructor raises past ``max_interface``).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..types import CSC
from ..linalg.lu import splu

__all__ = ["SchurLU", "SchurSolvePlan"]


class SchurLU:
    """Distributed direct factorization of a square sparse matrix."""

    def __init__(self, a: CSC, S: int, ordering="amd", tol: float = 1.0,
                 max_interface: int = 8192):
        if a.m != a.n:
            raise ValueError("SchurLU expects a square matrix")
        n = a.n
        self.n, self.S = n, S
        mloc = -(-n // S)
        ip, ix, dt = a.np_arrays()
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        rows = ix.astype(np.int64)

        shard_of = np.minimum(np.arange(n) // mloc, S - 1)
        cross = shard_of[rows] != shard_of[cols]
        is_gamma = np.zeros(n, dtype=bool)
        is_gamma[rows[cross]] = True
        is_gamma[cols[cross]] = True
        self.gamma = np.flatnonzero(is_gamma)
        ng = len(self.gamma)
        if ng > max_interface:
            raise ValueError(
                f"interface has {ng} rows (> {max_interface}); order the "
                "matrix for locality (rcm/nd) or use fewer/larger shards"
            )
        if ng == 0:
            raise ValueError(
                "no cross-shard entries; use per-shard splu directly"
            )

        import scipy.sparse as sp

        A = sp.csc_matrix((dt, ix, ip), shape=a.shape)
        self.interiors: List[np.ndarray] = [
            np.flatnonzero(~is_gamma[np.arange(s * mloc, min((s + 1) * mloc, n))])
            + s * mloc
            for s in range(S)
        ]
        self.mi = max(max((len(i) for i in self.interiors), default=1), 1)
        mi = self.mi
        self._lus = []
        self._W = []
        self._Wcols = []
        self._F = []
        Sc = np.asarray(A[np.ix_(self.gamma, self.gamma)].todense())
        for s in range(S):
            I = self.interiors[s]
            li = len(I)
            Ass = A[np.ix_(I, I)].tocsc()
            if li < mi:  # identity pad to the common local size
                Ass = sp.block_diag(
                    [Ass, sp.eye(mi - li, dtype=dt.dtype, format="csc")]
                ).tocsc()
            # each interior couples only to ITS boundary's interface
            # columns — restrict E/W to those (the full (mi, ng) dense
            # coupling block made the build quadratic in n)
            Eg = A[np.ix_(I, self.gamma)].tocsc()
            lcols = np.flatnonzero(np.diff(Eg.indptr))
            nl = max(len(lcols), 1)
            E = np.zeros((mi, nl), dtype=dt.dtype)
            if len(lcols):
                E[:li] = np.asarray(Eg[:, lcols].todense())
            F = A[np.ix_(self.gamma, I)].tocsc()  # cols are local [0, li)
            lu = splu(CSC.from_scipy(Ass), ordering=ordering, tol=tol)
            W = np.asarray(lu.solve_host(E))
            if len(lcols):
                Sc[:, lcols] -= F @ W[:li]
            self._lus.append(lu)
            self._W.append(W)
            self._Wcols.append(lcols if len(lcols)
                               else np.zeros(1, dtype=np.int64))
            self._F.append(F)
        from ..ops.construct import dense_to_csc

        self._gamma_lu = splu(dense_to_csc(Sc), ordering="natural", tol=tol)
        self.n_interface = ng

    @property
    def fill(self) -> int:
        return (sum(lu.lnz + lu.unz for lu in self._lus)
                + self._gamma_lu.lnz + self._gamma_lu.unz)

    @property
    def is_singular(self) -> bool:
        return (any(lu.is_singular for lu in self._lus)
                or self._gamma_lu.is_singular)

    # -- host solve (oracle) ------------------------------------------------
    def solve_host(self, b):
        b = np.asarray(b)
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        B = bb.shape[1]
        dt = np.result_type(bb.dtype, self._W[0].dtype)
        bb = bb.astype(dt, copy=False)
        x = np.zeros_like(bb)
        g = bb[self.gamma].copy()
        ys = []
        for s in range(self.S):
            I = self.interiors[s]
            rhs = np.zeros((self.mi, B), dtype=bb.dtype)
            rhs[: len(I)] = bb[I]
            y = np.asarray(self._lus[s].solve_host(rhs))
            ys.append(y)
            g -= self._F[s] @ y[: len(I)]
        xg = np.asarray(self._gamma_lu.solve_host(g))
        x[self.gamma] = xg
        for s in range(self.S):
            I = self.interiors[s]
            x[I] = (ys[s] - self._W[s] @ xg[self._Wcols[s]])[: len(I)]
        return x[:, 0] if squeeze else x

    def device_plan(self) -> "SchurSolvePlan":
        return SchurSolvePlan(self)


@jax.tree_util.register_pytree_node_class
class SchurSolvePlan:
    """Jittable Schur solve.

    Per-shard leaves carry a leading dim S (shard them P(axis, ...) in
    shard_map); interface pieces are replicated.  ``solve(b)`` runs on one
    device; ``dist_solve(b, mesh, axis)`` runs the SPMD path with the
    interface rhs psum-reduced over shards.
    """

    def __init__(self, host: SchurLU):
        S, mi, ng = host.S, host.mi, host.n_interface
        # identical-structure per-shard plans (interiors identity-padded,
        # level style so slab leaves stack; _nlev aux may differ per shard
        # but solve() never reads it, so shard 0's treedef stands for all)
        plans = [lu.solve_plan("level") for lu in host._lus]
        leaves0, treedef = jax.tree_util.tree_flatten(plans[0])
        all_leaves = [jax.tree_util.tree_flatten(p)[0] for p in plans]
        from .solve import _padn

        stacked = []
        for i in range(len(leaves0)):
            arrs = [np.asarray(ls[i]) for ls in all_leaves]
            shape = tuple(max(x.shape[d] for x in arrs)
                          for d in range(arrs[0].ndim))
            padded = []
            for x in arrs:
                if np.issubdtype(x.dtype, np.floating) or np.issubdtype(
                        x.dtype, np.complexfloating):
                    # r_dinv slabs pad with the identity 1; e_vals with 0.
                    fill = 1 if self._is_dinv_leaf(i) else 0
                else:
                    fill = mi  # index slabs: the plan's dummy drop slot
                padded.append(_padn(x, shape, fill))
            stacked.append(jnp.asarray(np.stack(padded)))
        self._treedef = treedef
        self._plan_leaves = tuple(stacked)

        fe = [f.tocoo() for f in host._F]
        Ef = max(max((f.nnz for f in fe), default=1), 1)
        f_rows = np.full((S, Ef), ng, dtype=np.int64)  # pad -> dummy slot
        f_cols = np.zeros((S, Ef), dtype=np.int64)
        f_vals = np.zeros((S, Ef), dtype=host._W[0].dtype)
        gather = np.full((S, mi), host.n, dtype=np.int64)  # pad: dropped
        gmask = np.zeros((S, mi), dtype=bool)
        # W is interface-LOCAL per shard (columns = that shard's coupled
        # interface ids); pad to a common width with zero columns
        nl_max = max(w.shape[1] for w in host._W)
        Ws = np.zeros((S, mi, nl_max), dtype=host._W[0].dtype)
        wcols = np.zeros((S, nl_max), dtype=np.int64)
        for s in range(S):
            I = host.interiors[s]
            gather[s, : len(I)] = I
            gmask[s, : len(I)] = True
            f_rows[s, : fe[s].nnz] = fe[s].row
            f_cols[s, : fe[s].nnz] = fe[s].col
            f_vals[s, : fe[s].nnz] = fe[s].data
            Ws[s, :, : host._W[s].shape[1]] = host._W[s]
            wcols[s, : len(host._Wcols[s])] = host._Wcols[s]
        self.n, self.S, self.mi, self.ng = host.n, S, mi, ng
        self.W = jnp.asarray(Ws)
        self.wcols = jnp.asarray(wcols)
        self.f_rows = jnp.asarray(f_rows)
        self.f_cols = jnp.asarray(f_cols)
        self.f_vals = jnp.asarray(f_vals)
        self.gather = jnp.asarray(gather)
        self.gmask = jnp.asarray(gmask)
        self.gamma = jnp.asarray(host.gamma)
        self.gplan = host._gamma_lu.solve_plan()

    @staticmethod
    def _is_dinv_leaf(i: int) -> bool:
        # SolvePlan flatten order: lplan(e_rows, e_cols, e_vals, r_rows,
        # r_dinv), uplan(same), perm_r, perm_c -> r_dinv at 4 and 9
        return i in (4, 9)

    # pytree
    def tree_flatten(self):
        return (
            (self._plan_leaves, self.W, self.wcols, self.f_rows,
             self.f_cols, self.f_vals, self.gather, self.gmask,
             self.gamma, self.gplan),
            (self.n, self.S, self.mi, self.ng, self._treedef),
        )

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.n, obj.S, obj.mi, obj.ng, obj._treedef = aux
        (obj._plan_leaves, obj.W, obj.wcols, obj.f_rows, obj.f_cols,
         obj.f_vals, obj.gather, obj.gmask, obj.gamma, obj.gplan) = ch
        return obj

    def _interior_solve(self, s_leaves, rhs):
        plan = jax.tree_util.tree_unflatten(self._treedef, list(s_leaves))
        return plan(rhs)

    # -- single-device -------------------------------------------------------
    def solve(self, b):
        b = jnp.asarray(b)
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        B = bb.shape[1]
        dt = jnp.result_type(bb.dtype, self.W.dtype)
        g = jnp.asarray(bb[self.gamma], dt)
        ys = []
        for s in range(self.S):
            rhs = jnp.where(self.gmask[s][:, None], bb[self.gather[s]], 0)
            y = self._interior_solve(
                [leaf[s] for leaf in self._plan_leaves], rhs.astype(dt))
            ys.append(y)
            contrib = self.f_vals[s][:, None] * y[self.f_cols[s]]
            g = (
                jnp.concatenate([g, jnp.zeros((1, B), dt)], axis=0)
                .at[self.f_rows[s]].add(-contrib)[: self.ng]
            )
        xg = self.gplan(g)
        x = jnp.zeros((self.n, B), dtype=dt).at[self.gamma].set(xg)
        for s in range(self.S):
            # full f32: the default f32 matmul may run in TF32
            with jax.default_matmul_precision("highest"):
                xi = ys[s] - self.W[s] @ xg[self.wcols[s]]
            x = x.at[self.gather[s]].set(xi, mode="drop")
        return x[:, 0] if squeeze else x

    def __call__(self, b):
        return self.solve(b)

    # -- SPMD ---------------------------------------------------------------
    def dist_solve(self, b, mesh: Mesh, axis: str = "shards"):
        """SPMD solve: interior solve + F scatter per shard, interface rhs
        psum-reduced, Γ solve replicated, back-substitution per shard."""
        if mesh.shape[axis] != self.S:
            raise ValueError(
                f"mesh axis {axis!r} has {mesh.shape[axis]} devices but the "
                f"plan was built for S={self.S} shards"
            )
        b = jnp.asarray(b)
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b

        leaf_specs = tuple(
            P(axis, *([None] * (leaf.ndim - 1))) for leaf in self._plan_leaves
        )
        sharded2 = P(axis, None)
        gplan_specs = jax.tree_util.tree_map(lambda _: P(), self.gplan)

        def body(leaves, W, wc, fr, fc, fv, gat, gm, gamma, gplan, bfull):
            dt = jnp.result_type(bfull.dtype, W.dtype)
            rhs = jnp.where(gm[0][:, None], bfull[gat[0]], 0).astype(dt)
            y = self._interior_solve([lf[0] for lf in leaves], rhs)
            contrib = fv[0][:, None] * y[fc[0]]
            g_part = (
                jnp.zeros((self.ng + 1, bfull.shape[1]), dt)
                .at[fr[0]].add(-contrib)[: self.ng]
            )
            g = jax.lax.psum(g_part, axis) + bfull[gamma].astype(dt)
            xg = gplan(g)  # replicated interface solve
            # full f32: the default f32 matmul may run in TF32
            with jax.default_matmul_precision("highest"):
                xi = y - W[0] @ xg[wc[0]]
            return xi[None], xg

        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(
                leaf_specs, P(axis, None, None), sharded2, sharded2,
                sharded2, sharded2, sharded2, sharded2, P(None),
                gplan_specs, P(None, None),
            ),
            out_specs=(P(axis, None, None), P(None, None)),
        )
        xi, xg = f(self._plan_leaves, self.W, self.wcols, self.f_rows,
                   self.f_cols, self.f_vals, self.gather, self.gmask,
                   self.gamma, self.gplan, bb)
        x = jnp.zeros((self.n, bb.shape[1]), dtype=xi.dtype).at[
            self.gamma].set(xg)
        for s in range(self.S):
            x = x.at[self.gather[s]].set(xi[s], mode="drop")
        return x[:, 0] if squeeze else x
