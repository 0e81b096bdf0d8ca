"""Sparse LDL^T factorization — the symmetric direct solver.

The CSparse lineage the reference ports defines cs_chol; the Python port
never reached it (SURVEY scope note).  This is the symmetric counterpart
of linalg.lu: half the factor flops of LU for the symmetric systems this
domain runs on (DC / fast-decoupled B' and B'' matrices, Laplacians,
complex-symmetric Ybus — LDL^T without conjugation applies to complex
SYMMETRIC matrices, which Ybus is).

Factorization is host-side (native up-looking kernel, C++; dense
scipy.linalg.ldl fallback), no pivoting — the symmetric fill-reducing
ordering (AMD by default) is the only permutation.  Zero pivots are
REPORTED (``is_singular`` / ``singular_cols``), matching the SuperLU-style
LU behavior (reference breadcrumb: src/research/scipy_wrappers.py).

The solve path reuses the LU machinery: L feeds the same level-scheduled
``TriSolvePlan`` device solves, with a diagonal scale between the two
sweeps:  x = P^T L^{-T} D^{-1} L^{-1} P b.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import CSC
from . import ordering as ordering_mod
from .trisolve import (DenseTailTriSolvePlan, TriSolvePlan,
                       choose_dense_tail, lsolve, ltsolve)

__all__ = ["LDLTSolvePlan", "SparseLDLT", "ldlt"]


@jax.tree_util.register_pytree_node_class
class LDLTSolvePlan:
    """Jittable x = A^{-1} b from an LDL^T factorization: permute,
    L-solve, D-scale, L^T-solve, unpermute.  A pytree."""

    def __init__(self, lplan: TriSolvePlan, ltplan: TriSolvePlan, dinv, perm):
        self.lplan = lplan
        self.ltplan = ltplan
        self.dinv = dinv
        self.perm = perm

    def tree_flatten(self):
        return (self.lplan, self.ltplan, self.dinv, self.perm), ()

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.lplan, obj.ltplan, obj.dinv, obj.perm = ch
        return obj

    def __call__(self, b):
        b = jnp.asarray(b)
        bp = b[self.perm]
        y = self.lplan.solve(bp)
        y = y * self.dinv if y.ndim == 1 else y * self.dinv[:, None]
        z = self.ltplan.solve(y)
        x = jnp.zeros_like(z)
        return x.at[self.perm].set(z)


class SparseLDLT:
    """P A P^T = L D L^T for symmetric A (values: both triangles stored)."""

    def __init__(self, n, Lp, Li, Lx, D, perm, singular_cols):
        self.n = n
        self.Lp, self.Li, self.Lx = Lp, Li, Lx
        self.D = D
        self.perm = np.asarray(perm)
        self.singular_cols = np.asarray(singular_cols)
        self._plan = None
        self._csolve = None

    @property
    def is_singular(self) -> bool:
        return len(self.singular_cols) > 0

    @property
    def fill_nnz(self) -> int:
        return len(self.Lx)

    def solve_plan(self) -> LDLTSolvePlan:
        """Device solve plan (level-scheduled sweeps with the same
        dense-tail hybrid as SparseLU.solve_plan: the trailing separator
        clique solves as blocked matmuls; jittable)."""
        if self._plan is None:
            def factor_plan(Fp, Fi, Fx, lower):
                if not self.is_singular:
                    tail = choose_dense_tail(self.n, Fp, Fi)
                    if tail:
                        return DenseTailTriSolvePlan(
                            self.n, Fp, Fi, Fx, lower=lower, tail=tail)
                return TriSolvePlan(self.n, Fp, Fi, Fx, lower=lower)

            lplan = factor_plan(self.Lp, self.Li, self.Lx, True)
            # L^T in CSC form = the upper-triangular transpose
            from ..ops import construct

            lt = construct.transpose(
                CSC(self.n, self.n, self.Lp, self.Li, self.Lx,
                    canonical=True))
            ip, rows, vals = lt.np_arrays()
            ltplan = factor_plan(ip, rows, vals, False)
            with np.errstate(divide="ignore"):
                dinv = np.where(self.D != 0, 1.0 / self.D, np.inf)
            # dinv/perm stay HOST numpy: complex state then embeds as HLO
            # constants under closure-jit (utils.xfer policy), and real
            # state uploads once like any pytree leaf
            self._plan = LDLTSolvePlan(lplan, ltplan, dinv, self.perm)
        return self._plan

    def _warn_singular(self):
        if self.is_singular:
            import warnings

            warnings.warn(
                f"matrix is singular at columns "
                f"{self.singular_cols[:8]}...; solution contains inf/nan")

    def solve(self, b):
        """x = A^{-1} b (device path; see SparseLU.solve for the complex
        transfer policy)."""
        self._warn_singular()
        plan = self.solve_plan()
        if np.iscomplexobj(self.Lx) or np.iscomplexobj(np.asarray(b)):
            from ..utils.xfer import split, splitc, unsplit

            bh = np.asarray(b)
            if not np.iscomplexobj(bh):
                bh = bh.astype(np.result_type(bh.dtype, self.Lx.dtype))
            if self._csolve is None:  # compile once, like SparseLU._csolve
                self._csolve = jax.jit(splitc(plan))
            return unsplit(self._csolve(split(bh)))
        return plan(b)

    def solve_host(self, b):
        """Host (numpy) solve — oracle path, full factor precision."""
        self._warn_singular()
        b = np.asarray(b)
        bp = b[self.perm]
        y = lsolve(self.Lp, self.Li, self.Lx, bp)
        with np.errstate(divide="ignore", invalid="ignore"):
            y = (y.T / self.D).T if y.ndim == 2 else y / self.D
        z = ltsolve(self.Lp, self.Li, self.Lx, y)
        x = np.zeros_like(z)
        x[self.perm] = z
        return x


def _ldlt_dense_fallback(n, Ap, Ai, Ax):
    """scipy.linalg.ldl on the dense form (no native extension)."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    A = sp.csc_matrix((Ax, Ai, Ap), shape=(n, n)).toarray()
    lu, d, p = sla.ldl(A, lower=True, hermitian=False)
    if not np.array_equal(p, np.arange(n)):
        raise ValueError(
            "dense LDL fallback pivoted (matrix needs 2x2 pivots); "
            "the native kernel (make -C native) is required here")
    if np.abs(d - np.diag(np.diag(d))).max() > 0:
        raise ValueError("2x2 pivot blocks — not LDL^T factorable "
                         "without pivoting")
    L = sp.csc_matrix(lu)
    sing = np.flatnonzero(np.diag(d) == 0)
    return (L.indptr.astype(np.int64), L.indices.astype(np.int64),
            L.data, np.diag(d).copy(), sing)


def ldlt(a: CSC, ordering="amd") -> SparseLDLT:
    """Factor symmetric ``a`` (both triangles stored) as P A P^T = L D L^T.

    ordering: 'amd' (default) | 'rcm' | 'nd' | None | permutation array.
    No numeric pivoting — intended for (block) diagonally dominant
    symmetric systems (B', B'', Laplacians) and complex-symmetric Ybus;
    indefinite systems needing 2x2 pivots should use linalg.splu.
    """
    n, m = a.shape
    if n != m:
        raise ValueError(f"ldlt requires a square matrix, got {a.shape}")
    if not a.canonical:
        from ..ops.construct import canonicalize

        a = canonicalize(a)
    if ordering is None:
        perm = np.arange(n)
        ap = a
    else:
        perm = np.asarray(ordering_mod.get_ordering(ordering, a))
        if np.array_equal(perm, np.arange(n)):
            ap = a
        else:
            from ..ops.slicing import submatrix

            ap = submatrix(a, perm, perm)
    Ap, Ai, Ax = ap.np_arrays()
    try:
        from ..native import host_ext

        Lp, Li, Lx, D, sing = host_ext.ldlt_factor(n, Ap, Ai, Ax)
    except ImportError:
        Lp, Li, Lx, D, sing = _ldlt_dense_fallback(n, Ap, Ai, Ax)
    return SparseLDLT(n, Lp, Li, Lx, D, perm, sing)
