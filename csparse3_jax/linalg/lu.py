"""Sparse LU: factor + solve API.

New capability vs the reference (SURVEY scope note: "The build must
implement them"): the cs_lu / cs_lsolve / cs_usolve / cs_sqr family of the
original CSparse, with a GridCal-shaped API:

    lu = splu(A, ordering="amd", tol=1.0)   # host factorization, P A Q = L U
    x  = lu.solve(b)                         # b: (n,) or (n, k) batched RHS
    plan = lu.solve_plan()                   # jittable device solver (pytree)
    x  = jax.jit(plan)(b)                    # level-scheduled, static shapes

Factor once / solve many is the GridCal power-flow pattern (Ybus fixed per
topology, thousands of RHS) — the plan keeps L/U on device and the solve is
a lax.scan over dependency levels (linalg/trisolve.py).

``refactor_plan`` additionally supports the KLU-style *device numeric
refactorization*: with pivoting and pattern frozen from a previous host
factorization, new values for A (same pattern) are re-factorized entirely
on device — the hot path for repeated Newton iterations where only values
change.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import CSC
from . import ordering as ordering_mod
from .lu_host import HostLU, lu_factor_host
from .trisolve import TriSolvePlan

__all__ = ["SparseLU", "splu", "spsolve", "SolvePlan"]


@jax.tree_util.register_pytree_node_class
class SolvePlan:
    """Jittable x = A^{-1} b from a factorization: permute, L-solve,
    U-solve, unpermute.  A pytree — pass through jit/vmap/scan freely."""

    def __init__(self, lplan: TriSolvePlan, uplan: TriSolvePlan, perm_r, perm_c):
        self.lplan = lplan
        self.uplan = uplan
        # stored verbatim — host numpy from splu (closure-jit then embeds
        # them as constants, transfer-free), traced values under refactor
        self.perm_r = perm_r  # perm_r[k] = original row of pivot k
        self.perm_c = perm_c  # perm_c[k] = original col of pivot k

    def tree_flatten(self):
        return (self.lplan, self.uplan, self.perm_r, self.perm_c), ()

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.lplan, obj.uplan, obj.perm_r, obj.perm_c = ch
        return obj

    def __call__(self, b):
        b = jnp.asarray(b)
        bp = b[self.perm_r]  # P b
        y = self.lplan.solve(bp)
        z = self.uplan.solve(y)
        # x[perm_c[k]] = z[k]
        x = jnp.zeros_like(z)
        return x.at[self.perm_c].set(z)


class SparseLU:
    """Result of ``splu``: factors as CSC matrices plus permutations.

    Attributes mirror scipy's SuperLU object: L (unit lower), U (upper),
    perm_r, perm_c, plus ``singular_cols`` (SuperLU info-style reporting,
    reference breadcrumb: src/research/scipy_wrappers.py:7-10).
    """

    def __init__(self, host: HostLU, dtype, method: str = "gp"):
        self._h = host
        #: which factorization kernel produced this object:
        #: 'supernodal' (BLAS-3 multifrontal, within-front pivoting) or
        #: 'gp' (scalar Gilbert-Peierls with threshold partial pivoting)
        self.method = method
        n = host.n
        self.n = n
        self.L = CSC(n, n, host.Lp, host.Li, host.Lx)
        self.U = CSC(n, n, host.Up, host.Ui, host.Ux)
        self.perm_r = host.perm_r
        self.perm_c = host.perm_c
        self.singular_cols = host.singular_cols
        self._plan: Optional[SolvePlan] = None
        self._plan_style = None
        self._csolve = None  # cached jitted transfer-safe complex solver
        self._rsolve = None  # cached jitted real solver

    @property
    def is_singular(self) -> bool:
        return len(self.singular_cols) > 0

    @property
    def lnz(self) -> int:
        return self.L.nnz

    @property
    def unz(self) -> int:
        return self.U.nnz

    def solve_plan(self, style: str = "auto") -> SolvePlan:
        """Jittable device solver.

        style='auto' (default): each factor gets a dense matmul-blocked tail
        when its trailing corner is dense (the separator clique under
        amd/nd orderings — absorbs most dependency levels); 'level' forces
        the pure level-scheduled plan (the RefactorPlan template layout).
        """
        if style not in ("auto", "level"):
            raise ValueError(f"unknown solve_plan style {style!r}")
        if self._plan is None or style != self._plan_style:
            from .trisolve import DenseTailTriSolvePlan, choose_dense_tail

            h = self._h

            def factor_plan(Fp, Fi, Fx, lower):
                # singular factors carry an exact-zero pivot: the level
                # plan propagates it as inf/nan (SuperLU-style), while the
                # dense tail's block inverse would raise — keep 'level'
                if style == "auto" and not self.is_singular:
                    tail = choose_dense_tail(self.n, Fp, Fi)
                    if tail:
                        return DenseTailTriSolvePlan(
                            self.n, Fp, Fi, Fx, lower=lower, tail=tail
                        )
                return TriSolvePlan(self.n, Fp, Fi, Fx, lower=lower)

            lplan = factor_plan(h.Lp, h.Li, h.Lx, True)
            uplan = factor_plan(h.Up, h.Ui, h.Ux, False)
            self._plan = SolvePlan(lplan, uplan, h.perm_r, h.perm_c)
            self._plan_style = style
        return self._plan

    def banded_solve_plan(self, s: int | None = None):
        """Block-bidiagonal matmul solve plan (linalg.banded) — requires a
        no-row-exchange banded factorization (ordering='rcm', tol=0 on a
        diagonally dominant matrix).  Falls back with ValueError if the
        factors exceed the block bandwidth."""
        from .banded import BandedSolvePlan

        return BandedSolvePlan(self._h, s=s)

    def refactor_plan(self, a: CSC) -> "RefactorPlan":
        """KLU-style device refactorization plan: freeze this
        factorization's pattern and pivoting, then ``plan.refactor(data)``
        re-factors a same-pattern matrix entirely on device (jittable;
        vmap over data for batched factorizations).  ``a`` must be the
        canonical CSC this LU was computed from."""
        from .refactor import RefactorPlan

        return RefactorPlan(self._h, a)

    def solve(self, b):
        """x = A^{-1} b (b: (n,) or (n, k)).

        Real systems return a device array.  Complex systems cross the
        host<->device boundary as float pairs (utils.xfer) and return a
        host numpy array; use ``solve_plan()`` directly to keep complex
        results on device for chaining.
        """
        if self.is_singular:
            import warnings

            warnings.warn(
                f"matrix is singular at columns {self.singular_cols[:8]}...; "
                "solution contains inf/nan (SuperLU-compatible behavior)"
            )
        plan = self.solve_plan()
        complex_factors = np.iscomplexobj(self._h.Lx)
        if complex_factors or np.iscomplexobj(np.asarray(b)):
            from ..utils.xfer import split, splitc, unsplit

            bh = np.asarray(b)
            if not np.iscomplexobj(bh):
                # complex factors ⇒ complex result; promote b so split()
                # packs it and the (…, 2) pair layout is unambiguous
                bh = bh.astype(np.result_type(bh.dtype, self._h.Lx.dtype))
            if self._csolve is None:
                self._csolve = jax.jit(splitc(plan))
            return unsplit(self._csolve(split(bh)))
        # jit the level-scheduled composite: eagerly it is hundreds of
        # individually dispatched ops
        if self._rsolve is None:
            self._rsolve = jax.jit(lambda p, bb: p(bb))
        return self._rsolve(plan, b)

    def solve_host(self, b):
        """Host (numpy) solve — oracle path."""
        from .trisolve import lsolve, usolve

        h = self._h
        b = np.asarray(b)
        bp = b[h.perm_r]
        y = lsolve(h.Lp, h.Li, h.Lx, bp)
        z = usolve(h.Up, h.Ui, h.Ux, y)
        x = np.zeros_like(z)
        x[h.perm_c] = z
        return x


def _pattern_symmetry(n, ip, ix) -> float:
    """Fraction of off-diagonal entries whose transposed position is also
    in the pattern (1.0 = structurally symmetric)."""
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
    rows = np.asarray(ix, dtype=np.int64)
    off = rows != cols
    if not off.any():
        return 1.0
    k = rows[off] * n + cols[off]
    kt = cols[off] * n + rows[off]
    return len(np.intersect1d(k, kt, assume_unique=False)) / len(k)


def splu(a: CSC, ordering="auto", tol: float = 1.0,
         mode: str = "auto") -> SparseLU:
    """Factor P A Q = L U with partial pivoting.

    ordering: 'auto' (default — nested dissection when the supernodal
    kernel will run, since it produces large clustered fronts; min-degree
    otherwise, whose scattered supernodes suit the scalar kernel), 'amd',
    'nd', 'rcm', 'natural', a permutation array, or a callable.  tol:
    diagonal-preference threshold (1.0 = strict partial pivoting, smaller
    favors sparsity-preserving diagonal pivots).

    mode selects the numeric kernel:

    * 'auto' (default) — the BLAS-3 supernodal multifrontal kernel
      (native/lu_sn.cpp) when the problem suits it (native extension
      present, n >= 512, strict-pivot request, near-symmetric pattern),
      with an element-growth check and fallback to the scalar kernel;
    * 'supernodal' — force the multifrontal kernel (falls back only if
      the native kernel declines, e.g. an exactly singular block);
    * 'gp' — force the scalar Gilbert-Peierls kernel (threshold partial
      pivoting; the only mode that honors ``tol`` and supports the
      no-row-exchange tol=0 contract of ``banded_solve_plan``).
    """
    if a.m != a.n:
        raise ValueError(f"LU requires a square matrix, got {a.shape}")
    if mode not in ("auto", "supernodal", "gp"):
        raise ValueError(f"unknown splu mode {mode!r}")
    ip, ix, dt = a.np_arrays()
    native = None
    try:
        from ..native import host_ext as native
    except ImportError:
        pass

    use_sn = native is not None and mode in ("auto", "supernodal") and (
        mode == "supernodal" or (
            tol == 1.0 and a.n >= 512
            and _pattern_symmetry(a.n, ip, ix) >= 0.9
        )
    )
    if isinstance(ordering, str) and ordering == "auto":
        ordering = "nd" if use_sn else "amd"
    q = ordering_mod.get_ordering(ordering, a)

    host = None
    method = "gp"
    if use_sn:
        host = native.lu_factor_sn(a.n, ip, ix, dt, q)
        if host is not None:
            method = "supernodal"
            if mode == "auto":
                # within-front pivoting only: verify element growth
                amax = float(np.abs(dt).max()) if len(dt) else 0.0
                umax = float(np.abs(host.Ux).max()) if len(host.Ux) else 0.0
                if not np.isfinite(umax) or umax > 1e7 * max(amax, 1e-300):
                    host, method = None, "gp"
    if host is None:
        if native is not None:
            host = native.lu_factor(a.n, ip, ix, dt, q, tol)
        else:
            host = lu_factor_host(a.n, ip, ix, dt, q, tol)
    return SparseLU(host, dt.dtype, method=method)


def spsolve(a: CSC, b, ordering="auto", tol: float = 1.0):
    """x = A^{-1} b (factor + solve; reference breadcrumb
    src/research/scipy_wrappers.py shows the scipy spsolve equivalent)."""
    return splu(a, ordering=ordering, tol=tol).solve(b)
