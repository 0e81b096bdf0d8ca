"""SpMV / SpMM.

Reference kernels: csc_matvec column-scatter (src/sparsetools/csc.h:28-45),
csc_matvecs (csc.h:69-84), in-package csc_mat_vec_ff
(src/CSparse3/csc_numba.py:309-328), csr_matvec row-gather dot
(src/sparsetools/csr.h:1122-1137).

Device mapping (SURVEY §7): the scatter loop becomes

    y = segment_sum(data * x[col_of_entry], row_of_entry, num_segments=m)

one gather + one segment reduction, both single fused XLA HLOs.  For
multi-RHS SpMM the same shape feeds matmuls via the BSR path
(block-dense submatrices x dense RHS panels, see ``bsr_spmm``).

``SpMVPlan`` precomputes the per-entry (row, col) streams once so repeated
products (power-flow iterations) pay zero structural overhead — the static
analogue of the reference reusing its CSC arrays across calls.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_config
from ..types import BSR, CSC
from . import construct

__all__ = [
    "spmv", "spmm", "SpMVPlan", "SplitSpMV", "DIAPlan", "SplitDIA",
    "SymDIAPlan", "SplitSymDIA", "bsr_spmm", "dia_spmv",
]


def _entry_streams(a: CSC):
    k = a.nnz
    rows = a.indices[:k]
    cols = construct.expand_indptr(a.indptr, k)
    return rows, cols, a.data[:k]


def _spmv_xla(rows, cols, vals, m, x):
    return jax.ops.segment_sum(vals * x[cols], rows, num_segments=m)


def _spmm_xla(rows, cols, vals, m, X):
    return jax.ops.segment_sum(vals[:, None] * X[cols, :], rows, num_segments=m)


_BACKENDS = ("xla", "numpy")


def _backend(backend):
    backend = backend or get_config().backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{_BACKENDS}")
    return backend


def spmv(a: CSC, x, *, backend: str | None = None):
    """y = A @ x  (reference: csc_matvec, csc.h:28-45)."""
    backend = _backend(backend)
    x = jnp.asarray(x)
    if x.shape[0] != a.n:
        raise ValueError(f"dim mismatch: A is {a.shape}, x is {x.shape}")
    rows, cols, vals = _entry_streams(a)
    if backend == "numpy":
        y = np.zeros(a.m, dtype=np.result_type(vals.dtype, x.dtype))
        np.add.at(y, np.asarray(rows), np.asarray(vals) * np.asarray(x)[np.asarray(cols)])
        return jnp.asarray(y)
    return _spmv_xla(rows, cols, vals, a.m, x)


def spmm(a: CSC, X, *, backend: str | None = None):
    """Y = A @ X for dense multi-RHS X of shape (n, k)
    (reference: csc_matvecs, csc.h:69-84)."""
    backend = _backend(backend)
    X = jnp.asarray(X)
    if X.shape[0] != a.n:
        raise ValueError(f"dim mismatch: A is {a.shape}, X is {X.shape}")
    rows, cols, vals = _entry_streams(a)
    if backend == "numpy":
        Y = np.zeros((a.m, X.shape[1]), dtype=np.result_type(vals.dtype, X.dtype))
        np.add.at(
            Y, np.asarray(rows), np.asarray(vals)[:, None] * np.asarray(X)[np.asarray(cols)]
        )
        return jnp.asarray(Y)
    return _spmm_xla(rows, cols, vals, a.m, X)


class SpMVPlan:
    """Precomputed structure for repeated y = A x with a fixed pattern.

    Two device layouts, chosen at build time:

    * ``'ell'`` (default when rows are boundedly dense): the matrix is
      re-laid-out as padded row-major (m, W) ``cols``/``vals`` slabs — an
      ELLPACK.  SpMV is then W gathers + a dense multiply-accumulate and
      contains NO scatter (scatters serialize on conflicts).  Power-grid Ybus
      rows have degree <= max bus fanout, so W stays ~6-12 and padding
      waste is small.
    * ``'stream'``: per-entry (row, col, val) streams + one segment_sum —
      the general fallback when the max row degree is an outlier
      (W * m >> nnz).

    A pytree: pass into jitted solvers; only values participate in AD.
    """

    def __init__(self, a: CSC, layout: str | None = None, max_waste: float = 4.0):
        self.m, self.n = a.shape
        if construct.container_traced(a):
            # traced structure: only the stream layout is buildable
            rows, cols, vals = _entry_streams(a)
            self.layout = "stream"
            self.rows, self.cols, self.vals = rows, cols, vals
            return
        ip, rows_np, vals_np = a.np_arrays()
        cols_np = construct.expand_indptr_np(ip)
        counts = np.bincount(rows_np, minlength=self.m)
        W = int(counts.max()) if counts.size else 0
        if layout is None:
            layout = (
                "ell"
                if W and W * self.m <= max_waste * max(len(rows_np), 1)
                else "stream"
            )
        self.layout = layout
        if layout == "stream":
            self.rows = jnp.asarray(rows_np)
            self.cols = jnp.asarray(cols_np)
            self.vals = jnp.asarray(vals_np)
            return
        # ELL: row-major resort, pad each row to W
        W = max(W, 1)
        order = np.argsort(
            rows_np.astype(np.int64) * self.n + cols_np, kind="stable")
        r_s, c_s, v_s = rows_np[order], cols_np[order], vals_np[order]
        slot = np.arange(len(r_s)) - np.concatenate([[0], np.cumsum(counts)])[r_s]
        ell_cols = np.zeros((self.m, W), dtype=np.int32)
        ell_vals = np.zeros((self.m, W), dtype=v_s.dtype)
        ell_cols[r_s, slot] = c_s
        ell_vals[r_s, slot] = v_s
        self.cols = jnp.asarray(ell_cols)
        self.vals = jnp.asarray(ell_vals)
        self.rows = None

    @property
    def W(self) -> int:
        return self.cols.shape[1] if self.layout == "ell" else 0

    def __call__(self, x):
        if getattr(x, "shape", None) is not None and x.ndim >= 1 \
                and x.shape[0] != self.n:
            raise ValueError(
                f"dimension mismatch: plan is for shape ({self.m}, "
                f"{self.n}), x has leading dimension {x.shape[0]}")
        if self.layout == "stream":
            if x.ndim == 1:
                return _spmv_xla(self.rows, self.cols, self.vals, self.m, x)
            return _spmm_xla(self.rows, self.cols, self.vals, self.m, x)
        dtype = jnp.result_type(self.vals.dtype, x.dtype)
        if x.ndim == 1:
            # (m, W) gather + dense row reduction — scatter-free
            return jnp.sum(self.vals * x[self.cols], axis=1).astype(dtype)
        # multi-RHS: accumulate one ELL slot at a time to keep the gather
        # working set at (m, B) instead of (m, W, B)
        y = jnp.zeros((self.m, x.shape[1]), dtype=dtype)
        for w in range(self.cols.shape[1]):
            y = y + self.vals[:, w, None] * x[self.cols[:, w]]
        return y


def _plan_flatten(p):
    if p.layout == "ell":
        return (p.cols, p.vals), (p.m, p.n, p.layout)
    return (p.rows, p.cols, p.vals), (p.m, p.n, p.layout)


def _plan_unflatten(aux, children):
    obj = object.__new__(SpMVPlan)
    obj.m, obj.n, obj.layout = aux
    if obj.layout == "ell":
        obj.cols, obj.vals = children
        obj.rows = None
    else:
        obj.rows, obj.cols, obj.vals = children
    return obj


jax.tree_util.register_pytree_node(SpMVPlan, _plan_flatten, _plan_unflatten)


def bsr_spmm(a: BSR, X):
    """Y = A @ X with A in matmul-sized BSR blocks: every block row does a
    (R x C) @ (C x k) matmul, then blocks reduce by block-row
    (reference blueprint: bsr_matvecs via dense gemv, bsr.h:823;
    block-Gustavson register blocking, bsr.h:249-316)."""
    X = jnp.asarray(X)
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    nbk = a.nnz_blocks
    mb, nb, R, C = a.mb, a.nb, a.R, a.C
    k = X.shape[1]
    Xp = jnp.zeros((nb * C, k), dtype=X.dtype).at[: a.n].set(X)
    Xb = Xp.reshape(nb, C, k)
    brows = construct.expand_indptr(a.indptr, nbk)
    # (nbk, R, C) @ (nbk, C, k) -> (nbk, R, k) : batched matmuls
    prod = jnp.einsum(
        "brc,bck->brk",
        a.data[:nbk],
        Xb[a.indices[:nbk]],
        preferred_element_type=jnp.result_type(a.data.dtype, X.dtype),
    )
    Yb = jax.ops.segment_sum(prod, brows, num_segments=mb)
    Y = Yb.reshape(mb * R, k)[: a.m]
    return Y[:, 0] if squeeze else Y


def dia_spmv(a, x):
    """y = A @ x for DIA format (reference: dia_matvec,
    src/sparsetools/dia.h:30-58).

    Per diagonal ``off``: y[j - off] += data[i, j] * x[j] over the valid
    j range — on the device this is a shifted dense multiply-add per diagonal
    with NO gathers or scatters, the speed-of-light form for banded
    matrices (RCM-ordered grid Ybus).  Unrolled over the (static, small)
    diagonal count.
    """
    from ..types import DIA

    assert isinstance(a, DIA)
    x = jnp.asarray(x)
    offs = a.np_arrays()[0]
    y = jnp.zeros((a.m,), dtype=jnp.result_type(a.data.dtype, x.dtype))
    for i, off in enumerate(offs):
        off = int(off)
        j_lo = max(0, off)
        j_hi = min(a.n, a.m + off)
        if j_hi <= j_lo:
            continue
        seg = a.data[i, j_lo:j_hi] * x[j_lo:j_hi]
        y = y.at[j_lo - off : j_hi - off].add(seg)
    return y


class SplitSpMV:
    """Split-complex SpMV: a complex matrix held as two real ELL plans.

    XLA decomposes complex arithmetic into real pairs anyway; this plan
    makes the decomposition explicit and fully real:

        y_r = A_r x_r - A_i x_i        y_i = A_r x_i + A_i x_r

    ``__call__`` takes and returns (real, imag) pairs of arrays.  For a
    real matrix A_i is dropped and the two products collapse to one.
    """

    def __init__(self, a: CSC, layout: str | None = None):
        ip, rows, vals = a.np_arrays()
        self.iscomplex = np.iscomplexobj(vals)
        re = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.real),
                 canonical=a.canonical)
        self.re = SpMVPlan(re, layout=layout)
        if self.iscomplex:
            im = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.imag),
                     canonical=a.canonical)
            self.im = SpMVPlan(im, layout=layout)
        else:
            self.im = None

    def __call__(self, xr, xi):
        if self.im is None:
            return self.re(xr), self.re(xi)
        return (
            self.re(xr) - self.im(xi),
            self.re(xi) + self.im(xr),
        )


jax.tree_util.register_pytree_node(
    SplitSpMV,
    lambda p: ((p.re, p.im), (p.iscomplex,)),
    lambda aux, ch: _split_unflatten(aux, ch),
)


def _split_unflatten(aux, ch):
    obj = object.__new__(SplitSpMV)
    obj.iscomplex = aux[0]
    obj.re, obj.im = ch
    return obj


class DIAPlan:
    """Gather-free banded SpMV over row-aligned diagonal slabs.

    For RCM-ordered grid matrices the matvec needs no gather at all.
    The matrix is stored as a DENSE range of diagonals
    [omin, omax] (missing offsets hold zero slabs — RCM bands are nearly
    dense in offset space), so every shifted window of x is a STATIC
    slice: the matvec is a short python-unrolled loop of chunked
    slab * window multiply-accumulates — no gather, no scatter, no
    dynamic slicing, no per-diagonal scan latency.

    Cost model: reads D*n values per matvec (the densified band); beats
    gather-based layouts whenever that is within ~2 orders of magnitude
    of nnz.  A pytree; ``__call__`` takes (n,) or (n, B).
    """

    def __init__(self, a, chunk: int = 8):
        from ..types import DIA
        from . import construct

        d = a if isinstance(a, DIA) else construct.csc_to_dia(a)
        self.m, self.n = d.shape
        offs, data = d.np_arrays()
        offs = offs.astype(np.int64)
        m, n = self.m, self.n
        omin, omax = int(offs.min()), int(offs.max())
        D = omax - omin + 1
        # row-aligned dense-range slabs: ra[o - omin, i] = A[i, i + o]
        ra = np.zeros((D, m), dtype=data.dtype)
        for t, off in enumerate(offs):
            i_lo = max(0, -off)
            i_hi = min(m, n - off)
            if i_hi > i_lo:
                ra[off - omin, i_lo:i_hi] = data[t, i_lo + off : i_hi + off]
        self.omin = omin
        self.chunk = int(chunk)
        self.slabs = jnp.asarray(ra)

    @property
    def ndiag(self) -> int:
        return int(self.slabs.shape[0])

    def __call__(self, x):
        x = jnp.asarray(x)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        m, n = self.m, self.n
        B = x.shape[1]
        D = self.ndiag
        # diagonals per scan step: amortizes step latency without
        # materializing large window stacks
        K = max(1, min(self.chunk, D))
        nsteps = -(-D // K)
        Dp = nsteps * K
        slabs = self.slabs
        if Dp != D:
            slabs = jnp.concatenate(
                [slabs, jnp.zeros((Dp - D, m), slabs.dtype)]
            )
        slabs = slabs.reshape(nsteps, K, m)
        lead = max(0, -self.omin)
        tail = max(0, self.omin + Dp - 1 + m - n)
        xp = jnp.concatenate([
            jnp.zeros((lead, B), x.dtype), x, jnp.zeros((tail, B), x.dtype),
        ])
        base0 = self.omin + lead
        bases = jnp.arange(nsteps, dtype=jnp.int32) * K + base0

        def body(y, slab):
            base, sl = slab
            for k in range(K):
                win = jax.lax.dynamic_slice(
                    xp, (base + k, jnp.zeros((), jnp.int32)), (m, B)
                )
                y = y + win * sl[k][:, None]
            return y, None

        y0 = jnp.zeros((m, B), dtype=jnp.result_type(self.slabs.dtype, x.dtype))
        y, _ = jax.lax.scan(body, y0, (bases, slabs))
        return y[:, 0] if squeeze else y


jax.tree_util.register_pytree_node(
    DIAPlan,
    lambda p: ((p.slabs,), (p.m, p.n, p.omin, p.chunk)),
    lambda aux, ch: _diaplan_unflatten(aux, ch),
)


def _diaplan_unflatten(aux, ch):
    obj = object.__new__(DIAPlan)
    obj.m, obj.n, obj.omin, obj.chunk = aux
    (obj.slabs,) = ch
    return obj


class SymDIAPlan:
    """Symmetric banded SpMV storing only the d >= 0 diagonals — halves
    the slab traffic of ``DIAPlan`` on symmetric matrices (admittance and
    B'/B'' matrices are symmetric absent phase shifters).

    The lower triangle is applied through the *reversed frame*: with
    j' = m-1-j, the mirror sum  y[j] += A[j, j-d] x[j-d]  becomes
    y_rev[j'] += flip(ra_d)[j'+d] * flip(x)[j'+d] — the same shifted-window
    primitive as the upper sum, so both run in one scan over diagonal
    groups and the result is  y_fwd + flip(y_rev).
    """

    def __init__(self, a, chunk: int = 64, check: bool = True, tol: float = 0.0):
        from ..types import DIA
        from . import construct

        d = a if isinstance(a, DIA) else construct.csc_to_dia(a)
        self.m, self.n = d.shape
        if self.m != self.n:
            raise ValueError("SymDIAPlan requires a square matrix")
        offs, data = d.np_arrays()
        offs = offs.astype(np.int64)
        m = self.m
        omax = int(offs.max(initial=0))
        omin = int(offs.min(initial=0))
        if omin < -omax or -omin < omax:
            raise ValueError("matrix bandwidth is not symmetric")
        D = omax + 1
        # ra[d, i] = A[i, i + d] for d >= 0 (upper triangle + diagonal)
        ra = np.zeros((D, m), dtype=data.dtype)
        for t, off in enumerate(offs):
            if off < 0:
                continue
            i_hi = m - off
            if i_hi > 0:
                ra[off, :i_hi] = data[t, off : i_hi + off]
        if check:
            # The mirror pass assumes A[i+d, i] == A[i, i+d]; verify against
            # the stored negative diagonals (data[t, j] = A[j - off, j]).
            for t, off in enumerate(offs):
                if off >= 0:
                    continue
                dd = -off
                lo = data[t, : m - dd]
                if not np.allclose(lo, ra[dd, : m - dd], rtol=tol, atol=tol):
                    raise ValueError(
                        "matrix values are not symmetric (diagonal "
                        f"{off}); use DIAPlan, or check=False to skip"
                    )
        self.chunk = int(chunk)
        K = max(1, min(self.chunk, D))
        nsteps = -(-D // K)
        Dp = nsteps * K
        if Dp != D:
            ra = np.concatenate([ra, np.zeros((Dp - D, m), ra.dtype)])
        # host numpy (see TriSolvePlan note)
        self.slabs = ra.reshape(nsteps, K, m)
        self.omax = omax

    @property
    def ndiag(self) -> int:
        return self.omax + 1

    def __call__(self, x):
        x = jnp.asarray(x)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        m = self.m
        B = x.shape[1]
        nsteps, K, _ = self.slabs.shape
        tail = nsteps * K  # covers every window start
        zpad = jnp.zeros((tail, B), x.dtype)
        xp = jnp.concatenate([x, zpad])
        xr = jnp.concatenate([x[::-1], zpad])
        bases = np.arange(nsteps, dtype=np.int32) * K
        dt = jnp.result_type(self.slabs.dtype, x.dtype)
        zcol = jnp.zeros((tail, 1), dt)
        j0 = jnp.zeros((), jnp.int32)

        def body(c, slab):
            y, yr = c
            base, sl = slab
            for k in range(K):
                d = base + k
                win = jax.lax.dynamic_slice(xp, (d, j0), (m, B))
                y = y + sl[k][:, None] * win
                # mirror (reversed frame), diagonal d=0 excluded
                slf = jnp.concatenate([sl[k][::-1, None].astype(dt), zcol])
                slw = jax.lax.dynamic_slice(slf, (d, j0), (m, 1))
                winr = jax.lax.dynamic_slice(xr, (d, j0), (m, B))
                yr = yr + jnp.where(d > 0, slw * winr, 0)
            return (y, yr), None

        y0 = jnp.zeros((m, B), dtype=dt)
        (y, yr), _ = jax.lax.scan(
            body, (y0, y0), (jnp.asarray(bases), self.slabs)
        )
        out = y + yr[::-1]
        return out[:, 0] if squeeze else out


jax.tree_util.register_pytree_node(
    SymDIAPlan,
    lambda p: ((p.slabs,), (p.m, p.n, p.omax, p.chunk)),
    lambda aux, ch: _symdia_unflatten(aux, ch),
)


def _symdia_unflatten(aux, ch):
    obj = object.__new__(SymDIAPlan)
    obj.m, obj.n, obj.omax, obj.chunk = aux
    (obj.slabs,) = ch
    return obj


class SplitSymDIA:
    """Split-complex symmetric banded SpMV: a complex-symmetric matrix
    (Ybus is complex symmetric, not hermitian) as two real SymDIAPlans.
    Same call convention as ``SplitDIA``."""

    def __init__(self, a, chunk: int = 64, check: bool = True, tol: float = 0.0):
        ip, rows, vals = a.np_arrays()
        from ..types import CSC

        self.iscomplex = np.iscomplexobj(vals)
        re = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.real),
                 canonical=a.canonical)
        self.re = SymDIAPlan(re, chunk=chunk, check=check, tol=tol)
        if self.iscomplex:
            im = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.imag),
                     canonical=a.canonical)
            self.im = SymDIAPlan(im, chunk=chunk, check=check, tol=tol)
        else:
            self.im = None

    def __call__(self, xr, xi):
        if self.im is None:
            return self.re(xr), self.re(xi)
        return (
            self.re(xr) - self.im(xi),
            self.re(xi) + self.im(xr),
        )


jax.tree_util.register_pytree_node(
    SplitSymDIA,
    lambda p: ((p.re, p.im), (p.iscomplex,)),
    lambda aux, ch: _splitsymdia_unflatten(aux, ch),
)


def _splitsymdia_unflatten(aux, ch):
    obj = object.__new__(SplitSymDIA)
    obj.iscomplex = aux[0]
    obj.re, obj.im = ch
    return obj


class SplitDIA:
    """Split-complex banded SpMV: complex matrix as two real DIAPlans.
    ``__call__(xr, xi) -> (yr, yi)``; see SplitSpMV for the algebra."""

    def __init__(self, a, chunk: int = 8):
        ip, rows, vals = a.np_arrays()
        from ..types import CSC

        self.iscomplex = np.iscomplexobj(vals)
        re = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.real),
                 canonical=a.canonical)
        self.re = DIAPlan(re, chunk=chunk)
        if self.iscomplex:
            im = CSC(a.m, a.n, ip, rows, np.ascontiguousarray(vals.imag),
                     canonical=a.canonical)
            self.im = DIAPlan(im, chunk=chunk)
        else:
            self.im = None

    def __call__(self, xr, xi):
        # one batched (n, 2) application per real plan: each slab set is
        # streamed ONCE for both the real and imaginary input vectors
        # (separate calls would read every diagonal twice)
        x2 = jnp.stack([jnp.asarray(xr), jnp.asarray(xi)], axis=1)
        r2 = self.re(x2)
        if self.im is None:
            return r2[:, 0], r2[:, 1]
        i2 = self.im(x2)
        return r2[:, 0] - i2[:, 1], r2[:, 1] + i2[:, 0]


jax.tree_util.register_pytree_node(
    SplitDIA,
    lambda p: ((p.re, p.im), (p.iscomplex,)),
    lambda aux, ch: _splitdia_unflatten(aux, ch),
)


def _splitdia_unflatten(aux, ch):
    obj = object.__new__(SplitDIA)
    obj.iscomplex = aux[0]
    obj.re, obj.im = ch
    return obj
