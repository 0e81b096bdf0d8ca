"""Banded (block-bidiagonal) triangular solves — the matmul solve path.

For RCM-ordered, diagonally-dominant systems factored WITHOUT row
exchanges (``splu(A, ordering='rcm', tol=0)``), L and U keep the
original bandwidth.  Chunk rows into blocks of size s >= bandwidth and
the factors become block *bidiagonal*:

    L x = b:   x_k = invL_kk @ (b_k - L_{k,k-1} @ x_{k-1})    (forward)
    U x = b:   x_k = invU_kk @ (b_k - U_{k,k+1} @ x_{k+1})    (backward)

Diagonal-block inverses are precomputed on host, so the device solve is
a ``lax.scan`` of two (s x s) @ (s x B) matmuls per block — pure matmul
work: no gathers, no scatters, no per-level scheduling.  n/s sequential
steps instead of the level count (e.g. 24 steps vs ~570 levels at
n=3000), and each step is dense enough to fill the matrix units for batched
RHS.

This is the device answer for the factor-once / solve-many
power-flow pattern when the matrix is (near-)banded — which RCM makes
true for transmission grids.  General (non-banded) factors keep using
the level-scheduled ``TriSolvePlan``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BandedLU", "BandedRefactor", "BandedSolvePlan",
           "ComplexBandedSolve", "bandwidth",
           "thomas_factor_device", "thomas_sweeps"]


def bandwidth(Fp, Fi):
    """Max |row - col| over the CSC entries."""
    Fp = np.asarray(Fp)
    Fi = np.asarray(Fi)
    n = len(Fp) - 1
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
    if len(cols) == 0:
        return 0
    return int(np.abs(Fi.astype(np.int64) - cols).max())


def _inv(blocks):
    """Batched inverse computed in double precision.

    numpy's float32 getri path is ~100x slower than the float64 one on
    this host (measured: 72 s vs 0.74 s for a (106, 472, 472) stack), so
    always invert in f64/c128 and cast back to the requested dtype.
    """
    dt = blocks.dtype
    wide = np.complex128 if np.iscomplexobj(blocks) else np.float64
    return _downcast(np.linalg.inv(blocks.astype(wide, copy=False)), dt)


def _downcast(a, dtype):
    """astype with subnormal flushing (see utils.flush_subnormals: mixed
    f32-subnormal casts are ~100-300x slower on this host, and factor
    fill-in decays into that range)."""
    from ..utils.hostmem import flush_subnormals

    if np.dtype(dtype).itemsize < a.dtype.itemsize:
        flush_subnormals(a, np.float32)
    return a.astype(dtype, copy=False)


def _dense_blocks(n, Fp, Fi, Fx, s, lower, dtype=None):
    """(nb, s, s) diagonal blocks and (nb, s, s) off-diagonal blocks of a
    banded triangular CSC, zero-padded to nb*s rows; the padded tail gets
    a unit diagonal."""
    nb = -(-n // s)
    N = nb * s
    if dtype is None:
        dtype = Fx.dtype
    diag = np.zeros((nb, s, s), dtype=dtype)
    off = np.zeros((nb, s, s), dtype=dtype)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
    rows = np.asarray(Fi).astype(np.int64)
    vals = _downcast(np.asarray(Fx).copy(), dtype)
    kb_r, kb_c = rows // s, cols // s
    same = kb_r == kb_c
    diag[kb_r[same], rows[same] % s, cols[same] % s] = vals[same]
    adj = (kb_r == kb_c + 1) if lower else (kb_r == kb_c - 1)
    tgt = kb_r[adj] if lower else kb_r[adj]
    off[tgt, rows[adj] % s, cols[adj] % s] = vals[adj]
    bad = ~(same | adj)
    if bad.any():
        raise ValueError(
            f"factor bandwidth exceeds block size {s}; "
            f"{int(bad.sum())} entries outside the block bidiagonal"
        )
    for i in range(n, N):
        diag[i // s, i % s, i % s] = 1.0
    return diag, off


def _tridiag_blocks(n, Ap, Ai, Ax, s, dtype):
    """(nb,s,s) diagonal D, subdiagonal E and superdiagonal F blocks of a
    banded square CSC, zero-padded to nb*s rows with a unit diagonal on
    the padded tail.  E[k] couples block k to k-1 (E[0] = 0); F[k]
    couples block k to k+1 (F[nb-1] = 0)."""
    nb = -(-n // s)
    D = np.zeros((nb, s, s), dtype=dtype)
    E = np.zeros((nb, s, s), dtype=dtype)
    F = np.zeros((nb, s, s), dtype=dtype)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(np.asarray(Ap)))
    rows = np.asarray(Ai).astype(np.int64)
    vals = np.asarray(Ax).astype(dtype, copy=False)
    kb_r, kb_c = rows // s, cols // s
    same = kb_r == kb_c
    D[kb_r[same], rows[same] % s, cols[same] % s] = vals[same]
    sub = kb_r == kb_c + 1
    E[kb_r[sub], rows[sub] % s, cols[sub] % s] = vals[sub]
    sup = kb_r == kb_c - 1
    F[kb_r[sup], rows[sup] % s, cols[sup] % s] = vals[sup]
    bad = ~(same | sub | sup)
    if bad.any():
        raise ValueError(
            f"matrix bandwidth exceeds block size {s}; "
            f"{int(bad.sum())} entries outside the block tridiagonal")
    for i in range(n, nb * s):
        D[i // s, i % s, i % s] = 1.0
    return D, E, F


def is_symmetric_csc(n, Ap, Ai, Ax) -> bool:
    """Exact structural+numeric symmetry of a canonical CSC (host)."""
    from ..ops.construct import transpose
    from ..types import CSC

    t = transpose(CSC(n, n, np.asarray(Ap), np.asarray(Ai),
                      np.asarray(Ax), canonical=True))
    Tp, Ti, Tx = t.np_arrays()
    return (np.array_equal(np.asarray(Tp, dtype=np.int64),
                           np.asarray(Ap, dtype=np.int64))
            and np.array_equal(np.asarray(Ti, dtype=np.int64),
                               np.asarray(Ai, dtype=np.int64))
            and np.array_equal(np.asarray(Tx), np.asarray(Ax)))


def _thomas_factor(n, s, nb, rows, cols, vals, dtype, wide, sym=False):
    """Streaming block-Thomas factorization of the block-tridiagonal
    system given by 0-based COO entries.

    Returns (ehat, sinv, uhat) stacks of shape (nb, s, s) in ``dtype``:
    Ehat_k = E_k S_{k-1}^{-1}, S_k^{-1}, Uhat_k = S_k^{-1} F_k with
    S_k = D_k - Ehat_k F_{k-1}.  Rows n..nb*s get a unit diagonal (pad).
    Only the output stacks are materialized; the f64 recurrence state is
    rolling (s, s) buffers (this sandbox's populate rate collapses to
    ~10 MB/s beyond a few GB of fresh mappings, so the six-stack f64
    layout costs minutes at 100k nodes where this costs seconds).

    ``sym=True`` (caller-verified SYMMETRIC input, real or complex):
    every Schur complement S_k is then symmetric and E_k = F_{k-1}^T, so
    Ehat_k = (Sinv_{k-1} F_{k-1})^T = Uhat_{k-1}^T — the E scatter, the
    Ek @ Sinv gemm and its downcast all drop out (6.2 -> 4.5 s at 100k).
    (A dpotrf/dpotri Cholesky inversion was measured FASTER in isolation
    but 5x slower in-loop: its per-block triangle-mirror temporaries hit
    this sandbox's fresh-page cliff — keep the allocation-light getri.)
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals).astype(wide, copy=False)
    kb_r, kb_c = rows // s, cols // s
    if (np.abs(kb_r - kb_c) > 1).any():
        nbad = int((np.abs(kb_r - kb_c) > 1).sum())
        raise ValueError(
            f"matrix bandwidth exceeds block size {s}; "
            f"{nbad} entries outside the block tridiagonal")
    order = np.argsort(kb_c, kind="stable")
    kb_c_s = kb_c[order]
    starts = np.searchsorted(kb_c_s, np.arange(nb + 1))
    lr, lc = (rows % s)[order], (cols % s)[order]
    dr = (kb_r - kb_c)[order]  # -1 (super of prev), 0 (diag), +1 (sub)
    vs = vals[order]

    ehat = np.zeros((nb, s, s), dtype=dtype)
    sinv = np.empty((nb, s, s), dtype=dtype)
    uhat = np.empty((nb, s, s), dtype=dtype)
    # block column k of the CSC holds: D_k (d=0), E_{k+1} (d=+1, rows
    # one block down) and F_{k-1} (d=-1, rows one block up)
    Dk = np.zeros((s, s), dtype=wide)
    Ek = np.zeros((s, s), dtype=wide)      # E_k, stashed at col k-1
    Enext = np.zeros((s, s), dtype=wide)
    Fk = np.zeros((s, s), dtype=wide)      # F_k, read ahead at col k+1
    Fprev = np.zeros((s, s), dtype=wide)
    Sinv_prev = None
    Uprev = None                           # f64 Uhat_{k-1} (sym path)
    pad0 = n // s  # first block containing padded rows
    for k in range(nb):
        lo, hi = starts[k], starts[k + 1]
        r, c, d, v = lr[lo:hi], lc[lo:hi], dr[lo:hi], vs[lo:hi]
        Dk[:] = 0.0
        m0 = d == 0
        Dk[r[m0], c[m0]] = v[m0]
        if not sym:
            Enext[:] = 0.0
            m1 = d == 1
            Enext[r[m1], c[m1]] = v[m1]
        Fk[:] = 0.0
        if k + 1 < nb:
            lo2, hi2 = starts[k + 1], starts[k + 2]
            m2 = dr[lo2:hi2] == -1
            Fk[lr[lo2:hi2][m2], lc[lo2:hi2][m2]] = vs[lo2:hi2][m2]
        if k >= pad0:
            # unit diagonal on padded rows so S_k stays nonsingular
            i0 = max(n - k * s, 0)
            idx = np.arange(i0, s)
            Dk[idx, idx] = 1.0
        if k:
            if sym:
                # Eh = E_k Sinv_{k-1} = (Sinv_{k-1} F_{k-1})^T = Uprev^T
                S = Dk - Uprev.T @ Fprev
                ehat[k] = uhat[k - 1].T  # downcast(Uprev)^T, exactly
            else:
                Eh = Ek @ Sinv_prev
                S = Dk - Eh @ Fprev
                ehat[k] = _downcast(Eh, dtype)
        else:
            S = Dk.copy()
        Sinv = np.linalg.inv(S)
        sinv[k] = _downcast(Sinv, dtype)
        Uk = Sinv @ Fk
        uhat[k] = _downcast(Uk, dtype)
        Sinv_prev = Sinv
        Uprev = Uk
        Fprev, Fk = Fk, Fprev
        if not sym:
            Ek, Enext = Enext, Ek
    return ehat, sinv, uhat


def thomas_sweeps(ehat, sinv, uhat, bb, precision="highest"):
    """Device block-Thomas solve: bb (nb, s, B) -> x blocks (nb, s, B).

    Two ``lax.scan`` sweeps of (s,s)@(s,B) matmuls — pure matmul work:
    y_k = b_k - Ehat_k y_{k-1} (forward), x_k = S_k^{-1} y_k - Uhat_k
    x_{k+1} (backward).  ``precision`` trades sweep accuracy for speed:
    'highest' (full f32, the default), or a cheaper preset such as
    'default' (TF32 on the GPU — pair with iterative refinement)."""
    # HIGHEST default: full-f32 products.  On the GPU the default f32
    # matmul may run in TF32 (10-bit mantissa), and that rounding
    # compounds through the nb-block recurrence
    with jax.default_matmul_precision(precision):
        def fwd(y_prev, blk):
            eh, rhs = blk
            y_k = rhs - eh @ y_prev
            return y_k, y_k

        # derive the zero carry from the operands so it inherits their
        # varying-manual-axes type under shard_map (a plain jnp.zeros carry
        # is 'unvarying' and scan rejects the mismatch)
        z0 = bb[0] * 0
        _, y = jax.lax.scan(fwd, z0, (ehat, bb))

        def bwd(x_next, blk):
            si, uh, rhs = blk
            x_k = si @ rhs - uh @ x_next
            return x_k, x_k

        _, x = jax.lax.scan(bwd, z0, (sinv, uhat, y), reverse=True)
    return x


def thomas_factor_device(D, E, F):
    """Device block-Thomas factorization: (nb, s, s) block-tridiagonal
    stacks -> (ehat, sinv, uhat) plan stacks, entirely on device.

    One ``lax.scan`` step per block: a batched (s,s) inverse (XLA LU)
    plus three (s,s)@(s,s) matmuls.  E[0] must be zero, so the
    k = 0 step degenerates correctly with a zero carry."""
    # HIGHEST: see thomas_sweeps — reduced-precision (TF32) products
    # compound through the recurrence and the explicit inverses
    with jax.default_matmul_precision("highest"):
        def step(carry, blk):
            Sinv_prev, Fprev = carry
            Dk, Ek, Fk = blk
            Eh = Ek @ Sinv_prev
            S = Dk - Eh @ Fprev
            Sinv = jnp.linalg.inv(S)
            Uh = Sinv @ Fk
            return (Sinv, Fk), (Eh, Sinv, Uh)

        z = D[0] * 0
        _, (ehat, sinv, uhat) = jax.lax.scan(step, (z, z), (D, E, F))
    return ehat, sinv, uhat


def thomas_factor_device_sym(D, F):
    """Symmetric-input device block-Thomas factorization.

    For a symmetric block-tridiagonal matrix E_k = F_{k-1}^T and every
    Schur complement S_k is symmetric, so Ehat_k = (Sinv_{k-1} F_{k-1})^T
    = Uhat_{k-1}^T — the E stack and one of the three (s,s) matmuls per
    block drop out (the device twin of ``_thomas_factor(sym=True)``).
    Returns only (sinv, uhat); pair with ``thomas_sweeps_sym``."""
    with jax.default_matmul_precision("highest"):
        def step(carry, blk):
            Uprev, Fprev = carry
            Dk, Fk = blk
            S = Dk - Uprev.T @ Fprev
            Sinv = jnp.linalg.inv(S)
            Uh = Sinv @ Fk
            return (Uh, Fk), (Sinv, Uh)

        z = D[0] * 0
        _, (sinv, uhat) = jax.lax.scan(step, (z, z), (D, F))
    return sinv, uhat


def thomas_sweeps_sym(sinv, uhat, bb, precision="highest"):
    """``thomas_sweeps`` for factors from ``thomas_factor_device_sym``:
    the forward sweep reads Ehat_k as Uhat_{k-1}^T instead of a stored
    E-hat stack."""
    with jax.default_matmul_precision(precision):
        z0 = bb[0] * 0
        zs = uhat[0] * 0
        uh_prev = jnp.concatenate([zs[None], uhat[:-1]], axis=0)

        def fwd(y_prev, blk):
            uhp, rhs = blk
            y_k = rhs - uhp.T @ y_prev
            return y_k, y_k

        _, y = jax.lax.scan(fwd, z0, (uh_prev, bb))

        def bwd(x_next, blk):
            si, uh, rhs = blk
            x_k = si @ rhs - uh @ x_next
            return x_k, x_k

        _, x = jax.lax.scan(bwd, z0, (sinv, uhat, y), reverse=True)
    return x


def spike_tips_device(sinv, uhat, Bp, Cp, ehat=None, precision="highest"):
    """Interface blocks of the SPIKE spikes WITHOUT materializing them.

    W = T^{-1}[B; 0; ..; 0], V = T^{-1}[0; ..; 0; C]; only W's and V's
    first/last (s, s) blocks enter the reduced interface system.  Both
    recurrences carry a single (s, s) block:

      W: y_0 = B,     y_k = -Ehat_k y_{k-1}         (forward chain)
         x_{m-1} = Sinv_{m-1} y_{m-1},  x_k = Sinv_k y_k - Uhat_k x_{k+1}
      V: x_{m-1} = Sinv_{m-1} C,        x_k = -Uhat_k x_{k+1}

    Cost 8 m s^3 flops total vs 12 m s^3 for two full spike sweeps, and
    O(s^2) memory instead of O(m s^2) per spike (the full (m s, s)
    spikes at 1M nodes / s = 2560 are 20 GB the recompute-variant solve
    never needs).  ``ehat=None`` takes the symmetric path
    (Ehat_k = Uhat_{k-1}^T).  Returns (Wt, Wb, Vt, Vb)."""
    m = sinv.shape[0]
    with jax.default_matmul_precision(precision):
        if ehat is None:
            zs = uhat[0] * 0
            eh_seq = jnp.concatenate([zs[None], uhat[:-1]], axis=0)

            def wfwd(y_prev, uhp):
                y = -(uhp.T @ y_prev)
                return y, y
        else:
            eh_seq = ehat

            def wfwd(y_prev, ehk):
                y = -(ehk @ y_prev)
                return y, y

        # forward chain of W's RHS propagation, seeded with y_0 = B
        _, ytail = jax.lax.scan(wfwd, Bp, eh_seq[1:])
        y = jnp.concatenate([Bp[None], ytail], axis=0)     # (m, s, s)

        # backward sweeps carry a single (s, s) block and emit NOTHING
        # (stacking the per-step outputs materialized 2 x (m, s, s)
        # buffers = 20 GB of transients at 1M/s=2560); the bottom tips
        # come straight off the recurrence seeds
        Wb = sinv[m - 1] @ y[m - 1]

        def wbwd(x_next, blk):
            si, uh, yk = blk
            x_k = si @ yk - uh @ x_next
            return x_k, None

        if m > 1:
            Wt, _ = jax.lax.scan(wbwd, Wb,
                                 (sinv[:-1], uhat[:-1], y[:-1]),
                                 reverse=True)
        else:
            Wt = Wb

        def vbwd(x_next, uh):
            x_k = -(uh @ x_next)
            return x_k, None

        Vb = sinv[m - 1] @ Cp
        if m > 1:
            Vt, _ = jax.lax.scan(vbwd, Vb, uhat[:-1], reverse=True)
        else:
            Vt = Vb
    return Wt, Wb, Vt, Vb


def _sweeps_host(ehat, sinv, uhat, bb):
    """numpy twin of thomas_sweeps (f64 math over the stored stacks)."""
    nb = bb.shape[0]
    y = np.empty_like(bb)
    y[0] = bb[0]
    for k in range(1, nb):
        y[k] = bb[k] - ehat[k] @ y[k - 1]
    x = np.empty_like(y)
    x[nb - 1] = sinv[nb - 1] @ y[nb - 1]
    for k in range(nb - 2, -1, -1):
        x[k] = sinv[k] @ y[k] - uhat[k] @ x[k + 1]
    return x


@jax.tree_util.register_pytree_node_class
class BandedLU:
    """Direct block-tridiagonal ("block Thomas") factorization of a
    banded matrix — factor and multi-RHS solve built from dense matmuls.

    For an RCM-ordered diagonally dominant system (the power-flow B',
    B'', Ybus matrices; new capability vs the solver-less reference —
    SURVEY scope note, breadcrumb src/research/scipy_wrappers.py), chunk
    rows into blocks of s >= bandwidth so A is block tridiagonal
    (D_k, E_k, F_k).  Factor via the block Thomas recurrence

        S_k = D_k - E_k S_{k-1}^{-1} F_{k-1}

    with dense BLAS-3 on host, storing Ehat_k = E_k S_{k-1}^{-1},
    S_k^{-1}, and Uhat_k = S_k^{-1} F_k.  The device solve is two
    ``lax.scan`` sweeps of (s,s)@(s,B) matmuls — three per block:

        y_k = b_k - Ehat_k y_{k-1}
        x_k = S_k^{-1} y_k - Uhat_k x_{k+1}

    Unlike ``SparseLU(...).banded_solve_plan()`` this never forms a
    sparse factorization: at 50k nodes the scalar no-exchange LU plus
    plan build took ~200 s + 250 s on this host; the block recurrence is
    nb * O(s^3) dense flops (seconds).  Pivoting is within-block only
    (f64 LAPACK inversion of each S_k), so use on diagonally dominant /
    well-conditioned banded systems; ``np.linalg.LinAlgError`` signals a
    singular fully-summed block.
    """

    def __init__(self, a, ordering="rcm", s: int | None = None,
                 dtype=None):
        import os
        import time as _time

        from . import ordering as ordering_mod

        _dbg = os.environ.get("CSPARSE3_BANDED_DEBUG")
        _t = _time.perf_counter

        def _mark(label, t0):
            if _dbg:
                print(f"[bandedlu] {label}: {_t() - t0:.2f}s", flush=True)
            return _t()

        t0 = _t()
        n, m = a.shape
        if n != m:
            raise ValueError(f"BandedLU requires a square matrix, got "
                             f"{a.shape}")
        if ordering is None:
            ordering = "natural"
        perm = np.asarray(ordering_mod.get_ordering(ordering, a))
        if np.array_equal(perm, np.arange(n)):
            ap = a
        else:
            from ..ops.slicing import submatrix

            ap = submatrix(a, perm, perm)
        t0 = _mark("ordering+permute", t0)
        Ap, Ai, Ax = ap.np_arrays()
        bw = bandwidth(Ap, Ai)
        if s is None:
            # lane-friendly block size: multiples of 128 once past one
            # tile, multiples of 8 below
            q = 128 if bw >= 96 else 8
            s = max(8, -(-max(bw, 1) // q) * q)
        if s < bw:
            raise ValueError(f"block size {s} < matrix bandwidth {bw}")
        if dtype is None:
            dtype = Ax.dtype if jax.config.jax_enable_x64 else (
                np.complex64 if np.iscomplexobj(Ax) else np.float32)
        wide = np.complex128 if np.iscomplexobj(Ax) else np.float64
        nb = -(-n // s)
        cols = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(np.asarray(Ap)))
        sym = is_symmetric_csc(n, Ap, Ai, Ax) if ap.canonical else False
        t0 = _mark("symbolic", t0)
        ehat, sinv, uhat = _thomas_factor(
            n, s, nb, Ai, cols, Ax, dtype, wide, sym=sym)
        t0 = _mark("factor loop", t0)
        self.n = n
        self.s = s
        self.bw = bw
        # Factor stacks stay HOST numpy here and upload lazily on first
        # device access (the _ehat/_sinv/_uhat/perm properties): solve
        # plans that never touch this object's device path (host solves,
        # refactor templates) never pay the ~620 MB upload at 100k nodes.
        # Complex stacks stay on host and embed as HLO constants under
        # closure-jit; use jax.jit(utils.splitc(plan)) for complex
        # device solves.
        self._ehat = ehat
        self._sinv = sinv
        self._uhat = uhat
        self.perm = perm
        # host copies for solve_host (storage-dtype sweeps in f64 math)
        self._h = (ehat, sinv, uhat, perm)

    # --- lazy device upload -------------------------------------------
    # Host numpy until first device access; then uploaded once and
    # cached.  Complex arrays are returned as-is (see __init__ note).

    def _leaf(self, attr):
        v = getattr(self, attr)
        if isinstance(v, np.ndarray) and not np.iscomplexobj(v):
            v = jnp.asarray(v)
            setattr(self, attr, v)
        return v

    @property
    def _ehat(self):
        return self._leaf("_ehat_v")

    @_ehat.setter
    def _ehat(self, v):
        self._ehat_v = v

    @property
    def _sinv(self):
        return self._leaf("_sinv_v")

    @_sinv.setter
    def _sinv(self, v):
        self._sinv_v = v

    @property
    def _uhat(self):
        return self._leaf("_uhat_v")

    @_uhat.setter
    def _uhat(self, v):
        self._uhat_v = v

    @property
    def perm(self):
        return self._leaf("_perm_v")

    @perm.setter
    def perm(self, v):
        self._perm_v = v

    def tree_flatten(self):
        return ((self._ehat, self._sinv, self._uhat, self.perm),
                (self.n, self.s, self.bw))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.n, obj.s, obj.bw = aux
        obj._ehat, obj._sinv, obj._uhat, obj.perm = ch
        obj._h = None
        return obj

    @property
    def nblocks(self) -> int:
        return int(self._sinv.shape[0])

    def blocks(self, b):
        """Permute + zero-pad a (n,) / (n, B) RHS into (nb, s, B) block
        form (device).  Chained solvers should stay in block space and
        call ``solve_blocks`` directly — the per-solve permutation
        gather/scatter is wasted work inside an iteration loop."""
        b = jnp.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        n, s, nb = self.n, self.s, self.nblocks
        dt = jnp.result_type(self._sinv.dtype, b.dtype)
        bp = jnp.zeros((nb * s, b.shape[1]), dtype=dt).at[:n].set(
            b[self.perm])
        return bp.reshape(nb, s, -1)

    def unblocks(self, xx):
        """Inverse of ``blocks``: (nb, s, B) -> (n, B)."""
        zf = xx.reshape(self.nblocks * self.s, -1)[: self.n]
        return jnp.zeros_like(zf).at[self.perm].set(zf)

    def solve_blocks(self, bb, precision="highest"):
        """Solve in block space: (nb, s, B) -> (nb, s, B)."""
        return thomas_sweeps(self._ehat, self._sinv, self._uhat, bb,
                             precision=precision)

    def __call__(self, b):
        squeeze = jnp.ndim(b) == 1
        x = self.unblocks(self.solve_blocks(self.blocks(b)))
        return x[:, 0] if squeeze else x

    def solve_host(self, b):
        """Host solve (numpy twin of the device sweeps).  Exact to f64
        when the plan was built under x64; otherwise f64 sweeps over the
        f32-stored factors."""
        if self._h is None:
            raise ValueError("host state lost through pytree flattening")
        Ehat, invS, Uhat, perm = self._h
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        nb, s = invS.shape[0], self.s
        dt = np.result_type(invS.dtype, b.dtype)
        bp = np.zeros((nb * s, b.shape[1]), dtype=dt)
        bp[: self.n] = b[np.asarray(perm)]
        x = _sweeps_host(Ehat, invS, Uhat, bp.reshape(nb, s, -1))
        xf = x.reshape(nb * s, -1)[: self.n]
        out = np.empty_like(xf)
        out[np.asarray(perm)] = xf
        return out[:, 0] if squeeze else out

    @classmethod
    def _from_stacks(cls, ehat, sinv, uhat, perm, n, s, bw):
        obj = object.__new__(cls)
        obj.n, obj.s, obj.bw = n, s, bw
        obj._ehat, obj._sinv, obj._uhat = ehat, sinv, uhat
        obj.perm = perm
        obj._h = None
        return obj

    def refactor_plan(self, a):
        """Device numeric refactorization: freeze this plan's block
        layout and permutation, then factor NEW values of the same
        pattern entirely on device (jittable — the scaling analogue of
        ``SparseLU.refactor_plan``; pairs with the device Ybus/Jacobian
        assembly in the jittable Newton)."""
        return BandedRefactor(self, a)

    @classmethod
    def factor_device(cls, a, ordering="rcm", s: int | None = None,
                      dtype=None, jit: bool = True):
        """Factor ``a`` with the numeric work ENTIRELY on device.

        Host does only the symbolic part (ordering, bandwidth, block
        index map — O(nnz) integer numpy); the block-Thomas recurrence
        runs as a jitted ``lax.scan`` of batched (s,s) inverses + matmul
        matmuls (``thomas_factor_device``), and the factor stacks are
        BORN on device — no host factor loop and no ~0.6 GB stack
        upload (the two costs that dominate ``BandedLU(a)`` at 100k
        nodes).  The device recurrence runs in f32 (x64 off):
        forward error ~1e-5·cond on diagonally dominant systems; use
        the host constructor when f64 factorization accuracy is needed.

        Returns ``(lu, rf)``: the solvable ``BandedLU`` and the
        ``BandedRefactor`` that produced it (reusable for same-pattern
        value updates — Newton loops, contingency sweeps).
        """
        data = np.asarray(a.np_arrays()[2])
        if np.iscomplexobj(data):
            # split-complex real embedding: order
            # the COMPLEX matrix, interleave to the real 2n-system
            # (bandwidth bw -> 2bw+1, so bandedness survives), factor
            # that on device, and marshal complex RHS/solution through
            # the embedding.  Reference analogue: complex_ops.h.
            from . import ordering as ordering_mod
            from ..ops.construct import (
                complex_embed_block_size, real_equivalent)

            perm_c = np.asarray(ordering_mod.get_ordering(
                "natural" if ordering is None else ordering, a))
            ap = (a if np.array_equal(perm_c, np.arange(a.n))
                  else a[perm_c, perm_c])
            lu2, rf2 = cls.factor_device(
                real_equivalent(ap), ordering=None,
                s=complex_embed_block_size(s), dtype=dtype,
                jit=jit)
            return ComplexBandedSolve(lu2, perm_c, a.n), rf2
        rf = BandedRefactor.from_matrix(a, ordering=ordering, s=s,
                                        dtype=dtype)
        call = jax.jit(rf.__call__) if jit else rf.__call__
        return call(jnp.asarray(data)), rf


class ComplexBandedSolve:
    """Complex-facing solve over a real split-complex ``BandedLU``.

    Built by ``BandedLU.factor_device`` on a complex matrix: holds the
    factored interleaved real 2n-system plus the complex-level ordering,
    and marshals complex RHS/solution through the embedding (host-side
    re/im packing — complex never crosses the transfer boundary)."""

    def __init__(self, lu2, perm_c, n):
        self.lu2 = lu2          # factored real 2n-system (BandedLU)
        self.perm_c = np.asarray(perm_c)
        self.n = int(n)

    def solve(self, b):
        from ..ops.construct import complex_rhs_to_real, real_x_to_complex

        b2, squeeze = complex_rhs_to_real(b, self.perm_c)
        x2 = np.asarray(self.lu2(jnp.asarray(b2)))
        return real_x_to_complex(x2, self.perm_c, squeeze)

    __call__ = solve


@jax.tree_util.register_pytree_node_class
class BandedRefactor:
    """values -> factored BandedLU, entirely on device.

    Build once from a factored ``BandedLU`` and the matrix it factored;
    ``__call__(data)`` takes the CSC ``data`` array (same pattern, new
    values), scatter-adds it into block-tridiagonal stacks with a
    precomputed static index map, and runs the device block-Thomas
    recurrence (``thomas_factor_device``).  Returns a solvable
    ``BandedLU`` pytree — usable inside ``jit``/``lax.scan`` for
    factor-per-iteration Newton loops.
    """

    def __init__(self, plan: BandedLU, a):
        # dtype read off _sinv_v directly: skip the lazy device upload
        self._build(plan.n, plan.s, plan.nblocks, plan.bw, plan.perm,
                    plan._sinv_v.dtype, a)

    @classmethod
    def from_matrix(cls, a, ordering="rcm", s: int | None = None,
                    dtype=None):
        """Symbolic-only construction: no prior factorization needed.

        Host work is ordering + bandwidth + the block index map (all
        O(nnz) integer numpy); every numeric factorization then runs on
        device via ``__call__``.  This is the front door for
        ``BandedLU.factor_device``."""
        from . import ordering as ordering_mod

        n, m = a.shape
        if n != m:
            raise ValueError(f"square matrix required, got {a.shape}")
        if ordering is None:
            ordering = "natural"
        perm = np.asarray(ordering_mod.get_ordering(ordering, a))
        pinv = np.empty(n, dtype=np.int64)
        pinv[perm] = np.arange(n, dtype=np.int64)
        Ap, Ai, Ax = a.np_arrays()
        cols = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(np.asarray(Ap)))
        bw = int(np.abs(pinv[np.asarray(Ai, dtype=np.int64)]
                        - pinv[cols]).max()) if len(cols) else 0
        if s is None:
            q = 128 if bw >= 96 else 8
            s = max(8, -(-max(bw, 1) // q) * q)
        if s < bw:
            raise ValueError(f"block size {s} < matrix bandwidth {bw}")
        if dtype is None:
            dtype = Ax.dtype if jax.config.jax_enable_x64 else (
                np.complex64 if np.iscomplexobj(Ax) else np.float32)
        obj = object.__new__(cls)
        obj._build(n, s, -(-n // s), bw, jnp.asarray(perm),
                   np.dtype(dtype), a)
        return obj

    def _build(self, n, s, nb, bw, perm_dev, dtype, a):
        Ap, Ai, _ = a.np_arrays()
        perm = np.asarray(perm_dev)
        pinv = np.empty(n, dtype=np.int64)
        pinv[perm] = np.arange(n, dtype=np.int64)
        cols = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(np.asarray(Ap)))
        r = pinv[np.asarray(Ai, dtype=np.int64)]
        c = pinv[cols]
        kb_r, kb_c = r // s, c // s
        d = kb_r - kb_c
        if (np.abs(d) > 1).any():
            raise ValueError("pattern exceeds the plan's block tridiagonal")
        # stacks concatenated as one flat buffer: [D | E | F]
        which = np.where(d == 0, 0, np.where(d == 1, 1, 2))
        # D_k, E_k and F_k all live at the entry's ROW block kb_r
        idx = which * (nb * s * s) + kb_r * (s * s) + (r % s) * s + (c % s)
        pad = np.arange(n, nb * s, dtype=np.int64)
        pad_idx = (pad // s) * (s * s) + (pad % s) * s + (pad % s)
        self._idx = jnp.asarray(idx)
        self._pad_idx = jnp.asarray(pad_idx)
        self._dtype = dtype
        self._perm = perm_dev
        self._aux = (n, s, nb, bw)

    def tree_flatten(self):
        return ((self._idx, self._pad_idx, self._perm),
                (self._aux, np.dtype(self._dtype).name))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj._aux, dt = aux
        obj._dtype = np.dtype(dt)
        obj._idx, obj._pad_idx, obj._perm = ch
        return obj

    def __call__(self, data):
        n, s, nb, bw = self._aux
        data = jnp.asarray(data).astype(self._dtype)
        buf = jnp.zeros((3 * nb * s * s,), dtype=self._dtype)
        buf = buf.at[self._idx].add(data)
        buf = buf.at[self._pad_idx].add(jnp.ones((), self._dtype))
        D, E, F = buf.reshape(3, nb, s, s)
        eh, si, uh = thomas_factor_device(D, E, F)
        return BandedLU._from_stacks(eh, si, uh, self._perm, n, s, bw)

    # drop-in for linalg.RefactorPlan's interface
    refactor = __call__


@jax.tree_util.register_pytree_node_class
class BandedSolvePlan:
    """x = A^{-1} b via block-bidiagonal L/U sweeps as matmuls.

    Build from a no-row-exchange factorization (SparseLU with
    ordering='rcm', tol=0); raises if the factors aren't banded enough
    for the chosen block size.
    """

    def __init__(self, host, s: int | None = None, dtype=None):
        n = host.n
        bw = max(bandwidth(host.Lp, host.Li), bandwidth(host.Up, host.Ui))
        if s is None:
            s = max(8, -(-bw // 8) * 8)
        if s < bw:
            raise ValueError(f"block size {s} < factor bandwidth {bw}")
        if dtype is None:
            # match the device dtype: without x64 every leaf lands as f32
            # anyway, and building in f32 halves host memory, block
            # inversion flops, and upload bytes (s grows ~sqrt(n), so at
            # 100k nodes the plan is ~1.2 GB even in f32)
            import jax

            dtype = host.Lx.dtype if jax.config.jax_enable_x64 else (
                np.complex64 if np.iscomplexobj(host.Lx) else np.float32)
        Ld, Lo = _dense_blocks(n, host.Lp, host.Li, host.Lx, s, lower=True,
                               dtype=dtype)
        Ud, Uo = _dense_blocks(n, host.Up, host.Ui, host.Ux, s, lower=False,
                               dtype=dtype)
        self.n = n
        self.s = s
        self.linv = jnp.asarray(_inv(Ld))
        self.lsub = jnp.asarray(Lo)
        self.uinv = jnp.asarray(_inv(Ud))
        self.usup = jnp.asarray(Uo)
        self.perm_r = jnp.asarray(np.asarray(host.perm_r))
        self.perm_c = jnp.asarray(np.asarray(host.perm_c))

    def tree_flatten(self):
        return (
            (self.linv, self.lsub, self.uinv, self.usup,
             self.perm_r, self.perm_c),
            (self.n, self.s),
        )

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.n, obj.s = aux
        (obj.linv, obj.lsub, obj.uinv, obj.usup,
         obj.perm_r, obj.perm_c) = ch
        return obj

    @property
    def nblocks(self) -> int:
        return int(self.linv.shape[0])

    def blocks(self, b):
        """Permute (perm_r) + zero-pad an (n,)/(n, B) RHS into block
        form (nb, s, B).  Chained solvers with perm_r == perm_c (the
        no-row-exchange case this plan targets) should iterate in block
        space via ``solve_blocks`` — the per-solve permutation
        gather/scatter is wasted work inside a loop."""
        b = jnp.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        n, s, nb = self.n, self.s, self.nblocks
        dt = jnp.result_type(self.linv.dtype, b.dtype)
        bp = jnp.zeros((nb * s, b.shape[1]), dtype=dt).at[:n].set(
            b[self.perm_r])
        return bp.reshape(nb, s, -1)

    def solve_blocks(self, bb):
        """Solve in block space: (nb, s, B) -> (nb, s, B)."""
        # HIGHEST: see thomas_sweeps — reduced-precision (TF32) products
        # compound through the block recurrence
        dt = bb.dtype
        s = self.s
        B = bb.shape[-1]
        with jax.default_matmul_precision("highest"):
            def fwd(x_prev, blk):
                binv, sub, rhs = blk
                x_k = binv @ (rhs - sub @ x_prev)
                return x_k, x_k

            x0 = jnp.zeros((s, B), dtype=dt)
            _, y = jax.lax.scan(fwd, x0, (self.linv, self.lsub, bb))

            def bwd(x_next, blk):
                binv, sup, rhs = blk
                x_k = binv @ (rhs - sup @ x_next)
                return x_k, x_k

            _, z = jax.lax.scan(
                bwd, x0, (self.uinv, self.usup, y), reverse=True
            )
        return z

    def unblocks(self, z):
        """Inverse of ``blocks`` on the solution side (perm_c)."""
        zf = z.reshape(self.nblocks * self.s, -1)[: self.n]
        x = jnp.zeros_like(zf)
        return x.at[self.perm_c].set(zf)

    def __call__(self, b):
        squeeze = jnp.ndim(b) == 1
        x = self.unblocks(self.solve_blocks(self.blocks(b)))
        return x[:, 0] if squeeze else x
