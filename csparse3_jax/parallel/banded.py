"""Distributed banded direct solve — the SPIKE algorithm on a device mesh.

The distributed LU-solve for RCM-ordered grid systems
(BASELINE.md config 5).  The reference has no distributed code at all
(SURVEY §2.4); this is the capability its domain needs at >=1M nodes,
built the SPMD way: each device owns a contiguous chunk of block rows,
factors its local block-tridiagonal piece with the block-Thomas
recurrence (``linalg.banded.BandedLU`` machinery), and the chunks couple
only through one (s, s) block per interface.  Following Polizzi-Sameh's
SPIKE decomposition:

    A = D · S,   D = blockdiag(T_0 .. T_{P-1}),
    S = I + spikes:  V_p = T_p^{-1} [0..0, C_p]   (right spike)
                     W_p = T_p^{-1} [B_p, 0..0]   (left spike)

where B_p / C_p are the sub/super coupling blocks at chunk boundaries.
Taking the first (t) and last (b) block rows of S x = g := D^{-1} b gives
a *reduced* block-tridiagonal system in the interface unknowns
z_p = [x_p^b ; x_{p+1}^t] with P-1 blocks of size 2s — factored once at
build time with the same Thomas recurrence.

Device solve (all under ``shard_map``; b sharded by block rows):
  1. local Thomas sweeps       g_p = T_p^{-1} b_p       (lax.scan, matmul)
  2. all_gather of the 2P boundary blocks g_p^t, g_p^b  (ICI, s*B each)
  3. replicated reduced solve  z = R^{-1} r             (P-1 small steps)
  4. local spike correction    x_p = g_p - W_p x_{p-1}^b - V_p x_{p+1}^t
                               (two (m*s, s) @ (s, B) matmuls)

Communication is one all_gather of 2*s*B floats per device per solve —
independent of n — so scaling efficiency stays high as chunks grow.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..linalg.banded import (
    _sweeps_host,
    _thomas_factor,
    bandwidth,
    spike_tips_device,
    thomas_factor_device,
    thomas_factor_device_sym,
    thomas_sweeps,
    thomas_sweeps_sym,
)

__all__ = ["DistBandedLU"]


def _thomas_factor_stacks(D, E, F, dtype):
    """Block-Thomas factor of explicitly dense (nb,s,s) stacks (used for
    the small reduced interface system)."""
    from ..linalg.banded import _downcast

    nb = D.shape[0]
    ehat = np.zeros((nb,) + D.shape[1:], dtype=dtype)
    sinv = np.empty_like(ehat)
    uhat = np.empty_like(ehat)
    Sinv_prev = None
    for k in range(nb):
        if k:
            Eh = E[k] @ Sinv_prev
            S = D[k] - Eh @ F[k - 1]
            ehat[k] = _downcast(Eh, dtype)
        else:
            S = D[0].copy()
        Sinv = np.linalg.inv(S)
        sinv[k] = _downcast(Sinv, dtype)
        uhat[k] = _downcast(Sinv @ F[k], dtype)
        Sinv_prev = Sinv
    return ehat, sinv, uhat



def _chunk_geometry(a, mesh, ordering, s):
    """Shared symbolic prologue of the SPIKE constructors: mesh checks,
    ordering, permuted-coordinate entry streams, bandwidth, lane-friendly
    block size, and the chunk geometry.  Returns
    (mesh, axis, Pn, n, perm, r, c, bw, s, m, nb) — one copy of the
    block-size and chunks->=2 rules for both the host- and the
    device-factored paths."""
    from ..linalg import ordering as ordering_mod

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), ("rows",))
    if len(mesh.axis_names) != 1:
        raise ValueError("DistBandedLU needs a 1-axis mesh")
    axis = mesh.axis_names[0]
    Pn = int(np.prod(mesh.devices.shape))
    n, mm = a.shape
    if n != mm:
        raise ValueError(f"requires a square matrix, got {a.shape}")
    if ordering is None:
        ordering = "natural"
    perm = np.asarray(ordering_mod.get_ordering(ordering, a))
    pinv = np.empty(n, dtype=np.int64)
    pinv[perm] = np.arange(n, dtype=np.int64)
    Ap, Ai, _ = a.np_arrays()
    cols = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(np.asarray(Ap)))
    r = pinv[np.asarray(Ai, dtype=np.int64)]
    c = pinv[cols]
    bw = int(np.abs(r - c).max()) if len(c) else 0
    if s is None:
        q = 128 if bw >= 96 else 8
        s = max(8, -(-max(bw, 1) // q) * q)
    if s < bw:
        raise ValueError(f"block size {s} < matrix bandwidth {bw}")
    m = -(-(-(-n // s)) // Pn)        # blocks per chunk
    nb = m * Pn
    if m < 2:
        raise ValueError(
            f"chunks need >= 2 blocks (n={n}, s={s}, P={Pn}); "
            "use fewer devices or the single-chip BandedLU")
    if (np.abs(r // s - c // s) > 1).any():
        raise ValueError(f"bandwidth exceeds block size {s}")
    return mesh, axis, Pn, n, perm, r, c, bw, s, m, nb



class DistBandedLU:
    """SPIKE-partitioned block-tridiagonal factorization over a mesh.

    Parameters
    ----------
    a : CSC (square, banded after ``ordering``)
    mesh : jax.sharding.Mesh with one axis (default: all devices on axis
        'rows'), P = mesh size
    ordering : 'rcm' (default), None/'natural', a permutation array, or
        a callable — must make ``a`` banded
    s : block size (default: bandwidth rounded up lane-friendly)
    dtype : device dtype (default f32 unless x64 is enabled)
    """

    def __init__(self, a, mesh: Mesh | None = None, ordering="rcm",
                 s: int | None = None, dtype=None):
        from ..ops.slicing import submatrix

        (mesh, axis, Pn, n, perm, _, _, bw, s, m,
         nb) = _chunk_geometry(a, mesh, ordering, s)
        self.mesh = mesh
        self.axis = axis
        # the host factor path wants the PERMUTED canonical CSC (its
        # symmetry check and per-chunk streams read it directly)
        ap = a if np.array_equal(perm, np.arange(n)) else submatrix(
            a, perm, perm)
        Ap, Ai, Ax = ap.np_arrays()
        if dtype is None:
            dtype = Ax.dtype if jax.config.jax_enable_x64 else (
                np.complex64 if np.iscomplexobj(Ax) else np.float32)
        wide = np.complex128 if np.iscomplexobj(Ax) else np.float64
        self.n, self.s, self.bw, self.m, self.P = n, s, bw, m, Pn

        cols = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(np.asarray(Ap)))
        rows = np.asarray(Ai).astype(np.int64)
        vals = np.asarray(Ax)
        kb_r, kb_c = rows // s, cols // s
        ch_r, ch_c = kb_r // m, kb_c // m

        ehat = np.empty((nb, s, s), dtype=dtype)
        sinv = np.empty((nb, s, s), dtype=dtype)
        uhat = np.empty((nb, s, s), dtype=dtype)
        Wsp = np.zeros((Pn, m * s, s), dtype=dtype)   # left spikes
        Vsp = np.zeros((Pn, m * s, s), dtype=dtype)   # right spikes
        # reduced interface blocks collected per chunk
        Wt = np.zeros((Pn, s, s), dtype=wide)
        Wb = np.zeros((Pn, s, s), dtype=wide)
        Vt = np.zeros((Pn, s, s), dtype=wide)
        Vb = np.zeros((Pn, s, s), dtype=wide)

        interior = ch_r == ch_c
        # chunk-diagonal blocks of a symmetric matrix are symmetric: the
        # per-chunk Thomas factors can take the sym fast path
        from ..linalg.banded import is_symmetric_csc

        sym = is_symmetric_csc(n, Ap, Ai, Ax) if ap.canonical else False
        for p in range(Pn):
            sel = interior & (ch_c == p)
            r_l = rows[sel] - p * m * s
            c_l = cols[sel] - p * m * s
            n_loc = min(n - p * m * s, m * s)
            n_loc = max(n_loc, 0)
            eh, si, uh = _thomas_factor(
                n_loc, s, m, r_l, c_l, vals[sel], dtype, wide, sym=sym)
            ehat[p * m:(p + 1) * m] = eh
            sinv[p * m:(p + 1) * m] = si
            uhat[p * m:(p + 1) * m] = uh
            # coupling blocks to the neighbours
            rhs = np.zeros((m, s, s), dtype=wide)
            if p > 0:
                selB = (kb_r == p * m) & (kb_c == p * m - 1)
                Bp = np.zeros((s, s), dtype=wide)
                Bp[rows[selB] % s, cols[selB] % s] = vals[selB]
                rhs[0] = Bp
                W = _sweeps_host(eh, si, uh, rhs)       # (m, s, s)
                Wsp[p] = W.reshape(m * s, s).astype(dtype)
                Wt[p], Wb[p] = W[0], W[-1]
            if p < Pn - 1:
                selC = (kb_r == (p + 1) * m - 1) & (kb_c == (p + 1) * m)
                Cp = np.zeros((s, s), dtype=wide)
                Cp[rows[selC] % s, cols[selC] % s] = vals[selC]
                rhs[:] = 0.0
                rhs[-1] = Cp
                V = _sweeps_host(eh, si, uh, rhs)
                Vsp[p] = V.reshape(m * s, s).astype(dtype)
                Vt[p], Vb[p] = V[0], V[-1]

        # reduced system over z_p = [x_p^b ; x_{p+1}^t], p = 0..P-2:
        #   diag  [[I,       V_p^b ], [W_{p+1}^t, I]]
        #   sub   [[W_p^b, 0], [0, 0]]
        #   super [[0, 0], [0, V_{p+1}^t]]
        eye = np.eye(s, dtype=wide)
        nR = Pn - 1
        Dr = np.zeros((nR, 2 * s, 2 * s), dtype=wide)
        Er = np.zeros((nR, 2 * s, 2 * s), dtype=wide)
        Fr = np.zeros((nR, 2 * s, 2 * s), dtype=wide)
        for p in range(nR):
            Dr[p, :s, :s] = eye
            Dr[p, :s, s:] = Vb[p]
            Dr[p, s:, :s] = Wt[p + 1]
            Dr[p, s:, s:] = eye
            if p > 0:
                Er[p, :s, :s] = Wb[p]
            if p < nR - 1:
                Fr[p, s:, s:] = Vt[p + 1]
        r_eh, r_si, r_uh = _thomas_factor_stacks(Dr, Er, Fr, dtype)

        shard = NamedSharding(mesh, P(self.axis))
        self._ehat = jax.device_put(ehat, shard)
        self._sinv = jax.device_put(sinv, shard)
        self._uhat = jax.device_put(uhat, shard)
        self._w = jax.device_put(Wsp, shard)
        self._v = jax.device_put(Vsp, shard)
        rep = NamedSharding(mesh, P())
        self._r_eh = jax.device_put(r_eh, rep)
        self._r_si = jax.device_put(r_si, rep)
        self._r_uh = jax.device_put(r_uh, rep)
        self.perm = perm
        self._hperm = perm
        self._h = (ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh)
        self._B = self._C = None
        self._sym = False
        self._r_sharded = False
        self._solve_c = None

    # -- device solve --------------------------------------------------------
    def _local(self, bb, ehat, sinv, uhat, w, v, r_eh, r_si, r_uh):
        """Per-shard body (runs under shard_map).  bb: (m, s, B) local."""
        ax = self.axis
        m, s = self.m, self.s
        g = thomas_sweeps(ehat, sinv, uhat, bb)              # (m, s, B)
        if self.P == 1:                                      # degenerate
            return g
        w = w.reshape(m * s, s)
        v = v.reshape(m * s, s)
        gt_gb = jnp.stack([g[0], g[-1]])                     # (2, s, B)
        allg = jax.lax.all_gather(gt_gb, ax)                 # (P, 2, s, B)
        gts, gbs = allg[:, 0], allg[:, 1]                    # (P, s, B)
        # reduced RHS r_p = [g_p^b ; g_{p+1}^t], p = 0..P-2
        r = jnp.concatenate([gbs[:-1], gts[1:]], axis=1)     # (P-1, 2s, B)
        z = thomas_sweeps(r_eh, r_si, r_uh, r)               # (P-1, 2s, B)
        xb = z[:, :s]          # x_p^b      for p = 0..P-2
        xt = z[:, s:]          # x_{p+1}^t  for p = 0..P-2
        idx = jax.lax.axis_index(ax)
        zero = jnp.zeros_like(g[0])
        x_prev_b = jnp.where(idx > 0,
                             jnp.take(xb, idx - 1, axis=0, mode="clip"),
                             zero)
        x_next_t = jnp.where(idx < self.P - 1,
                             jnp.take(xt, idx, axis=0, mode="clip"),
                             zero)
        # full f32: the default f32 matmul may run in TF32
        with jax.default_matmul_precision("highest"):
            corr = w @ x_prev_b + v @ x_next_t               # (m*s, B)
        return (g.reshape(m * s, -1) - corr).reshape(m, s, -1)

    def _local2(self, bb, sinv, uhat, ehat, Bc, Cc, r_eh, r_si, r_uh):
        """Recompute-variant shard body (factor_device objects): no
        stored spikes — after the replicated reduced solve, the spike
        correction is a SECOND local Thomas sweep of the boundary-
        coupling RHS (equal flops to the spike matmuls, none of the
        (m s, s) spike storage).  ``ehat is None`` -> symmetric factors
        (Ehat_k = Uhat_{k-1}^T)."""
        ax = self.axis
        m, s = self.m, self.s

        def sweep(rhs):
            if ehat is None:
                return thomas_sweeps_sym(sinv, uhat, rhs)
            return thomas_sweeps(ehat, sinv, uhat, rhs)

        g = sweep(bb)                                        # (m, s, B)
        if self.P == 1:
            return g
        gt_gb = jnp.stack([g[0], g[-1]])                     # (2, s, B)
        allg = jax.lax.all_gather(gt_gb, ax)                 # (P, 2, s, B)
        gts, gbs = allg[:, 0], allg[:, 1]
        r = jnp.concatenate([gbs[:-1], gts[1:]], axis=1)     # (P-1, 2s, B)
        nR = self.P - 1
        if self._r_sharded:
            # reduced factors stored SHARDED (padded to P): replicating
            # three (P-1, 2s, 2s) stacks costs P x the memory (17.6 GB
            # at s = 2560, P = 8); gather them transiently
            r_eh = jax.lax.all_gather(r_eh, ax, tiled=True)[:nR]
            r_si = jax.lax.all_gather(r_si, ax, tiled=True)[:nR]
            r_uh = jax.lax.all_gather(r_uh, ax, tiled=True)[:nR]
        nB = r.shape[-1]
        if nB % self.P == 0 and nB >= self.P:
            # shard the reduced solve over RHS columns: solving all B
            # columns redundantly on every device is a serial tail that
            # does not shrink with P
            me = jax.lax.axis_index(ax)
            bloc = nB // self.P
            rs = jax.lax.dynamic_slice_in_dim(r, me * bloc, bloc, axis=2)
            zs = thomas_sweeps(r_eh, r_si, r_uh, rs)   # (nR, 2s, bloc)
            zg = jax.lax.all_gather(zs, ax)            # (P, nR, 2s, bloc)
            z = jnp.moveaxis(zg, 0, 2).reshape(nR, 2 * s, nB)
        else:
            z = thomas_sweeps(r_eh, r_si, r_uh, r)
        xb = z[:, :s]
        xt = z[:, s:]
        idx = jax.lax.axis_index(ax)
        zero = jnp.zeros_like(g[0])
        x_prev_b = jnp.where(idx > 0,
                             jnp.take(xb, idx - 1, axis=0, mode="clip"),
                             zero)
        x_next_t = jnp.where(idx < self.P - 1,
                             jnp.take(xt, idx, axis=0, mode="clip"),
                             zero)
        with jax.default_matmul_precision("highest"):
            rhs2 = jnp.zeros_like(g)
            rhs2 = rhs2.at[0].set(Bc[0] @ x_prev_b)
            rhs2 = rhs2.at[m - 1].add(Cc[0] @ x_next_t)
            delta = sweep(rhs2)
        return g - delta

    def _build_solve(self):
        """One jitted shard_map solve per object — the eager path paid a
        trace + per-primitive multi-device dispatch on EVERY solve
        (measured 40 s for a trivial 1-RHS solve at 205k on the CPU
        mesh)."""
        ax = self.axis
        if self._w is not None:
            def body(bb, eh, si, uh, w, v, r_eh, r_si, r_uh):
                return self._local(bb, eh, si, uh, w, v, r_eh, r_si,
                                   r_uh)

            f = jax.shard_map(
                body, mesh=self.mesh,
                in_specs=(P(ax), P(ax), P(ax), P(ax), P(ax), P(ax),
                          P(), P(), P()),
                out_specs=P(ax),
            )
            self._solve_c = jax.jit(f)
        else:
            sym = self._sym

            def body2(bb, si, uh, eh, Bc, Cc, r_eh, r_si, r_uh):
                return self._local2(bb, si, uh, None if sym else eh,
                                    Bc, Cc, r_eh, r_si, r_uh)

            rspec = P(ax) if self._r_sharded else P()
            f = jax.shard_map(
                body2, mesh=self.mesh,
                in_specs=(P(ax),) * 6 + (rspec,) * 3,
                out_specs=P(ax),
            )
            self._solve_c = jax.jit(f)

    def solve_blocks(self, bb):
        """Solve in sharded block space: (nb, s, B) -> (nb, s, B)."""
        if self._solve_c is None:
            self._build_solve()
        if self._w is not None:
            return self._solve_c(bb, self._ehat, self._sinv, self._uhat,
                                 self._w, self._v, self._r_eh,
                                 self._r_si, self._r_uh)
        # the sym path has no ehat stack; pass sinv as a shape-true dummy
        # (body2 ignores it)
        eh = self._ehat if self._ehat is not None else self._sinv
        return self._solve_c(bb, self._sinv, self._uhat, eh, self._B,
                             self._C, self._r_eh, self._r_si, self._r_uh)

    def blocks(self, b):
        """Permute + pad an (n,)/(n,B) RHS to sharded (nb, s, B)."""
        b = np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        nbs = self.m * self.P * self.s
        bp = np.zeros((nbs, b.shape[1]), dtype=self._sinv.dtype)
        bp[: self.n] = b[self._hperm]
        bb = bp.reshape(self.m * self.P, self.s, -1)
        return jax.device_put(bb, NamedSharding(self.mesh, P(self.axis)))

    def unblocks(self, xx):
        """(nb, s, B) -> (n, B) numpy, inverse permutation applied."""
        xf = np.asarray(xx).reshape(-1, xx.shape[-1])[: self.n]
        out = np.empty_like(xf)
        out[self._hperm] = xf
        return out

    def __call__(self, b):
        if getattr(self, "_cplx_n", None) is not None:
            return self._solve_complex(b)
        squeeze = np.ndim(b) == 1
        x = self.unblocks(self.solve_blocks(self.blocks(b)))
        return x[:, 0] if squeeze else x

    def _solve_complex(self, b):
        """Complex RHS through the split-complex real embedding built by
        ``factor_device`` on a complex matrix."""
        from ..ops.construct import complex_rhs_to_real, real_x_to_complex

        b2, squeeze = complex_rhs_to_real(b, self._cplx_perm)
        x2 = self.unblocks(self.solve_blocks(self.blocks(b2)))
        return real_x_to_complex(x2, self._cplx_perm, squeeze)

    def solve(self, b):
        """x = A^{-1} b — alias of ``__call__`` (SparseLU-compatible)."""
        return self(b)

    # -- device factorization -------------------------------------------------
    @classmethod
    def factor_device(cls, a, mesh: Mesh | None = None, ordering="rcm",
                      s: int | None = None, dtype=None,
                      reduced_store: str = "auto"):
        """SPIKE factorization with the numeric work ON DEVICE, sharded.

        Host does only symbolic work (ordering + numpy assembly of the
        block-tridiagonal stacks in sharded layout); each shard runs the
        block-Thomas recurrence under one jitted ``shard_map`` call with
        DONATED inputs (the (nb, s, s) D/F stacks are reused for the
        factor output — at 1M nodes / s = 2560 that halves the peak),
        computes only the four (s, s) spike INTERFACE blocks by carried
        recurrences (``spike_tips_device`` — the full (m s, s) spikes
        are never materialized; the solve recomputes their action as a
        second local sweep), exchanges ONE all_gather of the tips, and
        factors the reduced 2s-block interface system on device.

        Symmetric matrices (checked on host) take the E-free fast path:
        Ehat_k = Uhat_{k-1}^T, dropping the E stack and one (s,s) matmul
        per block.  Complex matrices ride the split-complex real
        embedding (below)."""
        from ..linalg.banded import is_symmetric_csc

        if np.iscomplexobj(np.asarray(a.np_arrays()[2])):
            # split-complex real embedding: order
            # the COMPLEX matrix (interleaving maps bw -> 2bw+1, so
            # bandedness survives), then SPIKE-factor the interleaved
            # real 2n-system on the mesh; ``__call__`` marshals complex
            # RHS/solution through the embedding.  Reference analogue:
            # complex_ops.h (complex first-class in the kernel matrix).
            from ..linalg import ordering as ordering_mod
            from ..ops.construct import (
                complex_embed_block_size, real_equivalent)

            perm_c = np.asarray(ordering_mod.get_ordering(
                "natural" if ordering is None else ordering, a))
            ap = (a if np.array_equal(perm_c, np.arange(a.n))
                  else a[perm_c, perm_c])
            dk = cls.factor_device(
                real_equivalent(ap), mesh=mesh, ordering=None,
                s=complex_embed_block_size(s), dtype=dtype,
                reduced_store=reduced_store)
            dk._cplx_perm = perm_c
            dk._cplx_n = a.n
            return dk

        (mesh, axis, Pn, n, perm, r, c, bw, s, m,
         nb) = _chunk_geometry(a, mesh, ordering, s)
        Ap, Ai, Ax = a.np_arrays()
        if dtype is None:
            dtype = np.float32
        # symmetry is invariant under the symmetric permutation A[p, p],
        # so check the ORIGINAL canonical arrays (no permuted copy)
        sym = bool(a.canonical
                   and is_symmetric_csc(n, np.asarray(Ap), np.asarray(Ai),
                                        np.asarray(Ax)))
        vals = np.asarray(Ax, dtype=dtype)
        kb_r, kb_c = r // s, c // s
        d = kb_r - kb_c
        lr, lc = (r % s).astype(np.int64), (c % s).astype(np.int64)

        # ---- host numpy assembly, sharded (nb, s, s) layout ------------
        D = np.zeros((nb, s, s), dtype=dtype)
        F = np.zeros((nb, s, s), dtype=dtype)
        Bc = np.zeros((Pn, s, s), dtype=dtype)
        Cc = np.zeros((Pn, s, s), dtype=dtype)
        m0 = d == 0
        np.add.at(D, (kb_r[m0], lr[m0], lc[m0]), vals[m0])
        pad = np.arange(n, nb * s, dtype=np.int64)
        D[pad // s, pad % s, pad % s] += 1.0       # unit pad diagonal
        mF = d == -1                                # F_k lives at kb_r
        cross_F = (kb_c % m) == 0                   # crosses a chunk edge
        fin = mF & ~cross_F
        np.add.at(F, (kb_r[fin], lr[fin], lc[fin]), vals[fin])
        fout = mF & cross_F                         # C_p coupling blocks
        np.add.at(Cc, (kb_r[fout] // m, lr[fout], lc[fout]), vals[fout])
        mE = d == 1                                 # E_k lives at kb_r
        cross_E = (kb_r % m) == 0
        eout = mE & cross_E                         # B_p coupling blocks
        np.add.at(Bc, (kb_r[eout] // m, lr[eout], lc[eout]), vals[eout])
        if sym:
            E = None
        else:
            E = np.zeros((nb, s, s), dtype=dtype)
            ein = mE & ~cross_E
            np.add.at(E, (kb_r[ein], lr[ein], lc[ein]), vals[ein])

        shard = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())
        D = jax.device_put(D, shard)
        F = jax.device_put(F, shard)
        if E is not None:
            E = jax.device_put(E, shard)
        Bc = jax.device_put(Bc, shard)
        Cc = jax.device_put(Cc, shard)
        spec = P(axis)

        if sym:
            def local(Dp, Fp, Bp, Cp):
                si, uh = thomas_factor_device_sym(Dp, Fp)
                Wt, Wb, Vt, Vb = spike_tips_device(si, uh, Bp[0], Cp[0])
                iface = jnp.stack([Wt, Wb, Vt, Vb])      # (4, s, s)
                return si, uh, iface[None]

            f = jax.jit(jax.shard_map(
                local, mesh=mesh, in_specs=(spec,) * 4,
                out_specs=(spec, spec, spec)),
                donate_argnums=(0, 1))
            si, uh, iface = f(D, F, Bc, Cc)
            eh = None
        else:
            def local(Dp, Ep, Fp, Bp, Cp):
                eh, si, uh = thomas_factor_device(Dp, Ep, Fp)
                Wt, Wb, Vt, Vb = spike_tips_device(si, uh, Bp[0], Cp[0],
                                                   ehat=eh)
                iface = jnp.stack([Wt, Wb, Vt, Vb])
                return eh, si, uh, iface[None]

            f = jax.jit(jax.shard_map(
                local, mesh=mesh, in_specs=(spec,) * 5,
                out_specs=(spec, spec, spec, spec)),
                donate_argnums=(0, 1, 2))
            eh, si, uh, iface = f(D, E, F, Bc, Cc)
        del D, E, F

        @jax.jit
        def reduced(iface):
            """Structured reduced-system block-Thomas factor — the
            Schur-quadrant recurrence lives in
            ``linalg.spike_stream.spike_reduced_factor`` (shared with
            the single-chip StreamedSPIKE): each step costs one (s, s)
            inverse + ~8 products instead of a dense (2s, 2s) inverse
            (~2.8x fewer flops in this replicated serial tail)."""
            from ..linalg.spike_stream import spike_reduced_factor

            return spike_reduced_factor(
                iface[:, 0], iface[:, 1], iface[:, 2], iface[:, 3], s,
                dtype)

        obj = object.__new__(cls)
        obj.mesh, obj.axis = mesh, axis
        obj.n, obj.s, obj.bw, obj.m, obj.P = n, s, bw, m, Pn
        obj._ehat = eh
        obj._sinv = si
        obj._uhat = uh
        obj._w = obj._v = None
        obj._B, obj._C = Bc, Cc
        obj._sym = sym
        # 'sharded' trades memory (1/P of replicated) for one transient
        # all_gather of the reduced stacks per solve; the right call on
        # a host-RAM-backed virtual mesh.  On real devices ('replicated',
        # the 'auto' pick) the stacks are ~2.2 GB/device at s = 2560 and
        # the per-solve interconnect gather would dominate the solve.
        if reduced_store == "auto":
            reduced_store = ("sharded" if jax.default_backend() == "cpu"
                             else "replicated")
        obj._r_sharded = reduced_store == "sharded"
        obj._solve_c = None
        if Pn > 1:
            r_eh, r_si, r_uh = reduced(iface)
            if obj._r_sharded:
                # pad to P blocks so the leading axis shards evenly
                padR = jnp.zeros((1, 2 * s, 2 * s), dtype)
                r_eh = jnp.concatenate([r_eh, padR])
                r_si = jnp.concatenate([r_si, padR])
                r_uh = jnp.concatenate([r_uh, padR])
        else:
            z1 = jnp.zeros((Pn if obj._r_sharded else 0, 2 * s, 2 * s),
                           dtype)
            r_eh = r_si = r_uh = z1
        rstore = shard if obj._r_sharded else rep
        obj._r_eh = jax.device_put(r_eh, rstore)
        obj._r_si = jax.device_put(r_si, rstore)
        obj._r_uh = jax.device_put(r_uh, rstore)
        obj.perm = perm
        obj._hperm = perm
        obj._h = None
        return obj

    # -- host twin ------------------------------------------------------------
    def solve_host(self, b):
        """numpy replay of the SPIKE solve (for verification)."""
        if self._h is None:
            raise ValueError(
                "no host factor state: this object was built by "
                "factor_device (stacks live on the mesh devices) — use "
                "the host constructor DistBandedLU(a, ...) for a "
                "host-replayable twin")
        ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh = self._h
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        m, s, Pn = self.m, self.s, self.P
        dt = np.result_type(sinv.dtype, b.dtype)
        bp = np.zeros((m * Pn * s, b.shape[1]), dtype=dt)
        bp[: self.n] = b[self._hperm]
        B = b.shape[1]
        g = np.empty((Pn, m, s, B), dtype=dt)
        for p in range(Pn):
            g[p] = _sweeps_host(ehat[p * m:(p + 1) * m],
                                sinv[p * m:(p + 1) * m],
                                uhat[p * m:(p + 1) * m],
                                bp.reshape(Pn, m, s, B)[p])
        r = np.concatenate([g[:-1, -1], g[1:, 0]], axis=1)  # (P-1, 2s, B)
        z = _sweeps_host(r_eh, r_si, r_uh, r)
        x = np.empty_like(g)
        for p in range(Pn):
            corr = np.zeros((m * s, B), dtype=dt)
            if p > 0:
                corr += Wsp[p] @ z[p - 1, :s]
            if p < Pn - 1:
                corr += Vsp[p] @ z[p, s:]
            x[p] = (g[p].reshape(m * s, B) - corr).reshape(m, s, B)
        xf = x.reshape(-1, B)[: self.n]
        out = np.empty_like(xf)
        out[self._hperm] = xf
        return out[:, 0] if squeeze else out
