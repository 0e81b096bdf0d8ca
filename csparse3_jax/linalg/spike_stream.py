"""Streamed (out-of-core) SPIKE: 1M-class banded factor+solve on ONE device.

``DistBandedLU.factor_device`` shards the SPIKE chunks over a mesh; its
full factor state at 1M nodes / s = 2560 is ~21 GB.  This module solves
the same system on a single device whose memory cannot hold that state,
by CHUNK REMATERIALIZATION — the classic remat/checkpoint trade applied
at the SPIKE-partition level:

  pass 1 (per chunk, sequential):  assemble the chunk's (m, s, s)
      block-tridiagonal stacks ON DEVICE from its raw CSC entries
      (~MB uploads instead of GB stack uploads), run the symmetric
      block-Thomas factorization, and keep ONLY the four (s, s) spike
      interface tips plus the locally-swept RHS g_p (m s B floats).
      The factors are dropped when the call returns.
  reduced:  factor the (P-1)-block structured interface system (the
      same Schur-quadrant recurrence as DistBandedLU.factor_device)
      and solve it for the chunk-boundary unknowns.
  pass 2 (per chunk):  REFACTOR the chunk (same device call) and sweep
      the boundary-coupling correction; x_p = g_p - delta_p.

Every chunk is factored twice per solve — 2x the FLOPs of the sharded
path buys an O(chunk) memory footprint (~6 GB transient at 1M/s=2560)
and ~MB-scale transfers.  On an 80 GB H100 the whole factor state fits,
so a single-card path that keeps it is the better trade there (ROADMAP);
this one is for devices with less memory.  Timing on the H100
(examples/spike_1m.py): not measured.

Symmetric matrices take the E-free fast path; general banded systems
use the full (D, E, F) chunk factorization; complex systems ride the
split-complex interleaved embedding (ops/construct.real_equivalent).

Reference: the SPIKE algorithm's recursive/truncated variants; this
layout has no counterpart in the reference (a single-threaded CPU
library) — the capability it extends is the north-star 1M LU-solve
(BASELINE.md config 5) on one device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .banded import (
    is_symmetric_csc, spike_tips_device, thomas_factor_device,
    thomas_factor_device_sym, thomas_sweeps, thomas_sweeps_sym)

__all__ = ["StreamedSPIKE", "spike_reduced_factor"]


def spike_reduced_factor(Wt, Wb, Vt, Vb, s, dtype):
    """Structured block-Thomas factor of the SPIKE reduced system.

    The reduced blocks are D_p = [[I, Vb_p], [Wt_{p+1}, I]] with
    single-quadrant couplings; the Schur recurrence preserves the
    identity diagonal, so each step costs one (s, s) inverse and ~8
    (s, s) products instead of a dense (2s, 2s) inverse.  Shared by
    ``parallel.DistBandedLU.factor_device`` and ``StreamedSPIKE``.
    Returns (r_eh, r_si, r_uh) stacks of shape (P-1, 2s, 2s)."""
    nR = Wt.shape[0] - 1
    eye = jnp.eye(s, dtype=dtype)
    z_s = jnp.zeros((s, s), dtype)

    with jax.default_matmul_precision("highest"):
        def step(carry, blk):
            S11p, S12p = carry    # PREVIOUS step's Sinv quadrants
            Bq0, Cq, Wbk, Vtk, Vtnext, has_prev = blk
            Bq = Bq0 - has_prev * (Wbk @ S12p @ Vtk)
            Z = jnp.linalg.inv(eye - Cq @ Bq)
            ZC = Z @ Cq
            S11 = eye + Bq @ ZC
            S12 = -(Bq @ Z)
            S21 = -ZC
            sinv_k = jnp.block([[S11, S12], [S21, Z]])
            eh_k = jnp.block(
                [[has_prev * (Wbk @ S11p),
                  has_prev * (Wbk @ S12p)], [z_s, z_s]])
            uh_k = jnp.block([[z_s, S12 @ Vtnext],
                              [z_s, Z @ Vtnext]])
            return (S11, S12), (eh_k, sinv_k, uh_k)

        Bq0 = Vb[:-1]
        Cq = Wt[1:]
        Wbk = Wb[:nR]
        Vtk = Vt[:nR]
        Vtnext = jnp.concatenate([Vt[1:nR], jnp.zeros((1, s, s), dtype)])
        has_prev = jnp.arange(nR, dtype=dtype).clip(0, 1)[:, None, None]
        _, (r_eh, r_si, r_uh) = jax.lax.scan(
            step, (z_s, z_s), (Bq0, Cq, Wbk, Vtk, Vtnext, has_prev))
    return r_eh, r_si, r_uh


class StreamedSPIKE:
    """Single-chip out-of-core SPIKE factor+solve for symmetric banded
    systems larger than HBM (see module docstring).

    Parameters mirror ``DistBandedLU.factor_device``: ``P`` is the
    number of chunks (the memory knob — per-chunk transient state is
    ~3 (m s^2) floats, m = ceil(ceil(n/s)/P))."""

    def __init__(self, a, P: int = 8, ordering="rcm", s: int | None = None,
                 dtype=np.float32):
        from . import ordering as ordering_mod

        n, mm = a.shape
        if n != mm:
            raise ValueError(f"requires a square matrix, got {a.shape}")
        Ap, Ai, Ax = a.np_arrays()
        if np.iscomplexobj(np.asarray(Ax)):
            from ..ops.construct import (
                complex_embed_block_size, real_equivalent)

            perm_c = np.asarray(ordering_mod.get_ordering(
                "natural" if ordering is None else ordering, a))
            ap = (a if np.array_equal(perm_c, np.arange(n))
                  else a[perm_c, perm_c])
            self._inner = StreamedSPIKE(
                real_equivalent(ap), P=P, ordering=None,
                s=complex_embed_block_size(s), dtype=dtype)
            self._cplx_perm = perm_c
            self.n = n
            return
        self._inner = None
        self._cplx_perm = None
        sym = bool(a.canonical and is_symmetric_csc(
            n, np.asarray(Ap), np.asarray(Ai), np.asarray(Ax)))
        perm = np.asarray(ordering_mod.get_ordering(
            "natural" if ordering is None else ordering, a))
        pinv = np.empty(n, dtype=np.int64)
        pinv[perm] = np.arange(n, dtype=np.int64)
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
        nblk = -(-n // s)
        m = -(-nblk // P)
        if m < 2:
            raise ValueError(
                f"chunks need >= 2 blocks (n={n}, s={s}, P={P})")
        if (np.abs(r // s - c // s) > 1).any():
            raise ValueError(f"bandwidth exceeds block size {s}")
        nb = m * P
        self.n, self.s, self.bw, self.m, self.P = n, s, bw, m, P
        self.perm = perm
        self.dtype = np.dtype(dtype)

        self._sym = sym
        vals = np.asarray(Ax, dtype=dtype)
        kb_r, kb_c = r // s, c // s
        d = kb_r - kb_c
        lr, lc = (r % s).astype(np.int64), (c % s).astype(np.int64)
        ch = kb_r // m                         # owning chunk (by block row)

        # flat local destinations within a chunk's (m, s, s) stack
        loc = (kb_r - ch * m) * (s * s) + lr * s + lc
        m0 = d == 0
        mF = (d == -1) & ((kb_c % m) != 0)     # interior F (lives at kb_r)
        fout = (d == -1) & ((kb_c % m) == 0)   # C_p coupling blocks
        mE = (d == 1) & ((kb_r % m) != 0)      # interior E (general path)
        eout = (d == 1) & ((kb_r % m) == 0)    # B_p coupling blocks

        idxD_p, valD_p, idxF_p, valF_p = [], [], [], []
        idxE_p, valE_p = [], []
        for p in range(P):
            selD = m0 & (ch == p)
            selF = mF & (ch == p)
            idxD_p.append(loc[selD])
            valD_p.append(vals[selD])
            idxF_p.append(loc[selF])
            valF_p.append(vals[selF])
            if not sym:
                selE = mE & (ch == p)
                idxE_p.append(loc[selE])
                valE_p.append(vals[selE])
        # unit diagonal on the padded tail slots, appended to each pad
        # row's OWNING chunk (pad blocks can span several trailing
        # chunks when floor(n/s) < (P-1)*m; lumping them onto the last
        # chunk left earlier chunks with singular all-zero D blocks)
        padr = np.arange(n, nb * s, dtype=np.int64)
        if len(padr):
            pk = padr // s
            pch = pk // m
            ploc = (pk - pch * m) * (s * s) + (padr % s) * s \
                + (padr % s)
            for p in np.unique(pch):
                selp = pch == p
                idxD_p[p] = np.concatenate([idxD_p[p], ploc[selp]])
                valD_p[p] = np.concatenate(
                    [valD_p[p], np.ones(int(selp.sum()), dtype=dtype)])
        # pad per-chunk streams to a common length (idx 0 += 0.0 no-ops)
        LD = max(len(x) for x in idxD_p)
        LF = max(max(len(x) for x in idxF_p), 1)

        def _pad(ix, vx, L):
            out_i = np.zeros((P, L), dtype=np.int32)
            out_v = np.zeros((P, L), dtype=dtype)
            for p in range(P):
                out_i[p, : len(ix[p])] = ix[p]
                out_v[p, : len(vx[p])] = vx[p]
            return jnp.asarray(out_i), jnp.asarray(out_v)

        assert m * s * s < 2**31, "chunk stack exceeds int32 addressing"
        self._iD, self._vD = _pad(idxD_p, valD_p, LD)
        self._iF, self._vF = _pad(idxF_p, valF_p, LF)
        if sym:
            self._iE = self._vE = None
        else:
            LE = max(max(len(x) for x in idxE_p), 1)
            self._iE, self._vE = _pad(idxE_p, valE_p, LE)

        # B_p / C_p chunk-coupling (s, s) blocks (B_p = C_{p-1}^T for
        # symmetric input; assembled from the d=+1 crossing entries
        # otherwise)
        Cc = np.zeros((P, s, s), dtype=dtype)
        np.add.at(Cc, (kb_r[fout] // m, lr[fout], lc[fout]), vals[fout])
        self._C = jnp.asarray(Cc)
        if sym:
            self._B = None
        else:
            Bcc = np.zeros((P, s, s), dtype=dtype)
            np.add.at(Bcc, (kb_r[eout] // m, lr[eout], lc[eout]),
                      vals[eout])
            self._B = jnp.asarray(Bcc)

        self._tips = None       # (P, 4, s, s) after first pass
        self._red = None        # reduced factor stacks

        mS, sS = m, s

        def _assemble(iX, vX):
            return jnp.zeros((mS * sS * sS,), vX.dtype).at[iX].add(
                vX).reshape(mS, sS, sS)

        if sym:
            @jax.jit
            def _chunk(iD, vD, iF, vF, Bp, Cp, bb):
                """One chunk visit: assemble + factor + tips + local
                sweep.  bb: (m, s, B) -> (tips (4,s,s), g (m,s,B))."""
                si, uh = thomas_factor_device_sym(
                    _assemble(iD, vD), _assemble(iF, vF))
                Wt, Wb, Vt, Vb = spike_tips_device(si, uh, Bp, Cp)
                g = thomas_sweeps_sym(si, uh, bb)
                return jnp.stack([Wt, Wb, Vt, Vb]), g

            @jax.jit
            def _chunk_warm(iD, vD, iF, vF, bb):
                """Tips-free pass 1 for warm solves (tips cached): the
                ~8 m s^3 spike-tip flops — comparable to the
                factorization itself — would otherwise be recomputed
                and discarded on every solve."""
                si, uh = thomas_factor_device_sym(
                    _assemble(iD, vD), _assemble(iF, vF))
                return thomas_sweeps_sym(si, uh, bb)

            @jax.jit
            def _chunk2(iD, vD, iF, vF, Bp, Cp, g, x_prev_b, x_next_t):
                """Second visit: refactor + boundary-correction sweep."""
                si, uh = thomas_factor_device_sym(
                    _assemble(iD, vD), _assemble(iF, vF))
                with jax.default_matmul_precision("highest"):
                    rhs2 = jnp.zeros_like(g)
                    rhs2 = rhs2.at[0].set(Bp @ x_prev_b)
                    rhs2 = rhs2.at[mS - 1].add(Cp @ x_next_t)
                delta = thomas_sweeps_sym(si, uh, rhs2)
                return g - delta

            self._pass1 = lambda p, bb: _chunk(
                self._iD[p], self._vD[p], self._iF[p], self._vF[p],
                self._Bp(p), self._C[p], bb)
            self._pass1_warm = lambda p, bb: _chunk_warm(
                self._iD[p], self._vD[p], self._iF[p], self._vF[p], bb)
            self._pass2 = lambda p, g, xp, xn: _chunk2(
                self._iD[p], self._vD[p], self._iF[p], self._vF[p],
                self._Bp(p), self._C[p], g, xp, xn)
        else:
            @jax.jit
            def _chunk_g(iD, vD, iE, vE, iF, vF, Bp, Cp, bb):
                eh, si, uh = thomas_factor_device(
                    _assemble(iD, vD), _assemble(iE, vE),
                    _assemble(iF, vF))
                Wt, Wb, Vt, Vb = spike_tips_device(si, uh, Bp, Cp,
                                                   ehat=eh)
                g = thomas_sweeps(eh, si, uh, bb)
                return jnp.stack([Wt, Wb, Vt, Vb]), g

            @jax.jit
            def _chunk_warm_g(iD, vD, iE, vE, iF, vF, bb):
                eh, si, uh = thomas_factor_device(
                    _assemble(iD, vD), _assemble(iE, vE),
                    _assemble(iF, vF))
                return thomas_sweeps(eh, si, uh, bb)

            @jax.jit
            def _chunk2_g(iD, vD, iE, vE, iF, vF, Bp, Cp, g, x_prev_b,
                          x_next_t):
                eh, si, uh = thomas_factor_device(
                    _assemble(iD, vD), _assemble(iE, vE),
                    _assemble(iF, vF))
                with jax.default_matmul_precision("highest"):
                    rhs2 = jnp.zeros_like(g)
                    rhs2 = rhs2.at[0].set(Bp @ x_prev_b)
                    rhs2 = rhs2.at[mS - 1].add(Cp @ x_next_t)
                delta = thomas_sweeps(eh, si, uh, rhs2)
                return g - delta

            self._pass1 = lambda p, bb: _chunk_g(
                self._iD[p], self._vD[p], self._iE[p], self._vE[p],
                self._iF[p], self._vF[p], self._Bp(p), self._C[p], bb)
            self._pass1_warm = lambda p, bb: _chunk_warm_g(
                self._iD[p], self._vD[p], self._iE[p], self._vE[p],
                self._iF[p], self._vF[p], bb)
            self._pass2 = lambda p, g, xp, xn: _chunk2_g(
                self._iD[p], self._vD[p], self._iE[p], self._vE[p],
                self._iF[p], self._vF[p], self._Bp(p), self._C[p], g,
                xp, xn)

    def _Bp(self, p):
        # B_p = C_{p-1}^T for symmetric input; assembled otherwise
        if p == 0:
            return jnp.zeros((self.s, self.s), self.dtype)
        if self._B is not None:
            return self._B[p]
        return self._C[p - 1].T

    def solve(self, b):
        """x = A^{-1} b; b (n,) or (n, B) — two streamed passes."""
        if self._inner is not None:
            from ..ops.construct import (
                complex_rhs_to_real, real_x_to_complex)

            b2, squeeze = complex_rhs_to_real(b, self._cplx_perm)
            return real_x_to_complex(self._inner.solve(b2),
                                     self._cplx_perm, squeeze)
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        n, s, m, Pn = self.n, self.s, self.m, self.P
        nbs = m * Pn * s
        bp = np.zeros((nbs, b.shape[1]), dtype=self.dtype)
        bp[:n] = b[self.perm]
        bb = bp.reshape(Pn, m, s, -1)

        # ---- pass 1: tips (cached; skipped warm) + locally swept RHS ----
        first = self._tips is None and Pn > 1
        tips = [] if first else None
        gs = []
        for p in range(Pn):
            if first:
                t_p, g_p = self._pass1(p, jnp.asarray(bb[p]))
                tips.append(t_p)
            else:
                g_p = self._pass1_warm(p, jnp.asarray(bb[p]))
            gs.append(g_p)
        if Pn == 1:
            # single chunk: no interfaces, g IS the solution
            xf = np.asarray(gs[0]).reshape(nbs, -1)[:n]
            res = np.empty_like(xf)
            res[self.perm] = xf
            return res[:, 0] if squeeze else res
        if first:
            T = jnp.stack(tips)                       # (P, 4, s, s)
            self._tips = T
            self._red = spike_reduced_factor(
                T[:, 0], T[:, 1], T[:, 2], T[:, 3], s, self.dtype)

        # ---- reduced interface solve ------------------------------------
        r_eh, r_si, r_uh = self._red
        gts = jnp.stack([g[0] for g in gs])           # (P, s, B)
        gbs = jnp.stack([g[-1] for g in gs])
        r = jnp.concatenate([gbs[:-1], gts[1:]], axis=1)   # (P-1, 2s, B)
        z = thomas_sweeps(r_eh, r_si, r_uh, r)
        xb, xt = z[:, :s], z[:, s:]
        zero = jnp.zeros_like(gts[0])

        # ---- pass 2: refactor + boundary correction ---------------------
        out = np.empty((nbs, b.shape[1]), dtype=self.dtype)
        for p in range(Pn):
            x_prev_b = xb[p - 1] if p > 0 else zero
            x_next_t = xt[p] if p < Pn - 1 else zero
            x_p = self._pass2(p, gs[p], x_prev_b, x_next_t)
            out[p * m * s:(p + 1) * m * s] = np.asarray(x_p).reshape(
                m * s, -1)
        xf = out[:n]
        res = np.empty_like(xf)
        res[self.perm] = xf
        return res[:, 0] if squeeze else res

    __call__ = solve
