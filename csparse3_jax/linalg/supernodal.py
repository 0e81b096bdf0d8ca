"""Supernodal device LU refactorization — dense panels as matmuls.

The level-scheduled scalar ``RefactorPlan`` re-executes the elimination
DAG as per-entry gathers and scatter-adds; on the accelerator it was built for, arbitrary-index
gathers ran near-scalar on the accelerator it was built for, so its
rate was latency-bound.  This module is the blocking fix (north star
"supernodal panel factorization"): group columns with identical L-structure into
supernodes, and re-execute the factorization as a topological sweep of
DENSE panel operations —

  per supernode (batched over each elimination-tree level):
    gather   the (r, w) L-panel and (w, r) U-panel values     [2 gathers]
    factor   the (w, w) diagonal block, no pivoting           [elementwise]
    solve    L21 = B U11^{-1},  U12 = L11^{-1} C              [triangular]
    update   W = L21 @ U12 scattered-added into the ancestors [gemm]      

Gather/scatter volume drops by the supernode width (the w-deep
accumulation happens inside the gemm instead of one scatter per flop),
and the sequential depth drops from the column-DAG level count to the
supernodal etree height.

Pivot order is FROZEN from the host factorization (KLU-style
refactorization semantics, same contract as ``RefactorPlan``): this
requires a no-row-exchange host factor (``splu(..., tol=0)``-style) of
a structurally symmetric pattern, which power-system matrices satisfy.
Reference lineage: the BSR register-blocking blueprint
(src/sparsetools/bsr.h:249-316) and the SuperLU breadcrumb
(src/research/scipy_wrappers.py:1-11).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .lu_host import HostLU
from .lu import SolvePlan
from .refactor import RefactorPlan
from .trisolve import TriSolvePlan

__all__ = ["SupernodalRefactor"]


def _pattern_symmetric(n, Lp, Li, Up, Ui) -> bool:
    """pattern(U) == pattern(L)^T (the no-pivot structurally-symmetric
    invariant this schedule relies on)."""
    if len(Li) != len(Ui):
        return False
    colsL = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
    colsU = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
    kL = np.sort(colsL * (n + 1) + Li)          # L entries (row, col)
    kU = np.sort(Ui * (n + 1) + colsU)          # U entries transposed
    return np.array_equal(kL, kU)


def _dense_lu_nopiv_unblocked(D):
    """Batched in-place no-pivot LU of (ns, w, w) blocks: returns M with
    strict-lower = L multipliers, upper = U (Doolittle)."""
    w = D.shape[-1]

    def step(k, M):
        piv = M[:, k, k][:, None]
        below = (jnp.arange(w) > k)[None, :]
        mult = jnp.where(below, M[:, :, k] / piv, 0.0)
        # rank-1 update restricted to the TRAILING columns (> k): the
        # leading columns hold already-stored multipliers
        rowk = jnp.where((jnp.arange(w) > k)[None, :], M[:, k, :], 0.0)
        M = M - mult[:, :, None] * rowk[:, None, :]
        # store the multipliers in the eliminated column
        M = jnp.where((jnp.arange(w)[None, :, None] > k)
                      & (jnp.arange(w)[None, None, :] == k),
                      mult[:, :, None], M)
        return M

    return jax.lax.fori_loop(0, w, step, D)


_LU_PANEL = 32


def _dense_lu_nopiv(D, panel: int = _LU_PANEL):
    """Blocked no-pivot LU: same contract as the unblocked form.

    The w-step fori_loop of rank-1 updates was the dominant cost of a
    10k refactorization (traced: the single (6, 315, 315) front group's
    while spent 2.7 ms of the 20 ms total — each of the w iterations
    pays a full (nb, w, w) elementwise pass plus layout copies).  Right-looking
    panel factorization does the same elimination as O(w/panel) matmul
    steps: fori-LU only on the (nb, panel, panel) diagonal block, then
    two batched triangular solves and one batched matmul per panel —
    the identical kernel shapes factor_values already uses for
    L21/U12/W, which the device runs as blocked matmuls."""
    w = D.shape[-1]
    if w <= panel:
        return _dense_lu_nopiv_unblocked(D)
    dtype = D.dtype
    M = D
    for k0 in range(0, w, panel):
        b = min(panel, w - k0)
        Mkk = _dense_lu_nopiv_unblocked(M[:, k0:k0 + b, k0:k0 + b])
        if k0 + b < w:
            Ukk = jnp.triu(Mkk)
            Lkk = jnp.tril(Mkk, -1) + jnp.eye(b, dtype=dtype)[None]
            below = M[:, k0 + b:, k0:k0 + b]          # (nb, r, b)
            right = M[:, k0:k0 + b, k0 + b:]          # (nb, b, r)
            # L21 Ukk = below  ->  L21 = below Ukk^{-1}
            L21 = jnp.swapaxes(
                jax.scipy.linalg.solve_triangular(
                    Ukk, jnp.swapaxes(below, 1, 2), trans="T",
                    lower=False),
                1, 2)
            U12 = jax.scipy.linalg.solve_triangular(
                Lkk, right, lower=True, unit_diagonal=True)
            trail = M[:, k0 + b:, k0 + b:] - L21 @ U12
            mid = jnp.concatenate(
                [M[:, k0:k0 + b, :k0], Mkk, U12], axis=2)
            bot = jnp.concatenate(
                [M[:, k0 + b:, :k0], L21, trail], axis=2)
            M = jnp.concatenate([M[:, :k0], mid, bot], axis=1)
        else:
            mid = jnp.concatenate([M[:, k0:, :k0], Mkk], axis=2)
            M = jnp.concatenate([M[:, :k0], mid], axis=1)
    return M


def _graded_ok(w, z):
    """CHOLMOD-style graded amalgamation schedule: merged width w is
    acceptable when the padded-panel zero fraction z stays under the
    width-dependent budget."""
    return ((w <= 4 and z <= 0.85) or (w <= 8 and z <= 0.6)
            or (w <= 16 and z <= 0.4) or z <= 0.25)


def _fundamental_partition(n, Lp, Li):
    """Fundamental supernode boundaries + the column etree parents.

    Returns (fstarts, parent, cnt): fstarts includes the n sentinel;
    parent[j] = first off-diagonal row of column j (n = root); a
    boundary falls wherever struct(col j) != struct(col j-1) minus the
    pivot row — the packing in both the supernodal-panel and the
    multifrontal schedules relies on that nesting."""
    cnt = np.diff(Lp)
    parent = np.full(n, n, dtype=np.int64)
    for j in range(n):
        if cnt[j] > 1:
            parent[j] = Li[Lp[j] + 1]
    fstarts = [0]
    for j in range(1, n):
        fundamental = (parent[j - 1] == j and cnt[j] == cnt[j - 1] - 1)
        if not fundamental:
            fstarts.append(j)
    fstarts.append(n)
    return fstarts, parent, cnt


@jax.tree_util.register_pytree_node_class
class SupernodalRefactor:
    """values -> (Lx, Ux) (and a SolvePlan) entirely on device, via
    batched dense supernodal panels.

    Build once from a no-row-exchange host factorization and the matrix
    it factored; ``factor_values(new_data)`` is jittable and vmap-able.
    ``refactor(new_data)`` returns a level-scheduled ``SolvePlan`` like
    ``RefactorPlan.refactor`` (the solve plumbing is shared).
    """

    def __init__(self, host: HostLU, a_csc, relax: int = 1):
        """``relax`` caps the amalgamated supernode width (1, the
        default, keeps fundamental supernodes only — measured fastest
        for THIS schedule, whose cost is the per-level padded
        gather/scatter volume that amalgamation inflates; the
        matmul-extend-add ``MultifrontalRefactor`` is where relaxation
        pays off)."""
        n = host.n
        Lp = np.asarray(host.Lp, dtype=np.int64)
        Li = np.asarray(host.Li, dtype=np.int64)
        Up = np.asarray(host.Up, dtype=np.int64)
        Ui = np.asarray(host.Ui, dtype=np.int64)
        if not _pattern_symmetric(n, Lp, Li, Up, Ui):
            raise ValueError(
                "supernodal refactorization needs a structurally "
                "symmetric factor pattern (no-row-exchange factorization "
                "of a structurally symmetric matrix); use RefactorPlan")
        lnz, unz = len(Li), len(Ui)
        colsL = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
        colsU = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))
        key = n + 1
        keysL = colsL * key + Li
        keysU = colsU * key + Ui

        def posL(r, c):
            k = np.asarray(c) * key + r
            p = np.searchsorted(keysL, k)
            if not np.array_equal(keysL[np.minimum(p, lnz - 1)], k):
                raise AssertionError(
                    "supernodal schedule referenced an absent L entry "
                    "(pattern not symmetric-fill-closed)")
            return p

        def posU(r, c):
            k = np.asarray(c) * key + r
            p = np.searchsorted(keysU, k)
            if not np.array_equal(keysU[np.minimum(p, unz - 1)], k):
                raise AssertionError(
                    "supernodal schedule referenced an absent U entry "
                    "(pattern not symmetric-fill-closed)")
            return lnz + p

        # Tolerant twins for relaxed (amalgamated) panels: an absent
        # position gathers from D0 (reads 0) / scatters to TRASH.  Safe
        # because fill-closure makes every contribution to an absent
        # position EXACTLY zero: L(r,k)!=0 and U(k,c)!=0 would force
        # (r,c) into the pattern, so at absent (r,c) every product term
        # has an exactly-zero factor (floats preserve 0*x, 0-0, 0/u).
        def posL_opt(r, c):
            k = np.asarray(c) * key + r
            p = np.minimum(np.searchsorted(keysL, k), lnz - 1)
            return p, keysL[p] == k

        def posU_opt(r, c):
            k = np.asarray(c) * key + r
            p = np.minimum(np.searchsorted(keysU, k), unz - 1)
            return lnz + p, keysU[p] == k

        # ---- supernode partition: fundamental pass ---------------------
        fstarts, parent, cnt = _fundamental_partition(n, Lp, Li)

        # ---- relaxed amalgamation -----------------
        # Greedily merge CONTIGUOUS fundamental snodes while the merged
        # dense panel stays mostly nonzero (graded CHOLMOD-style
        # schedule).  Wider panels turn the near-scalar per-column
        # schedule into real matmul panels and cut the sequential level
        # count; the padded zeros cost dense flops the matrix units have to spare.
        # Correctness does not need the merged fill to exist in the host
        # pattern: absent entries ride the D0/TRASH sentinels (see
        # posL_opt above).
        starts = [0]
        srows = []
        if relax and relax > 1 and len(fstarts) > 2:
            cur_a, cur_b = fstarts[0], fstarts[1]
            cur_R = Li[Lp[cur_a]:Lp[cur_a + 1]]
            cur_ent = int(Lp[cur_b] - Lp[cur_a])
            for k in range(1, len(fstarts) - 1):
                a2, b2 = fstarts[k], fstarts[k + 1]
                R2 = Li[Lp[a2]:Lp[a2 + 1]]
                w_new = int(b2 - cur_a)
                R_new = np.union1d(cur_R, R2)
                ent_new = cur_ent + int(Lp[b2] - Lp[a2])
                z = 1.0 - ent_new / max(len(R_new) * w_new, 1)
                if w_new <= relax and _graded_ok(w_new, z):
                    cur_b, cur_R, cur_ent = b2, R_new, ent_new
                else:
                    starts.append(int(a2))
                    srows.append(cur_R)
                    cur_a, cur_b, cur_R = a2, b2, R2
                    cur_ent = int(Lp[b2] - Lp[a2])
            srows.append(cur_R)
        else:
            starts = fstarts[:-1]
            srows = [Li[Lp[s]:Lp[s + 1]] for s in starts]
        starts.append(n)
        ns_total = len(starts) - 1
        snode_of = np.empty(n, dtype=np.int64)
        for s in range(ns_total):
            snode_of[starts[s]:starts[s + 1]] = s

        # Level schedule over UPDATE TARGETS (a superset of the etree-
        # parent rule, and correct for any contiguous partition): snode s
        # scatters into every column/row index in its off-block rows, so
        # each of those snodes must sit at a strictly higher level.
        lev = np.zeros(ns_total, dtype=np.int64)
        for s in range(ns_total):
            w = starts[s + 1] - starts[s]
            off = srows[s][w:]
            if len(off):
                np.maximum.at(lev, snode_of[off], lev[s] + 1)
        # ---- A assembly map (same storage convention as RefactorPlan) --
        pinv = np.empty(n, dtype=np.int64)
        pinv[np.asarray(host.perm_r)] = np.arange(n)
        qinv = np.empty(n, dtype=np.int64)
        qinv[np.asarray(host.perm_c)] = np.arange(n)
        ip, rows, _ = a_csc.np_arrays()
        acols = np.repeat(np.arange(n), np.diff(np.asarray(ip)))
        k_of = qinv[acols]
        pr = pinv[np.asarray(rows, dtype=np.int64)]
        up = pr <= k_of
        a_dst = np.empty(len(pr), dtype=np.int64)
        a_dst[up] = posU(pr[up], k_of[up])
        a_dst[~up] = posL(pr[~up], k_of[~up])

        D1 = lnz + unz       # constant 1 slot (safe divisor)
        D0 = lnz + unz + 1   # constant 0 slot (safe gather source)
        TRASH = lnz + unz + 2  # scatter sink (never read)

        # ---- per-level padded index stacks -----------------------------
        levels = []
        level_widths = []  # static (aux): panel widths per level
        for L in range(int(lev.max()) + 1 if ns_total else 0):
            sids = [s for s in range(ns_total) if lev[s] == L]
            w_max = max(starts[s + 1] - starts[s] for s in sids)
            # sub-diagonal rows align at w_max in the padded panel (a
            # narrow-but-tall snode must not leak its off-block rows into
            # another snode's diagonal region), so the padded height is
            # w_max + max over snodes of (r_s - w_s)
            u_max = max(max(len(srows[s]) - (starts[s + 1] - starts[s])
                            for s in sids), 1)
            nb = len(sids)
            pL = np.full((nb, w_max + u_max, w_max), D0, dtype=np.int64)
            pLw = np.full((nb, w_max + u_max, w_max), TRASH,
                          dtype=np.int64)
            pU = np.full((nb, w_max, w_max + u_max), D0, dtype=np.int64)
            pUw = np.full((nb, w_max, w_max + u_max), TRASH,
                          dtype=np.int64)
            pT = np.full((nb, u_max, u_max), TRASH, dtype=np.int64)
            colmask = np.zeros((nb, w_max), dtype=bool)
            for b, s in enumerate(sids):
                j1, j2 = starts[s], starts[s + 1]
                w = j2 - j1
                R = srows[s]
                r = len(R)
                colmask[b, :w] = True

                def _row_slot(i):
                    return np.where(i < w, i, w_max + (i - w))

                # L panel: L(R[i], j1+jj) exists for R[i] >= j1+jj; within
                # a relaxed snode some (i, jj) may be absent -> keep D0/TRASH
                for jj in range(w):
                    c = j1 + jj
                    sub = Li[Lp[c]:Lp[c + 1]]
                    loc = _row_slot(np.searchsorted(R, sub))
                    pos = Lp[c] + np.arange(len(sub))
                    pL[b, loc, jj] = pos
                    pLw[b, loc, jj] = pos
                    # U panel row jj: U(c, R[i]) for R[i] >= c (U is
                    # stored by column; look up row c in each column);
                    # in a relaxed snode some targets are absent -> D0
                    tgt = R[R >= c]
                    loci = _row_slot(np.searchsorted(R, tgt))
                    pu, oku = posU_opt(np.full(len(tgt), c), tgt)
                    pU[b, jj, loci[oku]] = pu[oku]
                    pUw[b, jj, loci[oku]] = pu[oku]
                if r > w:
                    rr = R[w:]
                    RI, CK = np.broadcast_arrays(rr[:, None], rr[None, :])
                    below = RI > CK
                    # absent targets -> TRASH: those positions receive
                    # exactly-zero contributions (fill-closure argument
                    # at posL_opt)
                    pLt, okL = posL_opt(RI, CK)
                    pUt, okU = posU_opt(RI, CK)
                    tpos = np.where(below, np.where(okL, pLt, TRASH),
                                    np.where(okU, pUt, TRASH))
                    pT[b, :r - w, :r - w] = tpos
            levels.append((
                jnp.asarray(pL), jnp.asarray(pLw), jnp.asarray(pU),
                jnp.asarray(pUw), jnp.asarray(pT), jnp.asarray(colmask),
            ))
            level_widths.append(w_max)
        self.n = n
        self.lnz, self.unz = lnz, unz
        self.dtype = host.Lx.dtype
        self.nsnodes = ns_total
        self.nlevels = len(levels)
        self.levels = levels
        self.level_widths = tuple(level_widths)
        self.a_dst = jnp.asarray(a_dst)
        self.l_unit = jnp.asarray(posL(np.arange(n), np.arange(n)))
        self.perm_r = jnp.asarray(np.asarray(host.perm_r))
        self.perm_c = jnp.asarray(np.asarray(host.perm_c))
        # solve plumbing shared with RefactorPlan (slab retargeting)
        self._ltpl = TriSolvePlan(n, host.Lp, host.Li, host.Lx, lower=True)
        self._utpl = TriSolvePlan(n, host.Up, host.Ui, host.Ux, lower=False)
        self._l_slab = RefactorPlan._slab_map(n, host.Lp, host.Li, lower=True)
        self._u_slab = RefactorPlan._slab_map(n, host.Up, host.Ui,
                                              lower=False)
        self._l_offpos = jnp.asarray(np.flatnonzero(Li != colsL))
        self._u_offpos = jnp.asarray(np.flatnonzero(Ui != colsU) + lnz)
        self._u_diagpos = jnp.asarray(posU(np.arange(n), np.arange(n)))

    # ---- pytree ----------------------------------------------------------
    def tree_flatten(self):
        leaves = (self.levels, self.a_dst, self.l_unit, self.perm_r,
                  self.perm_c, self._ltpl, self._utpl,
                  self._l_slab[0], self._l_slab[1],
                  self._u_slab[0], self._u_slab[1],
                  self._l_offpos, self._u_offpos, self._u_diagpos)
        aux = (self.n, self.lnz, self.unz, self.dtype, self.nsnodes,
               self.nlevels, self.level_widths, self._l_slab[2],
               self._u_slab[2])
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        (obj.n, obj.lnz, obj.unz, obj.dtype, obj.nsnodes, obj.nlevels,
         obj.level_widths, lmeta, umeta) = aux
        (obj.levels, obj.a_dst, obj.l_unit, obj.perm_r, obj.perm_c,
         obj._ltpl, obj._utpl, l0, l1, u0, u1,
         obj._l_offpos, obj._u_offpos, obj._u_diagpos) = leaves
        obj._l_slab = (l0, l1, lmeta)
        obj._u_slab = (u0, u1, umeta)
        return obj

    # ---- numeric factorization (jittable) --------------------------------
    def factor_values(self, new_data):
        """(Lx, Ux) for the original pattern with ``new_data`` values."""
        new_data = jnp.asarray(new_data)
        dtype = jnp.result_type(new_data.dtype, self.dtype)
        X = jnp.zeros(self.lnz + self.unz + 3, dtype=dtype)
        X = X.at[self.lnz + self.unz].set(1)       # D1
        X = X.at[self.l_unit].set(1)
        X = X.at[self.a_dst].add(new_data)

        with jax.default_matmul_precision("highest"):
            for (pL, pLw, pU, pUw, pT, colmask), w in zip(
                    self.levels, self.level_widths):
                P = X[pL]                     # (nb, r, w)
                Q = X[pU]                     # (nb, w, r)
                D = Q[:, :, :w]               # fully-summed diag block (U rows)
                # the diagonal block appears in BOTH panels; take the U
                # rows for the upper part and the L columns for the
                # lower multipliers after factoring the assembled block.
                # Assemble the full (w, w) block: upper from Q, strict
                # lower from P (both hold the same summed values).
                full = jnp.triu(D) + jnp.tril(P[:, :w, :], -1)
                # padded columns get a unit diagonal so the block stays
                # nonsingular
                eye = jnp.eye(w, dtype=dtype)[None]
                full = full + eye * (~colmask[:, None, :]
                                     & (jnp.arange(w)[:, None]
                                        == jnp.arange(w)[None, :])[None])
                M = _dense_lu_nopiv(full)
                U11 = jnp.triu(M)
                L11 = jnp.tril(M, -1) + eye
                B = P[:, w:, :]               # (nb, r-w, w)
                C = Q[:, :, w:]               # (nb, w, r-w)
                # L21 U11 = B  ->  L21 = B U11^{-1}: solve U11^T Y = B^T
                # (Y = L21^T), then transpose back
                L21 = jnp.swapaxes(
                    jax.scipy.linalg.solve_triangular(
                        U11, jnp.swapaxes(B, 1, 2), trans="T",
                        lower=False),
                    1, 2)
                U12 = jax.scipy.linalg.solve_triangular(
                    L11, C, lower=True, unit_diagonal=True)
                # scatter the factored panels back
                Pnew = jnp.concatenate(
                    [jnp.tril(M, -1) + eye, L21], axis=1)
                Qnew = jnp.concatenate([U11, U12], axis=2)
                X = X.at[pLw.reshape(-1)].set(Pnew.reshape(-1))
                X = X.at[pUw.reshape(-1)].set(Qnew.reshape(-1))
                if pT.shape[1] and B.shape[1]:
                    W = L21 @ U12             # (nb, r-w, r-w) — matmul
                    X = X.at[pT.reshape(pT.shape[0], -1)].add(
                        -W.reshape(W.shape[0], -1))
                # keep the constant slots clean for the next level
                X = X.at[self.lnz + self.unz].set(1)
                X = X.at[self.lnz + self.unz + 1].set(0)
        return X[: self.lnz], X[self.lnz: self.lnz + self.unz]

    def refactor(self, new_data, with_diag: bool = False):
        """SolvePlan with fresh numeric factors (same contract as
        RefactorPlan.refactor; the slab retargeting is shared)."""
        from .refactor import retarget_solve_plan

        Lx, Ux = self.factor_values(new_data)
        return retarget_solve_plan(self, Lx, Ux, with_diag)
