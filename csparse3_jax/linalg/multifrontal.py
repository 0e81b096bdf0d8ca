"""Multifrontal device LU refactorization — extend-add as matmuls.

``SupernodalRefactor`` (linalg/supernodal.py) already re-executes the
factorization as dense panels, but it keeps the factor values in one
flat CSC-position vector and pays per-level arbitrary-index gathers and
scatter-adds to move panels in and out of it; on the accelerator it was
built for, those memory ops were the entire cost, because arbitrary
gathers ran near-scalar there.

This module is the fix: a MULTIFRONTAL schedule in which
every value lives in dense per-level front buffers and the only
arbitrary-index traffic left is

  * one scatter-add of the nnz(A) input values per refactorization, and
  * one flat gather at the very end to emit (Lx, Ux) in CSC positions.

Everything between is matmul work:

  per level (top-down assigned so every child sits EXACTLY one level
  below its parent):
    gather   children update blocks W_c by FRONT INDEX (contiguous
             (u, u) blocks — a leading-axis block gather, not per-entry)
    extend-  F += E_c @ W_c @ E_c^T with 0/1 expansion matrices E_c —
    add      the multifrontal extend-add as two batched matmuls
             (the same one-hot-matmul trick as the point-SpMV kernel)
    factor   the (w, w) pivot block, no pivoting                  [elementwise]
    solve    L21 = B U11^{-1},  U12 = L11^{-1} C          [triangular]
    update   W = F22 - L21 @ U12                            [gemm]      

Fronts within a level are additionally split into SIZE BUCKETS
(boundaries at r <= 32 / 128 / inf): with top-down leveling a hoisted
leaf shares its level with big separators, and one 300-wide front
would otherwise pad a thousand 8-wide fronts to 300^2 (measured 314M
padded front floats at 10k nodes without bucketing).  Each bucket is
its own batched pipeline; extend-add runs per (parent-bucket,
child-bucket) pair.

Pivot order is FROZEN from the host factorization (KLU-style
refactorization semantics, same contract as ``RefactorPlan`` /
``SupernodalRefactor``): requires a no-row-exchange host factor of a
structurally symmetric pattern.  Relaxed amalgamation merges only
etree parent-child chains, which keeps the multifrontal containment
theorem (child off-block rows land inside the parent front) intact.
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
from .supernodal import (
    _dense_lu_nopiv, _fundamental_partition, _graded_ok,
    _pattern_symmetric)
from .trisolve import TriSolvePlan

__all__ = ["MultifrontalRefactor", "MultifrontalLU"]

_BUCKETS = (16, 32, 64, 128, 256)     # rmax bucket boundaries


def _groupby(keys, nkeys):
    """order, bounds such that order[bounds[k]:bounds[k+1]] are the
    positions with key k (replaces per-key flatnonzero scans)."""
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys[order], np.arange(nkeys + 1))
    return order, bounds


@jax.tree_util.register_pytree_node_class
class MultifrontalRefactor:
    """values -> (Lx, Ux) (and a SolvePlan) on device via batched dense
    fronts with matmul extend-add.

    Build once from a no-row-exchange host factorization and the matrix
    it factored; ``factor_values(new_data)`` is jittable and vmap-able.
    ``relax`` caps the amalgamated supernode width (1 disables relaxed
    amalgamation and keeps fundamental supernodes only).
    """

    def __init__(self, host: HostLU, a_csc, relax: int = 16,
                 solve_plumbing: bool = True):
        n = host.n
        Lp = np.asarray(host.Lp, dtype=np.int64)
        Li = np.asarray(host.Li, dtype=np.int64)
        Up = np.asarray(host.Up, dtype=np.int64)
        Ui = np.asarray(host.Ui, dtype=np.int64)
        if not _pattern_symmetric(n, Lp, Li, Up, Ui):
            raise ValueError(
                "multifrontal refactorization needs a structurally "
                "symmetric factor pattern (no-row-exchange factorization "
                "of a structurally symmetric matrix); use RefactorPlan")
        lnz, unz = len(Li), len(Ui)
        colsL = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
        colsU = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))

        # ---- fundamental supernode partition ---------------------------
        fstarts, parent, cnt = _fundamental_partition(n, Lp, Li)

        # ---- amalgamation restricted to etree parent-child chains ------
        # merge group [a, b) with the next fundamental snode ONLY when
        # parent(last col) is exactly the next column: the child's
        # off-block rows are then the parent's off-block rows plus the
        # absorbed columns, so the merged front still satisfies the
        # multifrontal containment theorem (its off rows land inside ITS
        # parent's front).
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
                chain = parent[cur_b - 1] == a2
                if chain and w_new <= relax:
                    R_new = np.union1d(cur_R, R2)
                    ent_new = cur_ent + int(Lp[b2] - Lp[a2])
                    z = 1.0 - ent_new / max(len(R_new) * w_new, 1)
                    if _graded_ok(w_new, z):
                        cur_b, cur_R, cur_ent = b2, R_new, ent_new
                        continue
                starts.append(int(a2))
                srows.append(cur_R)
                cur_a, cur_b, cur_R = a2, b2, R2
                cur_ent = int(Lp[b2] - Lp[a2])
            srows.append(cur_R)

            # keep the merged partition only when it actually cuts the
            # sequential level depth (chain-heavy patterns); on
            # dissection-style orderings merging buys nothing and the
            # wider padded fronts just cost flops
            def _depth(st, sr):
                m_ = len(st)
                sn = np.empty(n, dtype=np.int64)
                for i in range(m_):
                    sn[st[i]:(st[i + 1] if i + 1 < m_ else n)] = i
                h = np.ones(m_, dtype=np.int64)
                for i in range(m_):
                    w_ = (st[i + 1] if i + 1 < m_ else n) - st[i]
                    if len(sr[i]) > w_:
                        p_ = sn[sr[i][w_]]
                        h[p_] = max(h[p_], h[i] + 1)
                return int(h.max()) if m_ else 0

            f_srows = [Li[Lp[s]:Lp[s + 1]] for s in fstarts[:-1]]
            # 0.6: measured on the 3000-bus ND case a 26-vs-33 depth
            # cut (ratio 0.79) still LOSES to fundamental (110/s vs
            # 123/s — wider padded fronts cost more than 7 levels
            # save), while chain-like patterns merge at ratios ~0.25
            if _depth(starts, srows) > 0.6 * _depth(fstarts[:-1],
                                                    f_srows):
                starts, srows = list(fstarts[:-1]), f_srows
        else:
            starts = fstarts[:-1]
            srows = [Li[Lp[s]:Lp[s + 1]] for s in starts]
        if starts[-1] != n:
            starts.append(n)
        ns = len(starts) - 1
        starts_np = np.asarray(starts, dtype=np.int64)
        widths = np.diff(starts_np)
        snode_of = np.repeat(np.arange(ns, dtype=np.int64), widths)

        # snode etree: parent = snode of the first off-block row
        parent_s = np.full(ns, ns, dtype=np.int64)   # ns = "no parent"
        for s in range(ns):
            if len(srows[s]) > widths[s]:
                parent_s[s] = snode_of[srows[s][widths[s]]]

        # ---- top-down leveling: child level == parent level - 1 --------
        # (so every front's children were ALL produced at the previous
        # level).  A front at level 0 is necessarily childless.
        height = np.ones(ns, dtype=np.int64)
        for s in range(ns):                       # children first (s < p)
            p = parent_s[s]
            if p < ns:
                height[p] = max(height[p], height[s] + 1)
        nlev = int(height.max()) if ns else 0
        lev = np.empty(ns, dtype=np.int64)
        for s in range(ns - 1, -1, -1):           # parents first
            p = parent_s[s]
            lev[s] = (height[s] - 1) if p >= ns else lev[p] - 1

        # ---- bucketed groups: (level, size class) -----------------------
        rsz = np.asarray([len(R) for R in srows], dtype=np.int64)
        u_sz = rsz - widths
        kind = np.zeros(ns, dtype=np.int64)
        for t in _BUCKETS:
            kind += rsz > t
        # group id per snode; groups ordered by (level, kind)
        gkey = lev * (len(_BUCKETS) + 1) + kind
        order_g, gb = _groupby(gkey, nlev * (len(_BUCKETS) + 1))
        group_sids = []           # snode ids per group
        group_of = np.empty(ns, dtype=np.int64)
        slot_of = np.empty(ns, dtype=np.int64)
        group_level = []
        for gk in range(nlev * (len(_BUCKETS) + 1)):
            sids = order_g[gb[gk]:gb[gk + 1]]
            if not len(sids):
                continue
            gid = len(group_sids)
            group_sids.append(sids)
            group_of[sids] = gid
            slot_of[sids] = np.arange(len(sids))
            group_level.append(gk // (len(_BUCKETS) + 1))
        ngroups = len(group_sids)
        groups_at = [[] for _ in range(nlev)]
        for gid, L in enumerate(group_level):
            groups_at[L].append(gid)

        # ---- A-value assembly map (one scatter per refactorization) ----
        pinv = np.empty(n, dtype=np.int64)
        pinv[np.asarray(host.perm_r)] = np.arange(n)
        qinv = np.empty(n, dtype=np.int64)
        qinv[np.asarray(host.perm_c)] = np.arange(n)
        ip, rows_a, _ = a_csc.np_arrays()
        acols = np.repeat(np.arange(n), np.diff(np.asarray(ip)))
        pr = pinv[np.asarray(rows_a, dtype=np.int64)]
        pc = qinv[acols]
        owner = snode_of[np.minimum(pr, pc)]
        a_order, a_bounds = _groupby(owner, ns)
        u_owner = snode_of[Ui]                     # U(r, c): row's snode
        u_order, u_bounds = _groupby(u_owner, ns)
        c_order, c_bounds = _groupby(parent_s, ns + 1)  # children lists

        # ---- per-group static structures --------------------------------
        # front layout: axes 0..w-1 = snode columns, slots
        # w_max..w_max+u-1 = off-block rows (both axes)
        exL_gid = np.empty(lnz, dtype=np.int64)
        exL_off = np.empty(lnz, dtype=np.int64)
        exU_gid = np.empty(unz, dtype=np.int64)
        exU_off = np.empty(unz, dtype=np.int64)
        group_static = []      # (nb, w_max, u_max, rmax)
        colmasks, a_maps, rows_maps = [], [], []
        child_tabs = []        # per group: list of (src_gid, idx, E)
        for gid, sids in enumerate(group_sids):
            L = group_level[gid]
            nb = len(sids)
            w_max = int(widths[sids].max())
            u_max = int(max(u_sz[sids].max(), 1))
            rmax = w_max + u_max
            colmask = np.zeros((nb, w_max), dtype=bool)
            # global row ids per front slot (elimination space; pad -> n)
            # — the front-form solve of MultifrontalLU gathers/scatters
            # the RHS by these
            rows_piv = np.full((nb, w_max), n, dtype=np.int64)
            rows_off = np.full((nb, u_max), n, dtype=np.int64)
            a_sel_parts, a_dst_parts = [], []
            # children grouped by THEIR group (all at level L-1)
            kids_by_src = {}
            for b, s in enumerate(sids):
                w = int(widths[s])
                R = srows[s]
                colmask[b, :w] = True
                rows_piv[b, :w] = starts_np[s] + np.arange(w)
                rows_off[b, : len(R) - w] = R[w:]

                def _slot(i):
                    return np.where(i < w, i, w_max + (i - w))

                for c in c_order[c_bounds[s]:c_bounds[s + 1]]:
                    src = int(group_of[c])
                    kids_by_src.setdefault(src, []).append((b, c))
                # A assembly destinations owned by this front
                sel = a_order[a_bounds[s]:a_bounds[s + 1]]
                if len(sel):
                    ri = _slot(np.searchsorted(R, pr[sel]))
                    ci2 = _slot(np.searchsorted(R, pc[sel]))
                    a_sel_parts.append(sel)
                    a_dst_parts.append(b * rmax * rmax + ri * rmax + ci2)
                # L extraction, whole snode at once (the per-column loop
                # was the 10k host-build bottleneck: 10k numpy-op python
                # iterations ~ 10 s).  Extraction layout (r4): per group
                # [all tops (nb, w_max, rmax)] then [all L21s
                # (nb, u_max, w_max)] — the off x off (W) region is
                # never extracted, so it is no longer materialized into
                # the flat buffer (it was the largest padded block)
                j1 = int(starts_np[s])
                l21_base = nb * w_max * rmax
                posl = np.arange(Lp[j1], Lp[j1 + w])
                rs = _slot(np.searchsorted(R, Li[posl]))
                jj = colsL[posl] - j1
                exL_gid[posl] = gid
                exL_off[posl] = np.where(
                    rs < w_max,
                    b * w_max * rmax + rs * rmax + jj,
                    l21_base + b * u_max * w_max
                    + (rs - w_max) * w_max + jj)
                # U extraction: U(r, c) at (row slot of r < w, slot of c)
                selu = u_order[u_bounds[s]:u_bounds[s + 1]]
                if len(selu):
                    rs = Ui[selu] - j1
                    cs = _slot(np.searchsorted(R, colsU[selu]))
                    exU_gid[selu] = gid
                    exU_off[selu] = b * w_max * rmax + rs * rmax + cs
            # child tables per source group
            tabs = []
            for src, pairs in sorted(kids_by_src.items()):
                # per parent front b: its children from group src
                per_b = {}
                for b, c in pairs:
                    per_b.setdefault(b, []).append(c)
                maxc = max(len(v) for v in per_b.values())
                idx = np.zeros((nb, maxc), dtype=np.int32)
                src_umax = int(max(u_sz[group_sids[src]].max(), 1))
                # the 0/1 expansion matrix E (nb, maxc, rmax, src_umax)
                # is stored as its SLOT INDICES (pad rmax -> all-zero
                # column) and rebuilt on device in the factor loop: the
                # dense one-hots were ~70% of a 492 MB host->device
                # upload at 10k, and on-device a (slots == arange)
                # compare is cheaper than streaming the same one-hot
                # from HBM
                rsl = np.full((nb, maxc, src_umax), rmax, dtype=np.int32)
                for b, cs_ in per_b.items():
                    s = sids[b]
                    w = int(widths[s])
                    R = srows[s]
                    for ci, c in enumerate(cs_):
                        wc = int(widths[c])
                        offc = srows[c][wc:]
                        idx[b, ci] = slot_of[c]
                        loc = np.searchsorted(R, offc)
                        if not np.array_equal(
                                R[np.minimum(loc, len(R) - 1)], offc):
                            raise AssertionError(
                                "multifrontal containment violated: "
                                "child off row missing from parent")
                        rsl[b, ci, :len(offc)] = np.where(
                            loc < w, loc, w_max + (loc - w))
                tabs.append((src, idx, rsl))
            group_static.append((nb, w_max, u_max, rmax))
            # padded columns get a unit diagonal: the ADDITIVE adjustment
            # eye * ~colmask is built on device from the bool mask (the
            # precomputed (nb, w, w) f32 form was upload mass)
            colmasks.append(colmask)
            # values go up to n inclusive (n is the pad slot) — same
            # guarded-dtype pattern as a_sel/a_dst
            rdt = np.int32 if n < 2**31 else np.int64
            rows_maps.append((rows_piv.astype(rdt),
                              rows_off.astype(rdt)))
            a_sel = (np.concatenate(a_sel_parts) if a_sel_parts
                     else np.zeros(0, dtype=np.int64))
            a_dst = (np.concatenate(a_dst_parts) if a_dst_parts
                     else np.zeros(0, dtype=np.int64))
            a_maps.append((a_sel.astype(np.int32)
                           if len(a_sel) == 0 or a_sel.max() < 2**31
                           else a_sel,
                           a_dst.astype(np.int32)
                           if len(a_dst) == 0 or a_dst.max() < 2**31
                           else a_dst))
            child_tabs.append(tabs)

        # flatten extraction into ONE gather over concatenated
        # [top | L21] emissions (no W region)
        base = np.zeros(ngroups + 1, dtype=np.int64)
        for gid in range(ngroups):
            nb, w_max, u_max, rmax = group_static[gid]
            base[gid + 1] = base[gid] + nb * (w_max * rmax
                                              + u_max * w_max)
        # PACK per-group structures into a handful of flat device
        # buffers, recovered with static slices inside jit (free after
        # fusion): one transfer per buffer instead of ~560 per-group
        # jnp.asarray transfers, each with its own allocation.
        exL = base[exL_gid] + exL_off
        exU = base[exU_gid] + exU_off
        if int(base[-1]) < 2**31:
            exL, exU = exL.astype(np.int32), exU.astype(np.int32)

        def _offsets(parts):
            off = [0]
            for p in parts:
                off.append(off[-1] + int(p.size))
            return tuple(off)

        def _cat(parts, dt):
            if parts:
                return np.concatenate(
                    [np.ravel(p) for p in parts]).astype(dt, copy=False)
            return np.zeros(0, dtype=dt)

        sel_parts = [s_ for s_, _ in a_maps]
        dst_parts = [d_ for _, d_ in a_maps]
        a_dt = (np.int64 if any(p.dtype == np.int64
                                for p in sel_parts + dst_parts)
                else np.int32)
        idx_parts, rsl_parts, child_meta = [], [], []
        io_ = ro_ = 0
        for tabs in child_tabs:
            meta = []
            for (src, idx_, rsl_) in tabs:
                idx_parts.append(idx_)
                rsl_parts.append(rsl_)
                meta.append((src, io_, idx_.shape[1], ro_, rsl_.shape[2]))
                io_ += int(idx_.size)
                ro_ += int(rsl_.size)
            child_meta.append(tuple(meta))

        self.n = n
        self.lnz, self.unz = lnz, unz
        self.dtype = host.Lx.dtype
        self.nsnodes = ns
        self.nlevels = nlev
        self.ngroups = ngroups
        self.group_static = tuple(group_static)
        self.groups_at = tuple(tuple(g) for g in groups_at)
        self.child_meta = tuple(child_meta)
        # offsets into the flats (static python ints -> live in aux)
        self._mask_off = _offsets(colmasks)      # == rows_piv offsets
        # _rows_parts indexes _rows_p with _mask_off: both colmask and
        # rows_piv must stay (nb, w_max) per group
        assert all(m.shape == rp.shape
                   for m, (rp, _) in zip(colmasks, rows_maps)), (
            "colmask / rows_piv shape divergence breaks _mask_off reuse")
        self._rows_o_off = _offsets([ro for _, ro in rows_maps])
        self._a_off = _offsets(sel_parts)
        (self._masks, self._a_sel, self._a_dst,
         self._rows_p, self._rows_o, self._child_idx, self._child_rsl,
         self._exL, self._exU, self._l_diag,
         self.perm_r, self.perm_c) = jax.device_put((
            _cat(colmasks, np.bool_), _cat(sel_parts, a_dt),
            _cat(dst_parts, a_dt),
            _cat([rp for rp, _ in rows_maps],
                 np.int32 if n < 2**31 else np.int64),
            _cat([ro for _, ro in rows_maps],
                 np.int32 if n < 2**31 else np.int64),
            _cat(idx_parts, np.int32), _cat(rsl_parts, np.int32),
            exL, exU,
            # L's stored diagonal is unit; the front diagonal holds U11's
            # pivots, so mask those positions to 1 after the gather
            Li == colsL,
            np.asarray(host.perm_r), np.asarray(host.perm_c)))
        # solve plumbing shared with RefactorPlan (slab retargeting) —
        # only needed by refactor(); MultifrontalLU's front-form
        # solve_piv never touches it, and its host build (~10 s of
        # numpy slab packing at 10k) dominates the from-scratch build
        if solve_plumbing:
            self._ltpl = TriSolvePlan(n, host.Lp, host.Li, host.Lx,
                                      lower=True)
            self._utpl = TriSolvePlan(n, host.Up, host.Ui, host.Ux,
                                      lower=False)
            self._l_slab = RefactorPlan._slab_map(n, host.Lp, host.Li,
                                                  lower=True)
            self._u_slab = RefactorPlan._slab_map(n, host.Up, host.Ui,
                                                  lower=False)
            idx = np.int32 if lnz + unz < 2**31 else np.int64
            self._l_offpos = jnp.asarray(
                np.flatnonzero(Li != colsL).astype(idx))
            self._u_offpos = jnp.asarray(
                (np.flatnonzero(Ui != colsU) + lnz).astype(idx))
            self._u_diagpos = jnp.asarray(
                (np.flatnonzero(Ui == colsU) + lnz).astype(idx))
        else:
            self._ltpl = self._utpl = None
            self._l_slab = (None, None, None)
            self._u_slab = (None, None, None)
            self._l_offpos = self._u_offpos = self._u_diagpos = None

    # ---- pytree ----------------------------------------------------------
    def tree_flatten(self):
        leaves = (self._masks, self._a_sel, self._a_dst,
                  self._rows_p, self._rows_o,
                  self._child_idx, self._child_rsl,
                  self._exL, self._exU, self._l_diag,
                  self.perm_r, self.perm_c, self._ltpl, self._utpl,
                  self._l_slab[0], self._l_slab[1],
                  self._u_slab[0], self._u_slab[1],
                  self._l_offpos, self._u_offpos, self._u_diagpos)
        aux = (self.n, self.lnz, self.unz, self.dtype, self.nsnodes,
               self.nlevels, self.ngroups, self.group_static,
               self.groups_at, self.child_meta,
               self._mask_off, self._rows_o_off, self._a_off,
               self._l_slab[2], self._u_slab[2])
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        (obj.n, obj.lnz, obj.unz, obj.dtype, obj.nsnodes, obj.nlevels,
         obj.ngroups, obj.group_static, obj.groups_at, obj.child_meta,
         obj._mask_off, obj._rows_o_off, obj._a_off,
         lmeta, umeta) = aux
        (obj._masks, obj._a_sel, obj._a_dst, obj._rows_p, obj._rows_o,
         obj._child_idx, obj._child_rsl,
         obj._exL, obj._exU, obj._l_diag, obj.perm_r, obj.perm_c,
         obj._ltpl, obj._utpl, l0, l1, u0, u1,
         obj._l_offpos, obj._u_offpos, obj._u_diagpos) = leaves
        obj._l_slab = (l0, l1, lmeta)
        obj._u_slab = (u0, u1, umeta)
        return obj

    # ---- static-slice views of the flat buffers ---------------------------
    def _group_parts(self, gid):
        """(colmask bool (nb, w), a_sel, a_dst) for one group."""
        nb, w_max, u_max, rmax = self.group_static[gid]
        mo = self._mask_off[gid]
        mask = self._masks[mo:mo + nb * w_max].reshape(nb, w_max)
        s0, s1 = self._a_off[gid], self._a_off[gid + 1]
        return mask, self._a_sel[s0:s1], self._a_dst[s0:s1]

    def _rows_parts(self, gid):
        """(rows_piv (nb, w), rows_off (nb, u)) global row ids."""
        nb, w_max, u_max, rmax = self.group_static[gid]
        po = self._mask_off[gid]       # rows_piv is (nb, w_max) too
        oo = self._rows_o_off[gid]
        rows_p = self._rows_p[po:po + nb * w_max].reshape(nb, w_max)
        rows_o = self._rows_o[oo:oo + nb * u_max].reshape(nb, u_max)
        return rows_p, rows_o

    def _children(self, gid, rmax, dtype):
        """Yield (src_gid, idx (nb, maxc), E (nb, maxc, rmax, su)) with
        the 0/1 expansion one-hots rebuilt on device from slot indices
        (pad slot rmax -> all-zero column)."""
        nb = self.group_static[gid][0]
        for (src, io_, maxc, ro_, su) in self.child_meta[gid]:
            idx = self._child_idx[io_:io_ + nb * maxc].reshape(nb, maxc)
            rsl = self._child_rsl[ro_:ro_ + nb * maxc * su].reshape(
                nb, maxc, su)
            E = (rsl[:, :, None, :] == jnp.arange(
                rmax, dtype=rsl.dtype)[None, None, :, None]).astype(dtype)
            # NOTE (r5): XLA pattern-matches dot(one_hot(idx), X) into a
            # batched-row gather fusion here.  That is FASTER than
            # forcing the real matmul dot (an optimization_barrier on E
            # measured 14.2 vs 12.5 ms per 10k refactorization): the
            # rows being gathered are contiguous su-wide slabs, so the
            # lowering is the same row-DMA trick as ops/gather.py, minus
            # the one-hot flops.  Leave the pattern fusable.
            yield src, idx, E

    # ---- numeric factorization (jittable) --------------------------------
    def factor_values(self, new_data):
        """(Lx, Ux) for the original pattern with ``new_data`` values."""
        from ..ops.gather import ROWG_K, rowgather

        new_data = jnp.asarray(new_data)
        dtype = jnp.result_type(new_data.dtype, self.dtype)
        nd_pad = -(-max(int(new_data.shape[0]), 1) // ROWG_K) * ROWG_K
        front_flats = [None] * self.ngroups
        W_out = [None] * self.ngroups
        # NOTE: a single global A-scatter into one concatenated front
        # buffer was 3x SLOWER at 10k than these per-group scatters on
        # the accelerator this was written for — the big live buffer
        # defeats XLA's fusion of scatter into the group pipeline; keep
        # the per-group form until the H100 says otherwise
        with jax.default_matmul_precision("highest"):
            for L in range(self.nlevels):
                for gid in self.groups_at[L]:
                    nb, w_max, u_max, rmax = self.group_static[gid]
                    mask, sel, dst = self._group_parts(gid)
                    F = jnp.zeros((nb * rmax * rmax,), dtype=dtype)
                    F = F.at[dst].add(rowgather(new_data, sel, nd_pad))
                    F = F.reshape(nb, rmax, rmax)
                    for src, idx, Ec in self._children(gid, rmax, dtype):
                        CW = W_out[src][idx]   # (nb, maxc, us, us)
                        # extend-add as two batched matmuls (an
                        # explicit path: the 3-operand einsum let the
                        # contraction-order heuristic pick worse)
                        T = jnp.einsum("bcij,bcjk->bcik", Ec, CW)
                        F = F + jnp.einsum("bcik,bclk->bil", T, Ec)
                    # factor pivot block (padded cols get unit diagonal)
                    eye = jnp.eye(w_max, dtype=dtype)[None]
                    D = F[:, :w_max, :w_max] + (
                        eye * (~mask[:, None, :]).astype(dtype))
                    M = _dense_lu_nopiv(D)
                    U11 = jnp.triu(M)
                    L11 = jnp.tril(M, -1) + eye
                    B = F[:, w_max:, :w_max]
                    C = F[:, :w_max, w_max:]
                    L21 = jnp.swapaxes(
                        jax.scipy.linalg.solve_triangular(
                            U11, jnp.swapaxes(B, 1, 2), trans="T",
                            lower=False),
                        1, 2)
                    U12 = jax.scipy.linalg.solve_triangular(
                        L11, C, lower=True, unit_diagonal=True)
                    W = F[:, w_max:, w_max:] - L21 @ U12
                    W_out[gid] = W
                    # emit [M | U12] and L21 only — the off/off region
                    # (W, the largest padded block) is never extracted
                    top = jnp.concatenate([M, U12], axis=2)
                    front_flats[gid] = jnp.concatenate(
                        [top.reshape(-1), L21.reshape(-1)])
        flat = (jnp.concatenate(front_flats) if front_flats
                else jnp.zeros((0,), dtype))
        # CSC emission via the rowgather substrate (ops/gather.py): the
        # plain flat[exL] lowered to XLA's near-scalar gather and was
        # the single biggest op of a 10k refactorization (traced
        # 4.8 ms of 20 ms for 725k elements, ~150 M elem/s; rowgather
        # measured 1.9 G elem/s at K=32)
        pad_to = -(-max(int(flat.shape[0]), 1) // ROWG_K) * ROWG_K
        Lx = jnp.where(self._l_diag, jnp.ones((), dtype),
                       rowgather(flat, self._exL, pad_to))
        Ux = rowgather(flat, self._exU, pad_to)
        return Lx, Ux

    def refactor(self, new_data, with_diag: bool = False):
        """SolvePlan with fresh numeric factors (same contract as
        RefactorPlan.refactor; the slab retargeting is shared)."""
        from .refactor import retarget_solve_plan

        if self._ltpl is None:
            raise ValueError(
                "this plan was built with solve_plumbing=False (the "
                "MultifrontalLU front-form path); rebuild with "
                "solve_plumbing=True to use refactor()")
        Lx, Ux = self.factor_values(new_data)
        return retarget_solve_plan(self, Lx, Ux, with_diag)


@jax.tree_util.register_pytree_node_class
class MultifrontalLU(MultifrontalRefactor):
    """FROM-SCRATCH device LU with restricted partial pivoting.

    The refactorization path freezes a host pivot order; this class
    completes the "LU factorize" half on device: the
    host contributes only SYMBOLIC structure (fill pattern + front
    partition from a generic-valued factorization of the sparsity
    pattern), and ``factor_piv(new_data)`` runs the whole numeric
    factorization on device with PARTIAL PIVOTING inside each front's
    fully-summed block (``jax.lax.linalg.lu`` per front batch).  Row
    exchanges restricted to fully-summed variables are exactly the
    legality class the host supernodal kernel uses
    (native/lu_sn.cpp:20-25): any within-block order keeps the fill
    inside the (dense) front, so the symbolic structure stays valid.

    Factors stay in FRONT form — (M = L11\\U11 packed, U12, L21, perm)
    per group — and ``solve_piv`` runs the level schedule forward/
    backward directly on them.  ``stats`` reports min |U11 pivot| and
    max |U| for growth-based fallback to a host pivoted factorization.

    Reference breadcrumb: src/research/scipy_wrappers.py:1-11 (SuperLU
    gssv — the full-pivoting host path this replaces on grids).
    """

    @classmethod
    def from_matrix(cls, a, ordering="nd", relax=16, seed=0):
        """Symbolic-only host work: factor the PATTERN with generic
        diagonally-dominant values (exact cancellation has probability
        zero, so the generic factor's pattern IS the symbolic fill),
        then build the front schedule against the real matrix."""
        from .lu import splu
        from ..types import CSC

        ip, ix, _ = a.np_arrays()
        ip = np.asarray(ip)
        ix = np.asarray(ix)
        n = a.n
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        diag_pos = ix == cols
        if int(diag_pos.sum()) < n:
            raise ValueError(
                "from_matrix needs a full structural diagonal (the "
                "no-pivot symbolic pattern is ill-defined without it)")
        rng = np.random.RandomState(seed)
        gen = 0.01 + 0.1 * rng.rand(len(ix))
        deg = np.diff(ip)
        gen[diag_pos] = deg[cols[diag_pos]] + 1.0   # dominant diagonal
        Ag = CSC(a.m, a.n, ip, ix, gen, canonical=a.canonical)
        lu = splu(Ag, ordering=ordering, tol=0.0)
        if lu.is_singular or not (
                np.isfinite(np.asarray(lu._h.Lx)).all()
                and np.isfinite(np.asarray(lu._h.Ux)).all()):
            raise ValueError("generic-value symbolic factorization "
                             "failed (pattern problem)")
        # the front-form solve never uses the slab retargeting plumbing;
        # skipping it cuts ~10 s of host numpy packing at 10k
        return cls(lu._h, a, relax=relax, solve_plumbing=False)

    # ---- pivoted numeric factorization (jittable) -----------------------
    def factor_piv(self, new_data):
        """new_data -> (factors, stats).

        factors: per-group (M, U12, L21, perm) pytree (front form).
        stats: {"min_pivot", "max_u"} — gate for growth fallback."""
        from ..ops.gather import ROWG_K, rowgather

        new_data = jnp.asarray(new_data)
        dtype = jnp.result_type(new_data.dtype, self.dtype)
        nd_pad = -(-max(int(new_data.shape[0]), 1) // ROWG_K) * ROWG_K
        factors = [None] * self.ngroups
        W_out = [None] * self.ngroups
        min_piv = jnp.asarray(np.inf, dtype)
        max_u = jnp.zeros((), dtype)
        with jax.default_matmul_precision("highest"):
            for L in range(self.nlevels):
                for gid in self.groups_at[L]:
                    nb, w_max, u_max, rmax = self.group_static[gid]
                    mask, sel, dst = self._group_parts(gid)
                    F = jnp.zeros((nb * rmax * rmax,), dtype=dtype)
                    F = F.at[dst].add(rowgather(new_data, sel, nd_pad))
                    F = F.reshape(nb, rmax, rmax)
                    for src, idx, Ec in self._children(gid, rmax, dtype):
                        CW = W_out[src][idx]
                        T = jnp.einsum("bcij,bcjk->bcik", Ec, CW)
                        F = F + jnp.einsum("bcik,bclk->bil", T, Ec)
                    D = F[:, :w_max, :w_max] + (
                        jnp.eye(w_max, dtype=dtype)[None]
                        * (~mask[:, None, :]).astype(dtype))
                    # within-front partial pivoting: D[perm] = L11 U11
                    M, _piv, perm = jax.lax.linalg.lu(D)
                    eye = jnp.eye(w_max, dtype=dtype)[None]
                    U11 = jnp.triu(M)
                    L11 = jnp.tril(M, -1) + eye
                    B = F[:, w_max:, :w_max]
                    C = F[:, :w_max, w_max:]
                    Cp = jnp.take_along_axis(C, perm[:, :, None], axis=1)
                    L21 = jnp.swapaxes(
                        jax.scipy.linalg.solve_triangular(
                            U11, jnp.swapaxes(B, 1, 2), trans="T",
                            lower=False),
                        1, 2)
                    U12 = jax.scipy.linalg.solve_triangular(
                        L11, Cp, lower=True, unit_diagonal=True)
                    W = F[:, w_max:, w_max:] - L21 @ U12
                    W_out[gid] = W
                    factors[gid] = (M, U12, L21, perm)
                    # growth stats over GENUINE columns only
                    genuine = mask
                    du = jnp.abs(jnp.diagonal(M, axis1=1, axis2=2))
                    min_piv = jnp.minimum(
                        min_piv,
                        jnp.min(jnp.where(genuine, du, jnp.inf)))
                    max_u = jnp.maximum(max_u, jnp.max(jnp.abs(U11)))
        return tuple(factors), {"min_pivot": min_piv, "max_u": max_u}

    # ---- front-form solve (jittable) ------------------------------------
    def solve_piv(self, factors, b):
        """x = A^{-1} b from ``factor_piv`` factors; b (n,) or (n, B).
        The result is in ORIGINAL row/column space (the symbolic
        fill-reducing perms are applied internally; the per-front
        pivoting perms live in the factors)."""
        b = jnp.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        dtype = jnp.result_type(b.dtype, self.dtype)
        nB = b.shape[1]
        # permuted RHS + one dummy pad slot (slot n)
        y = jnp.zeros((self.n + 1, nB), dtype)
        y = y.at[:-1].set(b[self.perm_r])
        with jax.default_matmul_precision("highest"):
            for L in range(self.nlevels):
                for gid in self.groups_at[L]:
                    rows_p, rows_o = self._rows_parts(gid)
                    M, U12, L21, perm = factors[gid]
                    w_max = M.shape[1]
                    eye = jnp.eye(w_max, dtype=dtype)[None]
                    bf = y[rows_p]                     # (nb, w_max, B)
                    b1 = jnp.take_along_axis(bf, perm[:, :, None],
                                             axis=1)
                    L11 = jnp.tril(M, -1) + eye
                    z1 = jax.scipy.linalg.solve_triangular(
                        L11, b1, lower=True, unit_diagonal=True)
                    y = y.at[rows_p].set(z1)
                    y = y.at[rows_o].add(-(L21 @ z1))
            for L in range(self.nlevels - 1, -1, -1):
                for gid in self.groups_at[L]:
                    rows_p, rows_o = self._rows_parts(gid)
                    M, U12, L21, perm = factors[gid]
                    xoff = y[rows_o]
                    z1 = y[rows_p]
                    x1 = jax.scipy.linalg.solve_triangular(
                        jnp.triu(M), z1 - U12 @ xoff, lower=False)
                    y = y.at[rows_p].set(x1)
        x = jnp.zeros((self.n, nB), dtype)
        x = x.at[self.perm_c].set(y[:-1])
        return x[:, 0] if squeeze else x
