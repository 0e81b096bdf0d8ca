"""Device numeric LU refactorization (KLU-style).

After one host factorization (pattern + pivot order fixed), repeated
factorizations of matrices with the SAME sparsity pattern but new values
— the Newton power-flow inner loop, parameter sweeps, time series — run
entirely on device, jittable and batchable.

Formulation: the left-looking factorization is re-expressed as a
*level-scheduled wavefront* over columns.  Define a dependency graph on
columns: column k depends on column j when U(j,k) != 0 (column k's
triangular solve uses pivot j) or L(k,j) != 0 (row k of column j's L
feeds cells that column k's updates read).  Group columns into levels of
this DAG (linalg.trisolve.level_schedule).  Then one factorization is a
``lax.scan`` over levels where each level does two dense-indexed steps:

  divide:  L-cells of this level's columns  /=  their pivot cell
  update:  X[dst] -= X[L-cell] * X[U-cell]  for every elementary update
           (j -> k) whose source column j sits in this level

with every index precomputed on host into padded slabs (static shapes).
All value motion is gathers + one scatter-add per step — no host sync.

This is the device answer to "sparse LU with pivoting fights SPMD"
(SURVEY §7 hard parts): pivoting happens ONCE on host; the device path
is static-pivot refactorization + iterative refinement when needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .lu_host import HostLU
from .trisolve import TriSolvePlan, level_schedule
from .lu import SolvePlan

__all__ = ["RefactorPlan"]


def _chunk(arrs, cap):
    """Split parallel arrays into chunks of at most ``cap`` entries."""
    total = len(arrs[0])
    if total == 0:
        return []
    return [
        tuple(a[s : s + cap] for a in arrs) for s in range(0, total, cap)
    ]


@jax.tree_util.register_pytree_node_class
class RefactorPlan:
    """Built from a host factorization + the matrix it factored.

    ``refactor(new_data)`` -> SolvePlan with fresh numeric factors, where
    ``new_data`` is the data array of a CSC with the SAME canonical
    pattern as the original matrix.  Fully jittable; vmap over the data
    axis batches many refactorizations.
    """

    def __init__(self, host: HostLU, a_csc, chunk_cap: int = 1 << 18):
        n = host.n
        Lp, Li = host.Lp.astype(np.int64), host.Li.astype(np.int64)
        Up, Ui = host.Up.astype(np.int64), host.Ui.astype(np.int64)
        lnz, unz = len(Li), len(Ui)
        pinv = np.empty(n, dtype=np.int64)
        pinv[host.perm_r] = np.arange(n)
        qinv = np.empty(n, dtype=np.int64)
        qinv[host.perm_c] = np.arange(n)

        # global sorted keys for position lookup (cols ascend, rows ascend
        # within a column -> key stream is globally sorted)
        key = n + 1
        colsL = np.repeat(np.arange(n), np.diff(Lp))
        colsU = np.repeat(np.arange(n), np.diff(Up))
        keysL = colsL * key + Li
        keysU = colsU * key + Ui

        def posL(r, k):
            return np.searchsorted(keysL, k * key + r)

        def posU(r, k):
            return lnz + np.searchsorted(keysU, k * key + r)

        l_off_pos = np.flatnonzero(Li != colsL)
        u_off_pos = np.flatnonzero(Ui != colsU) + lnz
        ip, rows, _ = a_csc.np_arrays()

        built = None
        try:
            from ..native import host_ext

            built = host_ext.refactor_build(
                n, Lp, Li, Up, Ui, ip, rows, host.perm_r, host.perm_c
            )
        except ImportError:
            pass

        if built is not None:
            a_dst = built["a_dst"]
            nlev = built["nlev"]
            upd_dst_s = built["upd_dst"]
            upd_L_s = built["upd_L"]
            upd_U_s = built["upd_U"]
            div_dst_s = built["div_dst"]
            div_piv_s = built["div_piv"]
            doff = np.concatenate(
                [[0], np.cumsum(np.bincount(built["div_lev"], minlength=nlev))]
            )
            uoff = np.concatenate(
                [[0], np.cumsum(np.bincount(built["upd_lev"], minlength=nlev))]
            )
        else:
            (a_dst, nlev, upd_dst_s, upd_L_s, upd_U_s, uoff,
             div_dst_s, div_piv_s, doff) = self._build_numpy(
                n, Lp, Li, Up, Ui, colsL, colsU, lnz, posL, posU,
                pinv, qinv, ip, rows, l_off_pos, u_off_pos,
            )

        D1 = lnz + unz      # dummy slot that stays 1.0 (division-safe)
        D0 = lnz + unz + 1  # dummy slot that stays 0.0 (update-safe src)

        # one step per level: its divisions then its updates (executed in
        # that order inside the scan body); over-cap levels spill into
        # extra update-only steps
        empty = np.zeros(0, dtype=np.int64)
        steps = []  # (div_dst, div_piv, upd_dst, upd_L, upd_U), ordered
        for level in range(nlev):
            dlo, dhi = doff[level], doff[level + 1]
            ulo, uhi = uoff[level], uoff[level + 1]
            uchunks = _chunk(
                (upd_dst_s[ulo:uhi], upd_L_s[ulo:uhi], upd_U_s[ulo:uhi]),
                chunk_cap,
            ) or [(empty, empty, empty)]
            steps.append((
                div_dst_s[dlo:dhi], div_piv_s[dlo:dhi], *uchunks[0],
            ))
            for c in uchunks[1:]:
                steps.append((empty, empty, *c))

        # ---- segment consecutive steps by width class ---------------------
        # slabs are padded per SEGMENT (not globally): elimination DAGs go
        # wide -> narrow, so contiguous segments of similar width avoid the
        # nlev x max_width blowup of a single global pad
        segments = []  # [steps, max_wd, max_wu]
        for st in steps:
            wd, wu = max(len(st[0]), 1), max(len(st[2]), 1)
            if segments:
                _, md, mu = segments[-1]
                grow = max(wd, md) * max(wu, mu)
                cur = md * mu
                # accept into segment unless the padded area would blow up
                # or this step is much smaller than the segment pad
                if grow <= 2 * cur and wd * 8 >= md and wu * 8 >= mu:
                    segments[-1][0].append(st)
                    segments[-1][1] = max(md, wd)
                    segments[-1][2] = max(mu, wu)
                    continue
            segments.append([[st], wd, wu])

        # int32 slabs: X has < 2^31 cells by construction; halves host
        # packing time and device footprint
        def pack(seg_steps, Wd, Wu):
            ns = len(seg_steps)
            sd = np.full((ns, Wd), D1, dtype=np.int32)
            sp_ = np.full((ns, Wd), D1, dtype=np.int32)
            ud = np.full((ns, Wu), D1, dtype=np.int32)
            ul = np.full((ns, Wu), D0, dtype=np.int32)
            uu = np.full((ns, Wu), D0, dtype=np.int32)
            for i, (dd, dp, u_d, u_l, u_u) in enumerate(seg_steps):
                sd[i, : len(dd)] = dd
                sp_[i, : len(dd)] = dp
                ud[i, : len(u_d)] = u_d
                ul[i, : len(u_l)] = u_l
                uu[i, : len(u_u)] = u_u
            return tuple(jnp.asarray(x) for x in (sd, sp_, ud, ul, uu))

        self.slab_groups = [
            pack(seg, wd, wu) for seg, wd, wu in segments
        ]

        # ---- static metadata & device arrays ------------------------------
        self.n = n
        self.lnz, self.unz = lnz, unz
        self.dtype = host.Lx.dtype
        self.a_dst = jnp.asarray(a_dst)
        self.l_unit = jnp.asarray(posL(np.arange(n), np.arange(n)))
        self.perm_r = jnp.asarray(host.perm_r)
        self.perm_c = jnp.asarray(host.perm_c)

        # ---- solve-plan slab scatter maps ---------------------------------
        # TriSolvePlan slab layout is deterministic for a fixed pattern:
        # build template plans once, record where each factor entry lands.
        self._ltpl = TriSolvePlan(n, host.Lp, host.Li, host.Lx, lower=True)
        self._utpl = TriSolvePlan(n, host.Up, host.Ui, host.Ux, lower=False)
        self._l_slab = self._slab_map(n, host.Lp, host.Li, lower=True)
        self._u_slab = self._slab_map(n, host.Up, host.Ui, lower=False)
        # X positions of off-diag entries in CSC entry order, and diagonals
        self._l_offpos = jnp.asarray(l_off_pos)
        self._u_offpos = jnp.asarray(u_off_pos)
        self._u_diagpos = jnp.asarray(posU(np.arange(n), np.arange(n)))

    @staticmethod
    def _build_numpy(n, Lp, Li, Up, Ui, colsL, colsU, lnz, posL, posU,
                     pinv, qinv, ip, rows, l_off_pos, u_off_pos):
        """Pure-numpy fallback of native host_ext.refactor_build."""
        acols = np.repeat(np.arange(n), np.diff(ip))
        k_of = qinv[acols]
        pr = pinv[rows]
        a_dst = np.where(pr <= k_of, posU(pr, k_of), posL(pr, k_of))

        # per source column j: L off-diag rows (r > j) x U row-j off-diag
        # target columns (k > j)
        l_off_rows = Li[Li != colsL]          # diag-first layout
        l_off_cols = colsL[Li != colsL]
        u_off_rows = Ui[Ui != colsU]
        u_off_cols = colsU[Ui != colsU]

        order_u = np.argsort(u_off_rows, kind="stable")
        u_by_row_cols = u_off_cols[order_u]
        u_by_row_pos = u_off_pos[order_u]
        cnt_u = np.bincount(u_off_rows, minlength=n)
        off_u = np.concatenate([[0], np.cumsum(cnt_u)])
        cnt_l = np.bincount(l_off_cols, minlength=n)
        off_l = np.concatenate([[0], np.cumsum(cnt_l)])

        flops_j = cnt_u * cnt_l
        total = int(flops_j.sum())
        j_of = np.repeat(np.arange(n), flops_j)
        base = np.concatenate([[0], np.cumsum(flops_j)])
        t_local = np.arange(total) - base[j_of]
        cl = cnt_l[j_of]
        ui_idx = t_local // np.maximum(cl, 1)
        li_idx = t_local - ui_idx * cl
        upd_k = u_by_row_cols[off_u[j_of] + ui_idx]
        upd_r = l_off_rows[off_l[j_of] + li_idx]
        upd_L = l_off_pos[off_l[j_of] + li_idx]
        upd_U = u_by_row_pos[off_u[j_of] + ui_idx]
        below = upd_r > upd_k
        upd_dst = np.where(below, posL(upd_r, upd_k), posU(upd_r, upd_k))

        dep_rows = np.concatenate([u_off_cols, l_off_rows])  # dependent col
        dep_cols = np.concatenate([u_off_rows, l_off_cols])  # source col
        lev = level_schedule(n, dep_rows, dep_cols, lower=True)
        nlev = int(lev.max()) + 1 if n else 1

        div_piv_all = posU(l_off_cols, l_off_cols)
        div_lev = lev[l_off_cols]
        upd_lev = lev[j_of]
        dorder = np.argsort(div_lev, kind="stable")
        uorder = np.argsort(upd_lev, kind="stable")
        doff = np.concatenate(
            [[0], np.cumsum(np.bincount(div_lev, minlength=nlev))]
        )
        uoff = np.concatenate(
            [[0], np.cumsum(np.bincount(upd_lev, minlength=nlev))]
        )
        return (
            a_dst, nlev,
            upd_dst[uorder], upd_L[uorder], upd_U[uorder], uoff,
            l_off_pos[dorder], div_piv_all[dorder], doff,
        )

    @staticmethod
    def _slab_map(n, Fp, Fi, lower):
        """Flat slab index (lev * We + slot) of each off-diag factor entry,
        plus (r_slab flat index per row) — mirrors trisolve._build_slabs
        ordering (stable argsort of entry levels)."""
        Fp = np.asarray(Fp)
        Fi = np.asarray(Fi).astype(np.int64)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Fp))
        off = Fi != cols
        rows_o, cols_o = Fi[off], cols[off]
        lev = level_schedule(n, rows_o, cols_o, lower)
        elev = lev[rows_o]
        nlev = int(lev.max()) + 1 if n else 1
        counts = np.bincount(elev, minlength=nlev)
        We = max(int(counts.max()) if counts.size else 1, 1)
        order = np.argsort(elev, kind="stable")
        offs = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(order)) - offs[elev[order]]
        e_flat = np.empty(len(order), dtype=np.int64)
        e_flat[order] = elev[order] * We + slot
        # r_dinv slab position per row
        cnt_r = np.bincount(lev, minlength=nlev)
        Wr = max(int(cnt_r.max()) if cnt_r.size else 1, 1)
        order_r = np.argsort(lev, kind="stable")
        offs_r = np.concatenate([[0], np.cumsum(cnt_r)])
        slot_r = np.arange(n) - offs_r[lev[order_r]]
        r_flat = np.empty(n, dtype=np.int64)
        r_flat[order_r] = lev[order_r] * Wr + slot_r
        return jnp.asarray(e_flat), jnp.asarray(r_flat), (nlev, We, Wr)

    # pytree: everything device is a leaf; templates flatten recursively
    def tree_flatten(self):
        leaves = (
            self.a_dst, self.l_unit, self.slab_groups,
            self.perm_r, self.perm_c, self._ltpl, self._utpl,
            self._l_slab[0], self._l_slab[1], self._u_slab[0], self._u_slab[1],
            self._l_offpos, self._u_offpos, self._u_diagpos,
        )
        aux = (self.n, self.lnz, self.unz, self.dtype,
               self._l_slab[2], self._u_slab[2])
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        (obj.n, obj.lnz, obj.unz, obj.dtype, lmeta, umeta) = aux
        (obj.a_dst, obj.l_unit, obj.slab_groups,
         obj.perm_r, obj.perm_c, obj._ltpl, obj._utpl,
         l0, l1, u0, u1, obj._l_offpos, obj._u_offpos, obj._u_diagpos) = leaves
        obj._l_slab = (l0, l1, lmeta)
        obj._u_slab = (u0, u1, umeta)
        return obj

    # ---- numeric refactorization (jittable) -------------------------------
    def factor_values(self, new_data):
        """(Lx, Ux) for a matrix with the original pattern and ``new_data``
        values (canonical CSC entry order)."""
        new_data = jnp.asarray(new_data)
        dtype = jnp.result_type(new_data.dtype, self.dtype)
        X = jnp.zeros(self.lnz + self.unz + 2, dtype=dtype)
        X = X.at[self.lnz + self.unz].set(1)  # D1
        X = X.at[self.l_unit].set(1)
        X = X.at[self.a_dst].add(new_data)

        def body(X, slab):
            dd, dp, ud, ul, uu = slab
            X = X.at[dd].set(X[dd] / X[dp])
            X = X.at[ud].add(-(X[ul] * X[uu]))
            # keep dummies clean for the next step
            X = X.at[self.lnz + self.unz].set(1)
            X = X.at[self.lnz + self.unz + 1].set(0)
            return X, None

        for group in self.slab_groups:
            X, _ = jax.lax.scan(body, X, group)
        return X[: self.lnz], X[self.lnz : self.lnz + self.unz]

    def _retarget(self, tpl: TriSolvePlan, slab, off_vals, dinv, meta):
        # The template plan's slabs are level-unrolled to (nsteps, K, W)
        # with padding levels appended at the end, so the flat index
        # lev * W + slot is valid in the larger unrolled buffer; the pad
        # region keeps the identity fill (0 for values, 1 for 1/diag).
        e_flat, r_flat, (nlev, We, Wr) = slab[0], slab[1], meta
        e_shape = tpl.e_vals.shape
        r_shape = tpl.r_dinv.shape
        e_vals = (
            jnp.zeros(int(np.prod(e_shape)), dtype=off_vals.dtype)
            .at[e_flat].set(off_vals).reshape(e_shape)
        )
        r_dinv = (
            jnp.ones(int(np.prod(r_shape)), dtype=dinv.dtype)
            .at[r_flat].set(dinv).reshape(r_shape)
        )
        leaves, treedef = jax.tree_util.tree_flatten(tpl)
        # leaves: (e_rows, e_cols, e_vals, r_rows, r_dinv)
        new_leaves = [leaves[0], leaves[1], e_vals, leaves[3], r_dinv]
        return jax.tree_util.tree_unflatten(treedef, new_leaves)

    def refactor(self, new_data, with_diag: bool = False):
        """SolvePlan with fresh numeric factors (jittable, vmap-able over
        a leading batch axis of new_data via jax.vmap).

        with_diag=True also returns the U diagonal — min|u|/max|u| is the
        KLU-style cheap rcond estimate callers use to flag (near-)singular
        refactorizations (frozen pivots turn structural singularity into a
        zero-or-noise pivot, NOT necessarily inf/nan output)."""
        Lx, Ux = self.factor_values(new_data)
        return retarget_solve_plan(self, Lx, Ux, with_diag)


def retarget_solve_plan(obj, Lx, Ux, with_diag: bool = False):
    """Shared refactor() plumbing for every device refactorization
    class that stores the RefactorPlan template layout (``_ltpl`` /
    ``_utpl`` TriSolvePlans, ``_l_slab``/``_u_slab`` retarget maps and
    the ``_l_offpos``/``_u_offpos``/``_u_diagpos`` gather positions):
    gather the freshly factored values into the stored solve plans and
    return a SolvePlan (plus the U diagonal when ``with_diag``)."""
    from ..ops.gather import ROWG_K, rowgather

    X = jnp.concatenate([Lx, Ux])
    # rowgather substrate: the three plain X[pos] gathers (~lnz+unz
    # elements total) lower to XLA's near-scalar gather otherwise
    pad = -(-max(int(X.shape[0]), 1) // ROWG_K) * ROWG_K
    l_off = rowgather(X, obj._l_offpos, pad)
    u_off = rowgather(X, obj._u_offpos, pad)
    u_diag = rowgather(X, obj._u_diagpos, pad)
    lplan = RefactorPlan._retarget(
        obj, obj._ltpl, obj._l_slab, l_off,
        jnp.ones(obj.n, dtype=X.dtype), obj._l_slab[2])
    uplan = RefactorPlan._retarget(
        obj, obj._utpl, obj._u_slab, u_off, 1.0 / u_diag, obj._u_slab[2])
    plan = SolvePlan(lplan, uplan, obj.perm_r, obj.perm_c)
    return (plan, u_diag) if with_diag else plan
