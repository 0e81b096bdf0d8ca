"""SpGEMM: C = A @ B, two-phase (symbolic + numeric).

Reference algorithm: Gustavson CSC with a dense scatter workspace and a
linked-list accumulator — csc_multiply_ff (src/CSparse3/csc_numba.py:222-306,
with the sqrt(m)*anz+bnz capacity heuristic at :253 and doubling realloc at
:261-278) and the scipy pair csr_matmat_pass1/pass2
(src/sparsetools/csr.h:562-601 symbolic mask loop, :609-670 numeric
linked-list loop).

Per-row linked lists do not vectorize; the device formulation is
**expand–sort–compress (ESC)**:

  expand   every entry B[k,j] replicates column A[:,k) scaled by B[k,j]
           -> a stream of (row, col, val) partial products (pure gathers)
  sort     stable sort the stream by (col, row)         (one XLA sort)
  compress segment-sum duplicates                        (one segment op)

The *symbolic* phase is exact and cheap: the intermediate-product count is
sum over B-entries of nnz(A[:, rowof(B-entry)]), and the output nnz falls
out of the duplicate-collapse — no heuristic capacity, no realloc.  The
(perm, gid) plan from the symbolic phase is reusable: ``SpGEMMPlan`` lets
repeated numeric multiplies with fixed patterns run entirely under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_config
from ..types import CSC
from . import construct

__all__ = ["spgemm", "spgemm_symbolic", "SpGEMMPlan", "gram",
           "gram_symbolic", "GramPlan"]


def _expanded_streams_np(a: CSC, b: CSC):
    """Expansion phase (host): per intermediate product t, indices into A's
    and B's entry arrays.  Returns (a_pos, b_pos, out_cols, total)."""
    ipa, _, _ = a.np_arrays()
    ipb, b_rows, _ = b.np_arrays()
    b_cols = construct.expand_indptr_np(ipb)
    # products contributed by each B entry = nnz of that A column
    counts = (ipa[b_rows + 1] - ipa[b_rows]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return None, None, None, 0
    offsets = np.concatenate([[0], np.cumsum(counts)])
    e = np.repeat(np.arange(len(b_rows), dtype=np.int64), counts)
    local = np.arange(total, dtype=np.int64) - offsets[e]
    a_pos = ipa[b_rows[e]].astype(np.int64) + local
    return a_pos, e, b_cols[e], total


def spgemm(a: CSC, b: CSC) -> CSC:
    """C = A @ B (reference: CscMat.dot, csc.py:483-500 — the correct
    general-dims path; CscMat.__mul__'s square-only dim quirk at
    csc.py:354-370 is intentionally NOT replicated, see SURVEY §7).
    Host-eager (output nnz is data-dependent); for repeated products with
    a fixed pattern use ``spgemm_symbolic`` + ``SpGEMMPlan.numeric``.

    Dtype policy (reference instantiates T over bool..int64..clongdouble,
    sparsetools.cxx:44, csr.i:12-41): float/complex ride the native host
    kernel; INTEGER values ride the numpy triplet path below, exact in
    the input dtype (int64 containers hold int32 on device — the integer
    analogue of the f64 -> f32 device value policy)."""
    if a.n != b.m:
        raise ValueError(f"dim mismatch for A@B: {a.shape} @ {b.shape}")
    a = a if a.canonical else construct.canonicalize(a)
    b = b if b.canonical else construct.canonicalize(b)
    try:
        from ..native import host_ext

        ipa, ixa, dta = a.np_arrays()
        ipb, ixb, dtb = b.np_arrays()
        if np.issubdtype(np.result_type(dta, dtb), np.floating) or \
                np.issubdtype(np.result_type(dta, dtb), np.complexfloating):
            Cp, Ci, Cx = host_ext.csc_spgemm(
                a.m, ipa, ixa, dta, b.n, ipb, ixb, dtb
            )
            idx = np.dtype(get_config().index_dtype)
            return CSC(a.m, b.n, Cp.astype(idx, copy=False),
                       Ci.astype(idx, copy=False),
                       Cx.astype(np.result_type(dta, dtb), copy=False),
                       canonical=True)
    except ImportError:
        pass
    a_pos, b_pos, out_cols, total = _expanded_streams_np(a, b)
    dtype = np.result_type(a.np_arrays()[2].dtype, b.np_arrays()[2].dtype)
    if total == 0:
        idx = get_config().index_dtype
        return CSC(
            a.m, b.n,
            jnp.zeros((b.n + 1,), idx), jnp.zeros((0,), idx), jnp.zeros((0,), dtype),
        )
    _, a_rows, a_vals = a.np_arrays()
    _, _, b_vals = b.np_arrays()
    rows = a_rows[a_pos]
    vals = a_vals[a_pos] * b_vals[b_pos]
    return construct.from_triplets(rows, out_cols, vals, (a.m, b.n))


def gram(a: CSC) -> CSC:
    """A @ A.T — the GridCal connectivity product
    (reference flow: test3_lil_matrix.py A = C * C.t()).

    Native path: one fused C++ kernel (lower-half Gustavson + sorted
    mirror) — no explicit transpose, half the accumulate/sort work of
    the general SpGEMM.  The symbolic phase (A^T pattern, output
    pattern) caches ON the container: repeated grams of the same
    immutable matrix re-run only the numeric pass (``csc_gram_revalue``
    — the SpGEMM analogue of KLU refactorization; containers are
    immutable, reference csc.py:288-292, so the cache cannot go stale).
    Falls back to spgemm(a, a.T)."""
    a = a if a.canonical else construct.canonicalize(a)
    try:
        from ..native import host_ext

        ip, rows, vals = a.np_arrays()
        if np.issubdtype(vals.dtype, np.floating) or \
                np.issubdtype(vals.dtype, np.complexfloating):
            idx = np.dtype(get_config().index_dtype)
            sym = getattr(a, "_gram_sym", None)
            if sym is not None and sym["vdt"] == host_ext._host_vdt(
                    np.iscomplexobj(vals), vals):
                Cx = host_ext.csc_gram_revalue(ip, rows, vals, sym)
                return CSC(a.m, a.m,
                           sym["Cp"].astype(idx, copy=False),
                           sym["Ci"][:sym["nnz"]].astype(idx, copy=False),
                           Cx[:sym["nnz"]].astype(vals.dtype, copy=False),
                           canonical=True)
            Cp, Ci, Cx, sym = host_ext.csc_gram_cached(
                a.m, a.n, ip, rows, vals)
            a._gram_sym = sym
            return CSC(a.m, a.m, Cp.astype(idx, copy=False),
                       Ci.astype(idx, copy=False),
                       Cx.astype(vals.dtype, copy=False), canonical=True)
    except ImportError:
        pass
    return spgemm(a, construct.transpose(a))


from .gather import ROWG_K as _ROWG_K, rowgather as _rowgather


class SpGEMMPlan:
    """Reusable structural plan for C = A @ B with fixed patterns.

    ``numeric(a_vals, b_vals)`` is pure jax (jittable, differentiable).
    The round-4 layout folds the canonical-order permutation into the
    gather index maps at build time and replaces every big index-driven
    stream with ``_rowgather``; the compress exploits that most outputs
    have exactly ONE product (a gather, not a reduction), with a
    segment_sum only over the multi-product tail — 3 fast streams
    instead of 3 near-scalar gathers + a near-scalar segment_sum."""

    def __init__(self, a_pos, b_pos, perm, gid, out_nnz, out_csc_template,
                 v2=None):
        self.a_pos = a_pos
        self.b_pos = b_pos
        self.perm = perm
        self.gid = gid
        self.out_nnz = out_nnz
        self.template = out_csc_template  # CSC with correct structure, data zeros
        # v2 maps: (pa_s, pb_s, sel, tailpos, tailgid, ntail, padA, padB)
        self._v2 = v2

    def numeric(self, a_vals, b_vals) -> CSC:
        t = self.template
        if self._v2 is None:
            prod = a_vals[self.a_pos] * b_vals[self.b_pos]
            data = jax.ops.segment_sum(
                prod[self.perm], self.gid, num_segments=self.out_nnz
            )
            return CSC(t.m, t.n, t.indptr, t.indices, data, nnz=t.nnz,
                       canonical=True)
        pa_s, pb_s, sel, tailpos, tailgid, ntail, padA, padB = self._v2
        a_vals = jnp.asarray(a_vals)
        b_vals = jnp.asarray(b_vals)
        ga = _rowgather(a_vals, pa_s, padA)
        gb = _rowgather(b_vals, pb_s, padB)
        w = ga * gb                                  # products, gid-sorted
        if int(ntail):
            tw = _rowgather(w, tailpos,
                            -(-w.shape[0] // _ROWG_K) * _ROWG_K)
            tails = jax.ops.segment_sum(tw, tailgid,
                                        num_segments=int(ntail))
            w2 = jnp.concatenate([w, tails])
        else:
            w2 = w
        data = _rowgather(w2, sel, -(-w2.shape[0] // _ROWG_K) * _ROWG_K)
        return CSC(t.m, t.n, t.indptr, t.indices, data, nnz=t.nnz,
                   canonical=True)


def spgemm_symbolic(a: CSC, b: CSC) -> SpGEMMPlan:
    """Symbolic phase: compute the output pattern and the (perm, gid)
    compress plan (reference: csc_matmat_pass1 semantics, csr.h:562-601,
    exact rather than capacity-heuristic)."""
    if a.n != b.m:
        raise ValueError(f"dim mismatch for A@B: {a.shape} @ {b.shape}")
    a_pos, b_pos, out_cols, total = _expanded_streams_np(a, b)
    cfg = get_config()
    idx = np.dtype(cfg.index_dtype)
    dtype = np.result_type(a.np_arrays()[2].dtype, b.np_arrays()[2].dtype)
    if total == 0:
        empty = CSC(
            a.m, b.n,
            jnp.zeros((b.n + 1,), cfg.index_dtype),
            jnp.zeros((0,), cfg.index_dtype),
            jnp.zeros((0,), dtype),
        )
        z = jnp.zeros((0,), cfg.index_dtype)
        return SpGEMMPlan(z, z, z, z, 0, empty)
    rows = a.np_arrays()[1][a_pos]
    # fused-key stable argsort = radix sort (see construct.from_triplets)
    perm = np.argsort(out_cols.astype(np.int64) * a.m + rows, kind="stable")
    r_s, c_s = rows[perm], out_cols[perm]
    new = np.empty(total, dtype=bool)
    new[0] = True
    new[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    gid = np.cumsum(new) - 1
    out_nnz = int(gid[-1]) + 1
    u_rows = r_s[new].astype(idx)
    u_cols = c_s[new].astype(idx)
    indptr = np.zeros(b.n + 1, dtype=idx)
    indptr[1:] = np.cumsum(np.bincount(u_cols, minlength=b.n))
    template = CSC(a.m, b.n, indptr, u_rows, np.zeros(out_nnz, dtype=dtype))

    # ---- v2 compress maps (host numpy) --------------------------------
    # gather maps with the canonical-order perm folded in
    pa_s = a_pos[perm].astype(np.int32)
    pb_s = b_pos[perm].astype(np.int32)
    seg_start = np.flatnonzero(new).astype(np.int32)     # per output
    seg_len = np.diff(np.append(seg_start, total))
    multi = seg_len > 1
    # products belonging to multi-product outputs, and their tail-local
    # segment ids (gid is sorted, so a cumsum over `multi[gid]` groups)
    tailpos = np.flatnonzero(multi[gid]).astype(np.int32)
    tail_out = np.flatnonzero(multi).astype(np.int32)    # output ids
    ntail = len(tail_out)
    tailgid = np.searchsorted(tail_out, gid[tailpos]).astype(np.int32)
    # final per-output select: len-1 outputs read their single product
    # straight out of w; multi outputs read their tail segment sum
    sel = seg_start.copy()
    sel[multi] = total + np.arange(ntail, dtype=np.int32)
    K = _ROWG_K
    padA = -(-max(len(a.np_arrays()[1]), 1) // K) * K
    padB = -(-max(len(b.np_arrays()[1]), 1) // K) * K
    v2 = (jnp.asarray(pa_s), jnp.asarray(pb_s), jnp.asarray(sel),
          jnp.asarray(tailpos), jnp.asarray(tailgid), ntail, padA, padB)
    return SpGEMMPlan(
        jnp.asarray(a_pos), jnp.asarray(b_pos), jnp.asarray(perm),
        jnp.asarray(gid), out_nnz, template, v2=v2,
    )


class GramPlan:
    """Reusable plan for C = A @ A.T exploiting symmetry on device.

    The generic ``SpGEMMPlan`` gathers ~3 nnz(products) elements per
    numeric pass (two value gathers + the output select), so halving the
    product stream is the lever.  This plan forms products ONLY for the lower
    triangle of C (the host ``gram`` kernel's trick,
    native/host_ext.cpp) and the mirror is FREE: the upper outputs'
    select indices are composed with the mirror permutation on host, so
    the final rowgather reads each lower value twice instead of running
    a second gather pass (~2 nnz(products) gathered elements total).

    ``numeric(a_vals)`` takes only A's value array (A.T values are the
    same array through the host-composed transpose permutation).
    Reference: csc_multiply_ff applied to (A, A^T) — test3's
    A = C * C.t() flow (src/test/test3_lil_matrix.py).
    """

    def __init__(self, pa, pb, sel_full, tailpos, tailgid, ntail, pad,
                 out_nnz, template):
        self.pa = pa
        self.pb = pb
        self.sel_full = sel_full
        self.tailpos = tailpos
        self.tailgid = tailgid
        self.ntail = ntail
        self.pad = pad
        self.out_nnz = out_nnz
        self.template = template

    def numeric(self, a_vals) -> CSC:
        t = self.template
        a_vals = jnp.asarray(a_vals)
        ga = _rowgather(a_vals, self.pa, self.pad)
        gb = _rowgather(a_vals, self.pb, self.pad)
        w = ga * gb                       # lower-triangle products
        if int(self.ntail):
            tw = _rowgather(w, self.tailpos,
                            -(-w.shape[0] // _ROWG_K) * _ROWG_K)
            tails = jax.ops.segment_sum(tw, self.tailgid,
                                        num_segments=int(self.ntail))
            w2 = jnp.concatenate([w, tails])
        else:
            w2 = w
        data = _rowgather(w2, self.sel_full,
                          -(-w2.shape[0] // _ROWG_K) * _ROWG_K)
        return CSC(t.m, t.n, t.indptr, t.indices, data, nnz=t.nnz,
                   canonical=True)


def gram_symbolic(a: CSC) -> GramPlan:
    """Symbolic phase for C = A @ A.T with the symmetry folded into the
    compress maps (see ``GramPlan``)."""
    a = a if a.canonical else construct.canonicalize(a)
    # transpose with value-tracking: B.data = A.data[tperm]
    ipa, ixa, dta = a.np_arrays()
    nnz_a = len(ixa)
    track = CSC(a.m, a.n, ipa, ixa,
                np.arange(nnz_a, dtype=np.float64), canonical=True)
    bt = construct.transpose(track)
    ipb, ixb, tpf = bt.np_arrays()
    tperm = np.asarray(tpf, dtype=np.int64)
    b = CSC(a.n, a.m, ipb, ixb, np.zeros(nnz_a, dta.dtype),
            canonical=True)

    cfg = get_config()
    idx = np.dtype(cfg.index_dtype)
    dtype = np.asarray(dta).dtype
    a_pos, b_pos, out_cols, total = _expanded_streams_np(a, b)
    if total == 0:
        empty = CSC(a.m, a.m, jnp.zeros((a.m + 1,), cfg.index_dtype),
                    jnp.zeros((0,), cfg.index_dtype),
                    jnp.zeros((0,), dtype))
        z = jnp.zeros((0,), jnp.int32)
        return GramPlan(z, z, z, z, z, 0, _ROWG_K, 0, empty)

    rows = np.asarray(ixa)[a_pos]
    m = a.m
    perm = np.argsort(out_cols.astype(np.int64) * m + rows,
                      kind="stable")
    r_s, c_s = rows[perm], out_cols[perm]
    new = np.empty(total, dtype=bool)
    new[0] = True
    new[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    gid = np.cumsum(new) - 1
    out_nnz = int(gid[-1]) + 1
    u_rows = r_s[new].astype(np.int64)
    u_cols = c_s[new].astype(np.int64)
    indptr = np.zeros(m + 1, dtype=idx)
    indptr[1:] = np.cumsum(np.bincount(u_cols, minlength=m))
    template = CSC(m, m, indptr, u_rows.astype(idx),
                   np.zeros(out_nnz, dtype=dtype))

    # ---- lower-triangle product stream --------------------------------
    lower_prod = r_s >= c_s                     # gid-uniform by construction
    pa_l = a_pos[perm][lower_prod].astype(np.int32)
    # fold B.data = A.data[tperm] so numeric needs only a_vals
    pb_l = tperm[b_pos[perm][lower_prod]].astype(np.int32)
    lower_out = u_rows >= u_cols
    nl = int(lower_out.sum())
    lower_rank = np.cumsum(lower_out) - 1       # full slot -> lower rank
    gl = lower_rank[gid[lower_prod]]
    total_l = len(pa_l)
    new_l = np.empty(total_l, dtype=bool)
    new_l[0] = True
    new_l[1:] = gl[1:] != gl[:-1]
    seg_start = np.flatnonzero(new_l).astype(np.int32)
    seg_len = np.diff(np.append(seg_start, total_l))
    multi = seg_len > 1
    tailpos = np.flatnonzero(multi[gl]).astype(np.int32)
    tail_out = np.flatnonzero(multi).astype(np.int32)
    ntail = len(tail_out)
    tailgid = np.searchsorted(tail_out, gl[tailpos]).astype(np.int32)
    sel_l = seg_start.copy()                    # per LOWER output
    sel_l[multi] = total_l + np.arange(ntail, dtype=np.int32)

    # ---- mirror composed on host: full slot -> lower w2 position ------
    # slots sorted by key (col*m + row); the partner of (r, c) is (c, r)
    key = u_cols * m + u_rows
    partner = np.searchsorted(key, u_rows * m + u_cols)
    src_slot = np.where(lower_out, np.arange(out_nnz), partner)
    sel_full = sel_l[lower_rank[src_slot]].astype(np.int32)

    pad = -(-max(nnz_a, 1) // _ROWG_K) * _ROWG_K
    assert nl == len(sel_l)
    return GramPlan(jnp.asarray(pa_l), jnp.asarray(pb_l),
                    jnp.asarray(sel_full), jnp.asarray(tailpos),
                    jnp.asarray(tailgid), ntail, pad, out_nnz, template)
