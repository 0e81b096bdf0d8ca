"""On-chip SpGEMM: expand–sort–compress (ESC) entirely on device.

The reference's flagship native kernel pair ``csr_matmat_pass1/pass2``
(src/sparsetools/csr.h:562-601 symbolic mask loop, :609-670 numeric
linked-list loop) is a per-row sequential Gustavson — it does not
vectorize.  The device formulation here runs BOTH phases on the device:

  expand    per intermediate product t: locate its (A-entry, B-entry)
            pair with vectorized searchsorted over the indptrs — pure
            gathers, no host loop;
  sort      one ``lax.sort`` of the fused (col*m + row) key stream
            (two-key lexicographic sort when m*n overflows int32);
  compress  boundary flags -> ``cumsum`` group ids -> one
            ``segment_sum``; unique keys via ``segment_max``.

The ONE host-side number is the intermediate-product count ``total``
(the static capacity every XLA buffer needs — the analogue of the
reference's nnz-overflow guard, csr.h:591-596, resolved ahead of jit
instead of by realloc).  Everything value- and pattern-dependent beyond
that scalar — including the output nnz and the output pattern — is
computed on device, so repeated calls with NEW patterns of the same
capacity recompile nothing and transfer nothing.

``ESCSpGEMM.__call__(a_data, b_data)`` is jittable/scannable and returns
capacity-padded output arrays plus the traced output nnz;
``spgemm_device(a, b)`` is the eager wrapper that trims to a canonical
CSC on host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_config
from ..types import CSC

__all__ = ["ESCSpGEMM", "spgemm_device", "gram_device"]


@jax.tree_util.register_pytree_node_class
class ESCSpGEMM:
    """Jittable device ESC SpGEMM plan for C = A @ B.

    Fixed at build time: shapes and the product capacity ``total`` (from
    the patterns, host).  Everything else — expansion, sort, compress,
    output pattern — runs on device per call, so the plan stays valid
    for any A/B values (and even for new patterns whose product count
    does not exceed ``total``, when constructed with a larger explicit
    ``capacity``).
    """

    def __init__(self, a: CSC, b: CSC, capacity: int | None = None):
        if a.n != b.m:
            raise ValueError(f"dim mismatch for A@B: {a.shape} @ {b.shape}")
        ipa, _, _ = a.np_arrays()
        ipb, b_rows, _ = b.np_arrays()
        counts = (ipa[b_rows.astype(np.int64) + 1]
                  - ipa[b_rows.astype(np.int64)]).astype(np.int64)
        total = int(counts.sum())
        if capacity is not None:
            if capacity < total:
                raise ValueError(
                    f"capacity {capacity} < product count {total}")
            total = int(capacity)
        self.m, self.n, self.k = a.m, b.n, a.n
        self.total = total
        # fused int32 sort key when col*(m+1) + row fits for every key
        # INCLUDING the padding sentinel (col=n, row=m → max key
        # (m+1)*(n+1) - 1); a bare m*n guard overflows for e.g.
        # m = n = 46341 and wraps keys negative, corrupting the sort
        self.fused = (a.m + 1) * (b.n + 1) <= 2**31
        self.ap = a.indptr
        self.ai = a.indices
        self.bp = b.indptr
        self.bi = b.indices

    def tree_flatten(self):
        return ((self.ap, self.ai, self.bp, self.bi),
                (self.m, self.n, self.k, self.total, self.fused))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.m, obj.n, obj.k, obj.total, obj.fused = aux
        obj.ap, obj.ai, obj.bp, obj.bi = ch
        return obj

    def __call__(self, a_data, b_data):
        """(a_data, b_data) -> (indptr, rows, data, nnz).

        ``rows``/``data`` are capacity-padded to ``total``; entries past
        ``nnz`` are row id ``m`` / value 0.  ``indptr`` is exact (the
        padding rows live in a virtual column n that indptr drops).
        """
        m, n, total = self.m, self.n, self.total
        idt = self.ap.dtype
        a_data = jnp.asarray(a_data)
        b_data = jnp.asarray(b_data)
        if total == 0:
            return (jnp.zeros((n + 1,), idt), jnp.zeros((0,), idt),
                    jnp.zeros((0,), jnp.result_type(a_data, b_data)),
                    jnp.zeros((), idt))
        nnzb = self.bi.shape[0]
        # --- expand (device): per product, its (A-entry, B-entry) pair --
        # column of each B entry: invert B's indptr
        bcol = jnp.searchsorted(
            self.bp[1:].astype(jnp.int32), jnp.arange(nnzb, dtype=jnp.int32),
            side="right")
        cnt = (self.ap[self.bi + 1] - self.ap[self.bi]).astype(jnp.int32)
        off_incl = jnp.cumsum(cnt)
        # B-entry id of each product: first entry whose inclusive offset
        # exceeds t
        e = jnp.searchsorted(off_incl, jnp.arange(total, dtype=jnp.int32),
                             side="right")
        e = jnp.minimum(e, nnzb - 1)  # capacity padding tail -> last entry
        live = jnp.arange(total, dtype=jnp.int32) < off_incl[-1]
        local = jnp.arange(total, dtype=jnp.int32) - (off_incl[e] - cnt[e])
        a_pos = self.ap[self.bi[e]].astype(jnp.int32) + local
        rows = self.ai[a_pos].astype(jnp.int32)
        cols = bcol[e].astype(jnp.int32)
        vals = jnp.where(live, a_data[a_pos] * b_data[e], 0)
        # padding products get an out-of-range key so they sort last
        rows = jnp.where(live, rows, m)
        cols = jnp.where(live, cols, n)
        # --- sort (device) ------------------------------------------------
        if self.fused:
            key = cols * jnp.int32(m + 1) + rows
            key_s, v_s = jax.lax.sort((key, vals), num_keys=1)
            r_s = key_s % (m + 1)
            c_s = key_s // (m + 1)
        else:
            c_s, r_s, v_s = jax.lax.sort((cols, rows, vals), num_keys=2)
        # --- compress (device) ---------------------------------------------
        pad_s = (r_s == m) | (c_s == n)
        first = jnp.concatenate([
            jnp.ones((1,), bool),
            (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1]),
        ])
        new = first & ~pad_s
        gid = jnp.cumsum(new.astype(jnp.int32)) - 1
        nnz = gid[-1] + 1
        data = jax.ops.segment_sum(
            jnp.where(pad_s, 0, v_s), jnp.maximum(gid, 0),
            num_segments=total)
        rows_u = jax.ops.segment_max(
            jnp.where(pad_s, -1, r_s), jnp.maximum(gid, 0),
            num_segments=total)
        cols_u = jax.ops.segment_max(
            jnp.where(pad_s, -1, c_s), jnp.maximum(gid, 0),
            num_segments=total)
        # empty segments (beyond nnz) -> padding markers
        pad_out = jnp.arange(total, dtype=jnp.int32) >= nnz
        rows_u = jnp.where(pad_out, m, rows_u).astype(idt)
        data = jnp.where(pad_out, 0, data)
        hist = jnp.bincount(jnp.where(pad_out, n, cols_u), length=n + 1)[:n]
        indptr = jnp.concatenate([
            jnp.zeros((1,), idt), jnp.cumsum(hist).astype(idt)])
        return indptr, rows_u, data, nnz.astype(idt)


def spgemm_device(a: CSC, b: CSC) -> CSC:
    """Eager C = A @ B with expansion/sort/compress on device (ESC).

    One host scalar (the product capacity) gates the static shapes; the
    result downloads once and trims to a canonical CSC.  For repeated
    products inside jit, hold an ``ESCSpGEMM`` and consume its padded
    output directly.
    """
    plan = ESCSpGEMM(a, b)
    indptr, rows, data, nnz = jax.jit(plan.__call__)(a.data, b.data)
    nnz = int(nnz)
    idx = np.dtype(get_config().index_dtype)
    return CSC(a.m, b.n,
               np.asarray(indptr).astype(idx, copy=False),
               np.asarray(rows[:nnz]).astype(idx, copy=False),
               np.asarray(data[:nnz]), canonical=True)


def gram_device(a: CSC) -> CSC:
    """A @ A.T on device (the GridCal connectivity product), via ESC
    with the host-transposed structure as B."""
    from . import construct

    return spgemm_device(a, construct.transpose(a))
