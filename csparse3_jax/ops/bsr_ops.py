"""Native BSR block operations — no scalar-CSC round trip.

Reference kernels these map to (semantics, not implementation):
  - ``bsr_transpose``            src/sparsetools/bsr.h:212
  - ``bsr_binop_bsr_*`` family   src/sparsetools/bsr.h:349-694
  - ``bsr_matmat_pass2``         src/sparsetools/bsr.h:249-316
    (block-Gustavson with R×C×N register blocks)

The reference walks per-block-row with dense accumulators; here the
block *pattern* work is O(#blocks) host integer numpy (sorts, merges,
searchsorted — the symbolic phase), and the block *value* work is
batched device ops over the (nblocks, R, C) stacks:

  transpose  one gather + ``swapaxes`` of the block stack
  binop      scatter/gather into union-aligned stacks + elementwise op
  matmat     one batched ``einsum('prc,pcq->prq')`` over product pairs
             (pure matmul) + one ``segment_sum`` into output blocks

``BSRMatMatPlan`` keeps the symbolic result for repeated numeric
products with fixed block patterns (jittable).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_config
from ..types import BSR

__all__ = ["bsr_transpose", "bsr_add", "bsr_binop", "bsr_matmat",
           "BSRMatMatPlan"]


def _block_pattern(a: BSR):
    """(block_rows, block_cols) of the stored blocks, host int64."""
    ip = np.asarray(a.indptr)
    bc = np.asarray(a.indices)[: a.nnz_blocks].astype(np.int64)
    br = np.repeat(np.arange(a.mb, dtype=np.int64), np.diff(ip))
    return br, bc


def _indptr_from(rows_sorted, nrows, idx_dtype):
    ip = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(ip, rows_sorted + 1, 1)
    return np.cumsum(ip).astype(idx_dtype)


def bsr_transpose(a: BSR) -> BSR:
    """Block transpose: permute blocks to column-major order and swap
    each block's axes — one device gather over the stack."""
    cfg = get_config()
    br, bc = _block_pattern(a)
    order = np.argsort(bc * a.mb + br, kind="stable")
    indptr = _indptr_from(bc[order], a.nb, cfg.index_dtype)
    indices = br[order].astype(cfg.index_dtype)
    data = jnp.swapaxes(a.data[: a.nnz_blocks][jnp.asarray(order)], 1, 2)
    return BSR(a.n, a.m, a.C, a.R, jnp.asarray(indptr),
               jnp.asarray(indices), data, nnz_blocks=a.nnz_blocks)


def _union_pattern(a: BSR, b: BSR):
    if a.shape != b.shape or (a.R, a.C) != (b.R, b.C):
        raise ValueError(
            f"BSR binop needs matching shape and block: "
            f"{a.shape}/{a.R}x{a.C} vs {b.shape}/{b.R}x{b.C}")
    bra, bca = _block_pattern(a)
    brb, bcb = _block_pattern(b)
    ka = bra * a.nb + bca
    kb = brb * a.nb + bcb
    uni = np.union1d(ka, kb)
    return uni, np.searchsorted(uni, ka), np.searchsorted(uni, kb)


def _union_bsr(a, uni, data):
    cfg = get_config()
    rows = (uni // a.nb)
    indptr = _indptr_from(rows, a.mb, cfg.index_dtype)  # uni already sorted
    indices = (uni % a.nb).astype(cfg.index_dtype)
    return BSR(a.m, a.n, a.R, a.C, jnp.asarray(indptr),
               jnp.asarray(indices), data, nnz_blocks=len(uni))


def bsr_add(a: BSR, b: BSR, alpha=1.0, beta=1.0) -> BSR:
    """alpha*A + beta*B over the union block pattern (scatter-add into
    union-aligned stacks — bsr_plus_bsr/bsr_minus_bsr semantics)."""
    uni, pa, pb = _union_pattern(a, b)
    dt = jnp.result_type(a.data.dtype, b.data.dtype)
    out = jnp.zeros((max(len(uni), 1), a.R, a.C), dtype=dt)
    out = out.at[jnp.asarray(pa)].add(alpha * a.data[: a.nnz_blocks])
    out = out.at[jnp.asarray(pb)].add(beta * b.data[: b.nnz_blocks])
    return _union_bsr(a, uni, out)


def bsr_binop(a: BSR, b: BSR, op) -> BSR:
    """General elementwise binop over the union pattern: gather both
    stacks into alignment, apply ``op`` (e.g. ``jnp.multiply``,
    ``jnp.maximum``) blockwise.  Missing blocks are zero, matching the
    reference's dense-block binop semantics (bsr.h:349-694)."""
    uni, pa, pb = _union_pattern(a, b)
    dt = jnp.result_type(a.data.dtype, b.data.dtype)
    da = jnp.zeros((max(len(uni), 1), a.R, a.C), dtype=dt)
    da = da.at[jnp.asarray(pa)].set(a.data[: a.nnz_blocks].astype(dt))
    db = jnp.zeros((max(len(uni), 1), a.R, a.C), dtype=dt)
    db = db.at[jnp.asarray(pb)].set(b.data[: b.nnz_blocks].astype(dt))
    return _union_bsr(a, uni, op(da, db))


@jax.tree_util.register_pytree_node_class
class BSRMatMatPlan:
    """Block-Gustavson C = A @ B with fixed block patterns.

    Host symbolic: the product-pair list (which A block meets which B
    block) and the output block pattern.  Device numeric
    (``numeric(a_data, b_data)``, jittable): one batched matmul over the
    pairs + one segment-sum — matmul realization of
    bsr_matmat_pass2's R×C×N register blocking (bsr.h:249-316).
    """

    def __init__(self, a: BSR, b: BSR):
        if a.n != b.m or a.C != b.R:
            raise ValueError(
                f"dim/block mismatch for BSR matmat: {a.shape} "
                f"({a.R}x{a.C}) @ {b.shape} ({b.R}x{b.C})")
        bra, bca = _block_pattern(a)
        ipb = np.asarray(b.indptr).astype(np.int64)
        bcb = np.asarray(b.indices)[: b.nnz_blocks].astype(np.int64)
        counts = ipb[bca + 1] - ipb[bca]
        total = int(counts.sum())
        e = np.repeat(np.arange(len(bca), dtype=np.int64), counts)
        offs = np.concatenate([[0], np.cumsum(counts)])
        bpos = ipb[bca[e]] + (np.arange(total, dtype=np.int64) - offs[e])
        keys = bra[e] * b.nb + bcb[bpos]
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        new = np.empty(total, dtype=bool)
        if total:
            new[0] = True
            new[1:] = ks[1:] != ks[:-1]
        gid = np.cumsum(new) - 1 if total else np.zeros(0, np.int64)
        uni = ks[new] if total else np.zeros(0, np.int64)
        cfg = get_config()
        self.m, self.n = a.m, b.n
        self.R, self.Q = a.R, b.C
        self.mb, self.nb = a.mb, b.nb
        self.out_nblocks = int(len(uni))
        self.indptr = jnp.asarray(
            _indptr_from(uni // b.nb, a.mb, cfg.index_dtype))
        self.indices = jnp.asarray((uni % b.nb).astype(cfg.index_dtype))
        self.pa = jnp.asarray(e[order])
        self.pb = jnp.asarray(bpos[order])
        self.gid = jnp.asarray(gid)

    def tree_flatten(self):
        return ((self.indptr, self.indices, self.pa, self.pb, self.gid),
                (self.m, self.n, self.R, self.Q, self.mb, self.nb,
                 self.out_nblocks))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        (obj.m, obj.n, obj.R, obj.Q, obj.mb, obj.nb,
         obj.out_nblocks) = aux
        obj.indptr, obj.indices, obj.pa, obj.pb, obj.gid = ch
        return obj

    def numeric(self, a_data, b_data) -> BSR:
        # HIGHEST: full-f32 block products (the GPU default may use TF32)
        with jax.default_matmul_precision("highest"):
            prod = jnp.einsum("prc,pcq->prq", a_data[self.pa],
                              b_data[self.pb])
        out = jax.ops.segment_sum(prod, self.gid,
                                  num_segments=max(self.out_nblocks, 1))
        return BSR(self.m, self.n, self.R, self.Q, self.indptr,
                   self.indices, out, nnz_blocks=self.out_nblocks)


def bsr_matmat(a: BSR, b: BSR) -> BSR:
    """Eager C = A @ B in block form (host block-symbolic + batched matmul
    numeric) — BSR stays BSR, never expanding to scalar CSC."""
    plan = BSRMatMatPlan(a, b)
    return jax.jit(plan.numeric)(a.data[: a.nnz_blocks],
                                 b.data[: b.nnz_blocks])
