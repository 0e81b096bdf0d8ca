"""Elementwise sparse arithmetic.

The reference implements binary ops as a sequential 2-pointer merge over
sorted index streams (csr_binop_csr_canonical, src/sparsetools/csr.h:783-889,
dispatched from CscMat.__add__/__sub__ at src/CSparse3/csc.py:301-346; the
in-package alternative is the scatter-based csc_add_ff at
src/CSparse3/csc_numba.py:183-219).

On the device a merge is a sort: the union pattern is ``sort(concat(keys_a,
keys_b))`` + duplicate collapse, and value lookup on a pattern is a
vectorized ``searchsorted``.  Both are single XLA ops that vectorize over
the whole nnz stream instead of walking columns one entry at a time.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_config
from ..types import CSC
from . import construct

__all__ = [
    "add",
    "sub",
    "axpby",
    "scale",
    "elmul",
    "eldiv",
    "maximum",
    "minimum",
    "compare",
    "equal",
    "eliminate_zeros",
    "scale_rows",
    "scale_columns",
]


def _check_shapes(a: CSC, b: CSC):
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")


def _keys_np(a: CSC):
    """Per-entry fused int64 key: col * m + row (ascending when canonical).
    Host-side; int64 always (the reference's overflow guard csr.h:591-596
    concerns int32 — host merges just use the wider type)."""
    ip, rows, _ = a.np_arrays()
    cols = construct.expand_indptr_np(ip).astype(np.int64)
    return cols * a.m + rows.astype(np.int64)


def axpby(alpha, a: CSC, beta, b: CSC) -> CSC:
    """alpha*A + beta*B with exact union pattern
    (reference: csc_add_ff semantics, csc_numba.py:183-219).  Host-eager
    (output nnz is data-dependent).  Canonical float/complex operands route
    to the native 2-pointer column merge (csr_binop_csr_canonical twin)."""
    _check_shapes(a, b)
    ipa, rowsa, va = a.np_arrays()
    ipb, rowsb, vb = b.np_arrays()
    res_dt = np.result_type(va, vb, np.asarray(alpha), np.asarray(beta))
    if (a.canonical and b.canonical
            and np.issubdtype(res_dt, np.inexact)):
        try:
            from ..native import host_ext

            Cp, Ci, Cx = host_ext.csc_axpby(
                a.n, ipa, rowsa, va, alpha, ipb, rowsb, vb, beta,
                res_dt=res_dt)
            idx = np.dtype(get_config().index_dtype)
            return CSC(a.m, a.n, Cp.astype(idx, copy=False), Ci.astype(idx, copy=False),
                       Cx.astype(res_dt, copy=False), canonical=True)
        except ImportError:
            pass
    rows = np.concatenate([rowsa, rowsb])
    cols = np.concatenate(
        [construct.expand_indptr_np(ipa), construct.expand_indptr_np(ipb)]
    )
    dtype = np.result_type(va.dtype, vb.dtype)
    vals = np.concatenate(
        [np.asarray(alpha, dtype) * va, np.asarray(beta, dtype) * vb]
    )
    return construct.from_triplets(rows, cols, vals, a.shape)


def add(a: CSC, b: CSC) -> CSC:
    return axpby(1, a, 1, b)


def sub(a: CSC, b: CSC) -> CSC:
    return axpby(1, a, -1, b)


def scale(a: CSC, alpha) -> CSC:
    return CSC(
        a.m, a.n, a.indptr, a.indices, a.data * alpha,
        nnz=a.nnz, canonical=a.canonical,
    )


def _lookup_np(keys_sorted, data, query_keys):
    """Value of each query key in a sorted (keys, data) stream, 0 if absent."""
    if keys_sorted.shape[0] == 0:
        return (
            np.zeros(query_keys.shape, dtype=data.dtype),
            np.zeros(query_keys.shape, dtype=bool),
        )
    pos = np.searchsorted(keys_sorted, query_keys)
    pos_c = np.clip(pos, 0, keys_sorted.shape[0] - 1)
    hit = keys_sorted[pos_c] == query_keys
    return np.where(hit, data[pos_c], data.dtype.type(0)), hit


def _union_binop(a: CSC, b: CSC, op: Callable, drop_zeros: bool) -> CSC:
    """Generic union-pattern binop (reference: csr_binop_csr, csr.h:891).
    Host-eager merge of sorted key streams."""
    _check_shapes(a, b)
    a = a if a.canonical else construct.canonicalize(a)
    b = b if b.canonical else construct.canonicalize(b)
    keys_a, keys_b = _keys_np(a), _keys_np(b)
    ukeys = np.union1d(keys_a, keys_b)
    va, _ = _lookup_np(keys_a, a.np_arrays()[2], ukeys)
    vb, _ = _lookup_np(keys_b, b.np_arrays()[2], ukeys)
    vals = op(va, vb)
    idx = np.dtype(get_config().index_dtype)
    rows = (ukeys % a.m).astype(idx)
    cols = (ukeys // a.m).astype(idx)
    out = construct.from_triplets(rows, cols, vals, a.shape)
    return eliminate_zeros(out) if drop_zeros else out


def _intersect_binop(a: CSC, b: CSC, op: Callable) -> CSC:
    """Intersection-pattern binop (elmul/eldiv,
    reference: csr_elmul_csr / csr_eldiv_csr, csr.h:957-974)."""
    _check_shapes(a, b)
    a = a if a.canonical else construct.canonicalize(a)
    b = b if b.canonical else construct.canonicalize(b)
    keys_a, keys_b = _keys_np(a), _keys_np(b)
    ipb, rowsb, vb = b.np_arrays()
    va, hit = _lookup_np(keys_a, a.np_arrays()[2], keys_b)
    vals = op(va, vb)
    keep = np.flatnonzero(hit)
    rows = rowsb[keep]
    cols = construct.expand_indptr_np(ipb)[keep]
    return construct.from_triplets(rows, cols, vals[keep], a.shape)


def elmul(a: CSC, b: CSC) -> CSC:
    return _intersect_binop(a, b, np.multiply)


def eldiv(a: CSC, b: CSC) -> CSC:
    return _intersect_binop(a, b, np.divide)


def maximum(a: CSC, b: CSC) -> CSC:
    return _union_binop(a, b, np.maximum, drop_zeros=False)


def minimum(a: CSC, b: CSC) -> CSC:
    return _union_binop(a, b, np.minimum, drop_zeros=False)


_CMP = {
    "ne": lambda x, y: (x != y),
    "lt": lambda x, y: (x < y),
    "gt": lambda x, y: (x > y),
    "le": lambda x, y: (x <= y),
    "ge": lambda x, y: (x >= y),
}


def compare(a: CSC, b: CSC, op: str) -> CSC:
    """Sparse comparison with nonzero-result pattern and BOOL data
    (reference: csr_ne_csr .. csr_ge_csr, csr.h:912-956, instantiated
    with bool output via INSTANTIATE_BOOL_OUT, sparsetools.i:214).  Note
    le/ge/eq over the implicit-zero region is dense by definition; like
    scipy we only materialize results on the union pattern."""
    if op not in _CMP:
        raise ValueError(f"unknown comparison {op!r}")
    return _union_binop(a, b, _CMP[op], drop_zeros=True)


def equal(a: CSC, b: CSC) -> bool:
    """Exact structural + value equality (reference: CscMat.__eq__,
    csc.py:432-457 — prints which field differs and returns bool)."""
    if a.shape != b.shape:
        print(f"shapes differ: {a.shape} vs {b.shape}")
        return False
    a = a if a.canonical else construct.canonicalize(a)
    b = b if b.canonical else construct.canonicalize(b)
    if a.nnz != b.nnz:
        print(f"nnz differ: {a.nnz} vs {b.nnz}")
        return False
    ipa, ixa, da = a.np_arrays()
    ipb, ixb, db = b.np_arrays()
    if not np.array_equal(ipa, ipb):
        print("indptr differ")
        return False
    if not np.array_equal(ixa, ixb):
        print("indices differ")
        return False
    if not np.array_equal(da, db):
        print("data differ")
        return False
    return True


def eliminate_zeros(a: CSC) -> CSC:
    """Drop explicit zeros (reference: csr_eliminate_zeros, csr.h:1073)."""
    ip, rows, vals = a.np_arrays()
    keep = np.flatnonzero(vals != 0)
    cols = np.repeat(np.arange(a.n), np.diff(ip))
    return construct.from_triplets(rows[keep], cols[keep], vals[keep], a.shape)


def scale_rows(a: CSC, d) -> CSC:
    """Row scaling diag(d) @ A (reference: csr_scale_rows, csr.h:103).
    Jittable: the pattern is unchanged, values gather d by row id."""
    d = jnp.asarray(d)
    k = a.nnz
    data = a.data.at[:k].multiply(d[a.indices[:k]])
    return CSC(a.m, a.n, a.indptr, a.indices, data, nnz=a.nnz,
               canonical=a.canonical)


def scale_columns(a: CSC, d) -> CSC:
    """Column scaling A @ diag(d) (reference: csr_scale_columns, csr.h:125)."""
    d = jnp.asarray(d)
    k = a.nnz
    if construct.container_traced(a) or construct.is_traced(d):
        cols = construct.expand_indptr(a.indptr, k)
    else:
        cols = jnp.asarray(construct.expand_indptr_np(np.asarray(a.indptr), k))
    data = a.data.at[:k].multiply(d[cols])
    return CSC(a.m, a.n, a.indptr, a.indices, data, nnz=a.nnz,
               canonical=a.canonical)
