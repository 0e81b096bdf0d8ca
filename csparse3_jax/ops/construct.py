"""Construction and format conversion.

The reference implements every conversion with the sequential
count → cumsum → scatter idiom (coo_to_csc at src/CSparse3/csc_numba.py:331-357,
csc_transpose at csc_numba.py:400-436, csr_tocsc at src/sparsetools/csr.h:418-461).
On the device those become data-parallel primitives:

  count   -> jnp.bincount (segment histogram)
  cumsum  -> jnp.cumsum
  scatter -> stable sort by destination key

Sorting uses a *stable double argsort* (sort by minor key, then stable sort
by major key) instead of a fused ``col*m + row`` integer key so that no
int64 arithmetic is required for >46k-dimensional matrices when x64 is off.

Host/device split (SURVEY §7 design stance: "symbolic passes compute
exact sizes on host"): ops whose OUTPUT SIZE is data-dependent
(from_triplets dedup, canonicalize) are host-eager and run entirely in
numpy — they cannot be jitted anyway (the resulting nnz becomes static
pytree metadata), and running them as device programs would cost one
host-device round trip per step.  Fixed-size conversions (transpose,
csc<->csr) take the numpy path when called eagerly on concrete arrays and
the XLA path when traced, so they stay usable inside jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import get_config
from ..types import BSR, COO, CSC, CSR

__all__ = [
    "expand_indptr",
    "compress_indptr",
    "coo_to_csc",
    "csc_to_csr",
    "csr_to_csc",
    "csc_to_coo",
    "transpose",
    "csc_to_dense",
    "coo_to_dense",
    "dense_to_csc",
    "csc_to_bsr",
    "bsr_to_dense",
    "canonicalize",
    "eye",
    "diag",
    "diags",
    "from_triplets",
    "random_csc",
    "real_equivalent",
    "csc_to_dia",
    "dia_to_csc",
    "csc_to_bcoo",
    "bcoo_to_csc",
]


def is_traced(*arrays) -> bool:
    """True if any argument is a jax tracer (we're under jit/vmap/grad)."""
    return any(isinstance(x, jax.core.Tracer) for x in arrays)


def container_traced(a) -> bool:
    """``is_traced`` over a container's RAW fields.

    Never goes through the lazy-upload properties (``a.indptr`` etc.):
    property access device_puts host fields, which is a wasted full-matrix
    upload on host-only flows.
    """
    raw = (getattr(a, f) for f in ("_indptr", "_indices", "_data",
                                   "_rows", "_cols")
           if hasattr(a, f))
    return any(isinstance(x, jax.core.Tracer) for x in raw)


def expand_indptr_np(indptr, nnz: int | None = None):
    """Host twin of expand_indptr: indptr -> per-entry segment ids."""
    indptr = np.asarray(indptr)
    n = indptr.shape[0] - 1
    reps = np.diff(indptr)
    out = np.repeat(np.arange(n, dtype=indptr.dtype), reps)
    return out if nnz is None else out[:nnz]


def expand_indptr(indptr, nnz: int):
    """indptr -> per-entry segment id (reference: csr.h:84 ``expandptr``).

    For entry k, its segment is the number of segment boundaries <= k.
    """
    if nnz == 0:
        return jnp.zeros((0,), dtype=indptr.dtype)
    k = jnp.arange(nnz, dtype=indptr.dtype)
    return (jnp.searchsorted(indptr, k, side="right") - 1).astype(indptr.dtype)


def compress_indptr(seg_ids, nseg: int, nnz: int | None = None):
    """Sorted per-entry segment ids -> indptr of length nseg+1."""
    idx_dtype = get_config().index_dtype
    counts = jnp.bincount(seg_ids, length=nseg)
    indptr = jnp.concatenate(
        [jnp.zeros((1,), dtype=counts.dtype), jnp.cumsum(counts)]
    )
    return indptr.astype(idx_dtype)


def _stable_sort_by(major, minor, *payloads):
    """Sort payloads by (major, minor) using two stable argsorts."""
    p1 = jnp.argsort(minor, stable=True)
    major = major[p1]
    p2 = jnp.argsort(major, stable=True)
    perm = p1[p2]
    return (major[p2],) + tuple(p[perm] for p in payloads)


def from_triplets(rows, cols, vals, shape, *, sum_duplicates=True) -> CSC:
    """Build a canonical CSC from COO triplets
    (reference: coo_to_csc, src/CSparse3/csc_numba.py:331-357 — which keeps
    duplicates; here duplicates are summed by default, scipy-style, which is
    what Ybus assembly needs).

    Host-eager: the output nnz is data-dependent (static pytree metadata),
    so the build runs in numpy and uploads the final arrays once.
    """
    m, n = shape
    cfg = get_config()
    np_idx = np.dtype(cfg.index_dtype)
    rows = np.asarray(rows).astype(np_idx, copy=False)
    cols = np.asarray(cols).astype(np_idx, copy=False)
    vals = np.asarray(vals)
    if rows.shape[0] == 0:
        return _empty_csc(m, n, vals.dtype)
    # fused int64 key + stable argsort: numpy's stable integer sort is
    # radix — ~40x faster than np.lexsort at 1M entries
    fused = cols.astype(np.int64) * m + rows
    order = np.argsort(fused, kind="stable")  # by col (major), then row
    r_s, c_s, v_s = rows[order], cols[order], vals[order]
    nnz = r_s.shape[0]
    new = np.empty(nnz, dtype=bool)
    new[0] = True
    new[1:] = (c_s[1:] != c_s[:-1]) | (r_s[1:] != r_s[:-1])
    if sum_duplicates:
        gid = np.cumsum(new) - 1
        k = int(gid[-1]) + 1
        r_u, c_u = r_s[new], c_s[new]
        v_u = np.zeros(k, dtype=v_s.dtype)
        np.add.at(v_u, gid, v_s)
        canonical = True
    else:
        r_u, c_u, v_u = r_s, c_s, v_s
        # sorted, but canonical also means duplicate-free
        canonical = bool(new.all())
    indptr = np.zeros(n + 1, dtype=np_idx)
    counts = np.bincount(c_u, minlength=n)
    indptr[1:] = np.cumsum(counts)
    # pass numpy straight through: the CSC constructor keeps a host cache
    # (types._host_cache) so later host-symbolic ops skip the download
    return CSC(m, n, indptr, np.ascontiguousarray(r_u),
               np.ascontiguousarray(v_u), canonical=canonical)


def coo_to_csc(coo: COO, sum_duplicates: bool = True) -> CSC:
    k = coo.nnz
    return from_triplets(
        coo.rows[:k], coo.cols[:k], coo.data[:k], coo.shape,
        sum_duplicates=sum_duplicates,
    )


def _empty_csc(m, n, dtype) -> CSC:
    idx = np.dtype(get_config().index_dtype)
    return CSC(
        m,
        n,
        np.zeros(n + 1, dtype=idx),
        np.zeros(0, dtype=idx),
        np.zeros(0, dtype=dtype),
    )


def csc_to_coo(a: CSC) -> COO:
    k = a.nnz
    cols = expand_indptr(a.indptr, k)
    return COO(a.m, a.n, a.indices[:k], cols, a.data[:k])


def _resort_np(n_major, major, minor, vals, idx_dtype):
    """Host re-sort of entry streams by (major, minor); returns
    (indptr over major, minor_sorted, vals_sorted)."""
    nm = minor.max() + 1 if minor.size else 1
    order = np.argsort(major.astype(np.int64) * nm + minor, kind="stable")
    mj, mn, vv = major[order], minor[order], vals[order]
    indptr = np.zeros(n_major + 1, dtype=idx_dtype)
    indptr[1:] = np.cumsum(np.bincount(mj, minlength=n_major))
    return indptr, mn.astype(idx_dtype, copy=False), vv


def csc_to_csr(a: CSC) -> CSR:
    """CSC -> CSR re-sort (reference: csc_to_csr, csc_numba.py:360-397)."""
    k = a.nnz
    if not container_traced(a):
        ip, rows, vals = a.np_arrays()
        cols = expand_indptr_np(ip)
        indptr, c_s, v_s = _resort_np(
            a.m, rows.astype(np.int64), cols.astype(np.int64), vals,
            np.dtype(get_config().index_dtype),
        )
        return CSR(a.m, a.n, indptr, np.ascontiguousarray(c_s),
                   np.ascontiguousarray(v_s), canonical=a.canonical)
    cols = expand_indptr(a.indptr, k)
    rows = a.indices[:k]
    vals = a.data[:k]
    r_s, c_s, v_s = _stable_sort_by(rows, cols, cols, vals)
    indptr = compress_indptr(r_s, a.m)
    return CSR(a.m, a.n, indptr, c_s, v_s, canonical=a.canonical)


def csr_to_csc(a: CSR) -> CSC:
    k = a.nnz
    if not container_traced(a):
        ip, cols, vals = a.np_arrays()
        rows = expand_indptr_np(ip)
        indptr, r_s, v_s = _resort_np(
            a.n, cols.astype(np.int64), rows.astype(np.int64), vals,
            np.dtype(get_config().index_dtype),
        )
        return CSC(a.m, a.n, indptr, np.ascontiguousarray(r_s),
                   np.ascontiguousarray(v_s), canonical=a.canonical)
    rows = expand_indptr(a.indptr, k)
    cols = a.indices[:k]
    vals = a.data[:k]
    c_s, r_s, v_s = _stable_sort_by(cols, rows, rows, vals)
    indptr = compress_indptr(c_s, a.n)
    return CSC(a.m, a.n, indptr, r_s, v_s, canonical=a.canonical)


def transpose(a: CSC) -> CSC:
    """A^T (reference: csc_transpose, csc_numba.py:400-436).

    The transpose of CSC(m,n) viewed column-wise is exactly a CSR(m,n)
    re-sort with roles swapped, i.e. one stable sort by old row index.
    """
    k = a.nnz
    if not container_traced(a):
        ip, old_rows, vals = a.np_arrays()
        idx = np.dtype(get_config().index_dtype)
        if np.issubdtype(vals.dtype, np.floating) or np.issubdtype(
                vals.dtype, np.complexfloating):
            try:
                from ..native import host_ext

                Tp, Ti, Tx = host_ext.csc_transpose(a.m, a.n, ip, old_rows, vals)
                return CSC(a.n, a.m, Tp.astype(idx, copy=False), Ti.astype(idx, copy=False),
                           Tx.astype(vals.dtype, copy=False),
                           canonical=a.canonical)
            except ImportError:
                pass
        old_cols = expand_indptr_np(ip)
        indptr, r_s, v_s = _resort_np(
            a.m, old_rows.astype(np.int64), old_cols.astype(np.int64),
            vals, idx,
        )
        return CSC(a.n, a.m, indptr, np.ascontiguousarray(r_s),
                   np.ascontiguousarray(v_s), canonical=a.canonical)
    old_cols = expand_indptr(a.indptr, k)
    old_rows = a.indices[:k]
    vals = a.data[:k]
    # new matrix: shape (n, m); new col = old row, new row = old col
    c_s, r_s, v_s = _stable_sort_by(old_rows, old_cols, old_cols, vals)
    indptr = compress_indptr(c_s, a.m)
    return CSC(a.n, a.m, indptr, r_s, v_s, canonical=a.canonical)


def real_equivalent(a: CSC, interleave: bool = True) -> CSC:
    """Split-complex real doubling of a complex matrix.

    Maps the complex n-system ``A z = c`` to the real 2n-system over
    variables (re z0, im z0, re z1, im z1, ...): each complex entry
    a_ij = p + iq stamps the 2x2 real block [[p, -q], [q, p]] at
    (2i, 2j).  INTERLEAVED ordering preserves bandedness — bandwidth
    bw maps to 2 bw + 1 — which is what lets a complex Ybus ride the
    banded/SPIKE direct solvers, which factor real systems.
    ``interleave=False`` uses the [[Re, -Im], [Im, Re]] block
    layout (variables (re z, im z) stacked) instead.

    Real input passes through unchanged.  Reference analogue: the
    complex arithmetic wrappers of complex_ops.h (the reference makes
    complex first-class in its kernel matrix; here the equivalent is
    this real embedding).
    """
    ip, ix, dt = a.np_arrays()
    dt = np.asarray(dt)
    if not np.iscomplexobj(dt):
        return a
    rows = np.asarray(ix, dtype=np.int64)
    cols = np.repeat(np.arange(a.n, dtype=np.int64),
                     np.diff(np.asarray(ip)))
    p, q = np.ascontiguousarray(dt.real), np.ascontiguousarray(dt.imag)
    if interleave:
        r2 = np.concatenate([2 * rows, 2 * rows, 2 * rows + 1,
                             2 * rows + 1])
        c2 = np.concatenate([2 * cols, 2 * cols + 1, 2 * cols,
                             2 * cols + 1])
    else:
        m = a.m
        n = a.n
        r2 = np.concatenate([rows, rows, rows + m, rows + m])
        c2 = np.concatenate([cols, cols + n, cols, cols + n])
    v2 = np.concatenate([p, -q, q, p])
    return from_triplets(r2, c2, v2, (2 * a.m, 2 * a.n))


def complex_rhs_to_real(b, perm):
    """Host-side inbound marshalling for the split-complex interleaved
    embedding (``real_equivalent``): apply the complex-level ordering
    and interleave re/im into a real (2n, B) array.  Returns
    (b2, squeeze) — pair with ``real_x_to_complex``.  Shared by the
    three complex-capable banded solvers."""
    b = np.asarray(b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    bp = b[perm]
    b2 = np.empty((2 * b.shape[0], b.shape[1]),
                  dtype=np.float64 if b.real.dtype == np.float64
                  else np.float32)
    b2[0::2] = bp.real
    b2[1::2] = bp.imag
    return b2, squeeze


def real_x_to_complex(x2, perm, squeeze):
    """Outbound half of ``complex_rhs_to_real``."""
    x2 = np.asarray(x2)
    xp = x2[0::2] + 1j * x2[1::2]
    x = np.empty_like(xp)
    x[perm] = xp
    return x[:, 0] if squeeze else x


def complex_embed_block_size(s):
    """Block-size mapping for the interleaved embedding: bandwidth maps
    bw -> 2*bw + 1, so a block size that was legal for the complex
    system (s >= bw) must map to >= 2*s + 1; +8 keeps lane-multiple
    sizes lane-multiple."""
    return None if s is None else 2 * s + 8


def canonicalize(a: CSC, *, sum_duplicates=True) -> CSC:
    """Sort rows within columns + merge duplicates
    (reference: csr_sort_indices csr.h:358 + csr_sum_duplicates csr.h:1030)."""
    coo = csc_to_coo(a)
    return coo_to_csc(coo, sum_duplicates=sum_duplicates)


def csc_to_dense(a: CSC):
    k = a.nnz
    cols = expand_indptr(a.indptr, k)
    dt = a.data.dtype
    if dt == jnp.bool_:
        # XLA scatter-add rejects bool; scatter-MAX in uint8 gives OR
        # semantics that survive any number of duplicate entries (add
        # would wrap 256 duplicate Trues back to False)
        out = jnp.zeros((a.m, a.n), dtype=jnp.uint8)
        return out.at[a.indices[:k], cols].max(
            a.data[:k].astype(jnp.uint8)).astype(jnp.bool_)
    out = jnp.zeros((a.m, a.n), dtype=dt)
    return out.at[a.indices[:k], cols].add(a.data[:k])


def coo_to_dense(a: COO):
    k = a.nnz
    dt = a.data.dtype
    if dt == jnp.bool_:
        # scatter-max = duplicate-safe OR (see csc_to_dense)
        out = jnp.zeros((a.m, a.n), dtype=jnp.uint8)
        return out.at[a.rows[:k], a.cols[:k]].max(
            a.data[:k].astype(jnp.uint8)).astype(jnp.bool_)
    out = jnp.zeros((a.m, a.n), dtype=dt)
    return out.at[a.rows[:k], a.cols[:k]].add(a.data[:k])


def dense_to_csc(arr) -> CSC:
    arr_np = np.asarray(arr)
    rows, cols = np.nonzero(arr_np)
    return from_triplets(rows, cols, arr_np[rows, cols], arr_np.shape)


def csc_to_bsr(a: CSC, block=None) -> BSR:
    """Pack into matmul-sized dense blocks (reference blueprint:
    csr_count_blocks csr.h:157, csr_tobsr csr.h:204)."""
    cfg = get_config()
    R, C = block if block is not None else cfg.bsr_block
    ip, rows, vals = a.np_arrays()
    cols = np.repeat(np.arange(a.n), np.diff(ip))
    br, bc = rows // R, cols // C
    mb, nb = -(-a.m // R), -(-a.n // C)
    key = br.astype(np.int64) * nb + bc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, inv_start = np.unique(key_s, return_index=True)
    nblocks = uniq.shape[0]
    block_of_entry = np.searchsorted(uniq, key)
    data = np.zeros((max(nblocks, 1), R, C), dtype=vals.dtype)
    data[block_of_entry, rows % R, cols % C] += vals
    ubr, ubc = (uniq // nb).astype(cfg.index_dtype), (uniq % nb).astype(cfg.index_dtype)
    indptr = np.zeros(mb + 1, dtype=cfg.index_dtype)
    np.add.at(indptr, ubr + 1, 1)
    indptr = np.cumsum(indptr).astype(cfg.index_dtype)
    return BSR(a.m, a.n, R, C, jnp.asarray(indptr), jnp.asarray(ubc),
               jnp.asarray(data), nnz_blocks=nblocks)


def bsr_to_dense(a: BSR):
    mb, nb, R, C = a.mb, a.nb, a.R, a.C
    out = jnp.zeros((mb * R, nb * C), dtype=a.data.dtype)
    ip = np.asarray(a.indptr)
    brs = np.repeat(np.arange(mb), np.diff(ip))
    bcs = np.asarray(a.indices)[: a.nnz_blocks]
    for k in range(a.nnz_blocks):
        r0, c0 = int(brs[k]) * R, int(bcs[k]) * C
        out = out.at[r0 : r0 + R, c0 : c0 + C].add(a.data[k])
    return out[: a.m, : a.n]


def eye(n, dtype=None, k: int = 0) -> CSC:
    cfg = get_config()
    dtype = dtype or cfg.value_dtype
    if k >= 0:
        rows = np.arange(0, n - k)
        cols = rows + k
    else:
        cols = np.arange(0, n + k)
        rows = cols - k
    return from_triplets(rows, cols, np.ones(len(rows), dtype=dtype), (n, n))


def diag(m, n, value) -> CSC:
    """m x n matrix with ``value`` on the main diagonal
    (reference: Diag, csc.py:556-569)."""
    cfg = get_config()
    d = min(m, n)
    idx = np.arange(d)
    vals = np.full(d, value, dtype=cfg.value_dtype)
    return from_triplets(idx, idx, vals, (m, n))


def diags(array) -> CSC:
    """Square diagonal matrix from a vector (reference: Diags, csc.py:572-585).

    Host values stay on host: ``from_triplets`` is host-eager, so a
    device round-trip would be wasted work."""
    if is_traced(array):
        array = jnp.asarray(array)
    else:
        array = np.asarray(array)
    d = array.shape[0]
    idx = np.arange(d)
    return from_triplets(idx, idx, array, (d, d))


def random_csc(m, n, density=0.01, seed=0, dtype=None) -> CSC:
    """Random test matrix (the reference tests use scipy.sparse.random with
    seed 0, test1_operations.py:13-18 — this is the in-package equivalent)."""
    cfg = get_config()
    dtype = dtype or cfg.value_dtype
    rng = np.random.default_rng(seed)
    k = int(m * n * density)
    rows = rng.integers(0, m, size=k)
    cols = rng.integers(0, n, size=k)
    vals = rng.standard_normal(k).astype(dtype)
    return from_triplets(rows, cols, vals, (m, n))


def csc_to_dia(a: CSC):
    """CSC -> DIA (host; the diagonal count is data-dependent)."""
    from ..types import DIA

    ip, rows, vals = a.np_arrays()
    cols = expand_indptr_np(ip).astype(np.int64)
    offs_all = cols - rows.astype(np.int64)
    offsets = np.unique(offs_all)
    data = np.zeros((len(offsets), a.n), dtype=vals.dtype)
    di = np.searchsorted(offsets, offs_all)
    data[di, cols] = vals
    return DIA(a.m, a.n, offsets.astype(np.int32), data)


def dia_to_csc(a) -> CSC:
    """DIA -> CSC (host)."""
    offs, dat = a.np_arrays()
    rows_l, cols_l, vals_l = [], [], []
    for i, off in enumerate(offs):
        off = int(off)
        j_lo, j_hi = max(0, off), min(a.n, a.m + off)
        if j_hi <= j_lo:
            continue
        j = np.arange(j_lo, j_hi)
        v = dat[i, j_lo:j_hi]
        nz = v != 0
        rows_l.append(j[nz] - off)
        cols_l.append(j[nz])
        vals_l.append(v[nz])
    if not rows_l:
        return _empty_csc(a.m, a.n, dat.dtype)
    return from_triplets(
        np.concatenate(rows_l), np.concatenate(cols_l),
        np.concatenate(vals_l), (a.m, a.n),
    )


def csc_to_bcoo(a: CSC):
    """CSC -> ``jax.experimental.sparse.BCOO`` (ecosystem interop).

    The BCOO carries (nnz, 2) [row, col] indices; ours are column-major
    sorted, so ``indices_sorted`` (a row-major property) stays False.
    """
    from jax.experimental import sparse as jsparse

    ip, rows, vals = a.np_arrays()
    cols = expand_indptr_np(ip)
    idx = np.stack([rows.astype(np.int32), cols.astype(np.int32)], axis=1)
    return jsparse.BCOO(
        (jnp.asarray(vals), jnp.asarray(idx)),
        shape=a.shape,
        indices_sorted=False,
        unique_indices=bool(a.canonical),
    )


def bcoo_to_csc(b) -> CSC:
    """``jax.experimental.sparse.BCOO`` (2-D, unbatched) -> CSC."""
    if b.ndim != 2 or b.n_batch or b.n_dense:
        raise ValueError("only plain 2-D element-sparse BCOO is supported")
    idx = np.asarray(b.indices)
    dat = np.asarray(b.data)
    # BCOO pads with out-of-range or duplicate rows beyond actual nse in
    # some transforms; from_triplets canonicalizes and sums duplicates,
    # matching BCOO's duplicate semantics.
    m, n = b.shape
    live = ((idx >= 0).all(axis=1) & (idx[:, 0] < m) & (idx[:, 1] < n))
    return from_triplets(idx[live, 0], idx[live, 1], dat[live], (m, n))
