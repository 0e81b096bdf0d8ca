"""Core sparse containers (pytrees).

Design (SURVEY.md §7 "Design stance"):

* **Static shapes everywhere.**  Every container's arrays have a static
  *capacity*; the logical ``nnz`` is static Python metadata (part of the
  pytree aux data), so jitted functions re-trace when the sparsity pattern
  size changes but never see dynamic shapes.  Entries past ``nnz`` are
  *padding*: row index == m (column index == n) and value 0, so they sort to
  the end and contribute nothing to segment reductions.

* **CSC is the public interchange format** — fields m, n, indptr(int32),
  indices(int32), data — byte-compatible with the reference layout
  (reference: src/CSparse3/csc.py:95-138) so test vectors exchange directly
  with scipy.  BSR with matmul-sized blocks is the internal compute format.

Containers are registered pytrees: they pass transparently through jit /
shard_map / vmap, with (shape, nnz, flags) as static aux data.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import get_config

__all__ = ["CSC", "CSR", "COO", "BSR", "DIA", "Dense"]

Dense = Any  # alias for plain (m, n) arrays in signatures


def _asarray(x, dtype=None):
    return jnp.asarray(x, dtype=dtype)


def _lazy(obj, field):
    """Convert a container field to a device array on first access and
    cache it; host-only lifecycles never upload."""
    v = getattr(obj, field)
    if not isinstance(v, jax.Array):
        v = _asarray(v)
        setattr(obj, field, v)
    return v


def _host_cache(*arrays):
    """Keep host copies when a container is constructed from host data, so
    ``np_arrays`` (the gateway to every host-symbolic op) never pays a
    device->host transfer.  Only populated for genuine numpy inputs; device
    arrays and tracers return None (np_arrays falls back to a download)."""
    if all(isinstance(a, np.ndarray) for a in arrays):
        return tuple(arrays)
    return None


class _SparseBase:
    """Shared plumbing for 2-D sparse containers."""

    m: int
    n: int
    nnz: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def capacity(self) -> int:
        return int(np.shape(getattr(self, "_data", None)
                            if hasattr(self, "_data") else self.data)[0])

    # -- numpy views (host) ------------------------------------------------
    def np_arrays(self):
        """Host numpy copies of the structure arrays, trimmed to nnz."""
        raise NotImplementedError

    def block_until_ready(self):
        jax.block_until_ready(self.data)
        return self


@jax.tree_util.register_pytree_node_class
class CSC(_SparseBase):
    """Compressed sparse column matrix.

    Layout matches the reference (src/CSparse3/csc.py:52-87): for column j,
    entries live at positions indptr[j]..indptr[j+1] of (indices=row ids,
    data=values).  ``canonical`` means rows sorted within each column and no
    duplicates (reference: src/sparsetools/csr.h:325 csr_has_canonical_format).
    """

    def __init__(self, m, n, indptr, indices, data, nnz=None, canonical=True):
        self.m = int(m)
        self.n = int(n)
        self._np = _host_cache(indptr, indices, data)
        # device conversion is LAZY (see _lazy): host-only intermediates
        # (builders, symbolic phases) never pay an upload
        self._indptr = indptr
        self._indices = indices
        self._data = data
        self.nnz = int(nnz) if nnz is not None else int(np.shape(indices)[0])
        self.canonical = bool(canonical)

    indptr = property(lambda self: _lazy(self, "_indptr"))
    indices = property(lambda self: _lazy(self, "_indices"))
    data = property(lambda self: _lazy(self, "_data"))

    # pytree protocol
    def tree_flatten(self):
        return (self.indptr, self.indices, self.data), (
            self.m,
            self.n,
            self.nnz,
            self.canonical,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        m, n, nnz, canonical = aux
        indptr, indices, data = children
        obj = object.__new__(cls)
        obj.m, obj.n, obj.nnz, obj.canonical = m, n, nnz, canonical
        obj._indptr, obj._indices, obj._data = indptr, indices, data
        obj._np = None
        return obj

    def __repr__(self):
        return (
            f"CSC(m={self.m}, n={self.n}, nnz={self.nnz}, "
            f"cap={self.capacity}, dtype={self.data.dtype})"
        )

    def np_arrays(self):
        k = self.nnz
        if self._np is not None:
            ip, ix, dt = self._np
            return ip, ix[:k], dt[:k]
        return (
            np.asarray(self.indptr),
            np.asarray(self.indices)[:k],
            np.asarray(self.data)[:k],
        )

    # -- conversions (lazy imports avoid cycles) ---------------------------
    def todense(self):
        from .ops import construct

        return construct.csc_to_dense(self)

    def to_csr(self) -> "CSR":
        from .ops import construct

        return construct.csc_to_csr(self)

    def to_coo(self) -> "COO":
        from .ops import construct

        return construct.csc_to_coo(self)

    def to_bsr(self, block=None) -> "BSR":
        from .ops import construct

        return construct.csc_to_bsr(self, block=block)

    def to_scipy(self):
        import scipy.sparse as sp

        ip, ix, dt = self.np_arrays()
        return sp.csc_matrix((dt, ix, ip), shape=self.shape)

    def to_bcoo(self):
        """Convert to ``jax.experimental.sparse.BCOO`` (ecosystem interop)."""
        from .ops import construct

        return construct.csc_to_bcoo(self)

    @classmethod
    def from_bcoo(cls, b) -> "CSC":
        """Adopt a 2-D ``jax.experimental.sparse.BCOO``."""
        from .ops import construct

        return construct.bcoo_to_csc(b)

    @classmethod
    def from_scipy(cls, a) -> "CSC":
        """Zero-copy adoption of a scipy CSC (reference: csc.py:541-553)."""
        a = a.tocsc()
        return cls(a.shape[0], a.shape[1], a.indptr, a.indices, a.data)

    @classmethod
    def from_dense(cls, arr) -> "CSC":
        from .ops import construct

        return construct.dense_to_csc(arr)

    def copy(self) -> "CSC":
        return CSC(
            self.m,
            self.n,
            self.indptr,
            self.indices,
            self.data,
            nnz=self.nnz,
            canonical=self.canonical,
        )

    def astype(self, dtype) -> "CSC":
        return CSC(
            self.m,
            self.n,
            self.indptr,
            self.indices,
            self.data.astype(dtype),
            nnz=self.nnz,
            canonical=self.canonical,
        )

    # -- operator API (parity with reference CscMat, csc.py:44-538) --------
    def __add__(self, other):
        from .ops import arithmetic

        return arithmetic.add(self, other)

    def __sub__(self, other):
        from .ops import arithmetic

        return arithmetic.sub(self, other)

    def __neg__(self):
        from .ops import arithmetic

        return arithmetic.scale(self, -1)

    def __mul__(self, other):
        """Polymorphic like the reference (csc.py:348-420): CSC·CSC SpGEMM,
        CSC·vec SpMV, CSC·dense SpMM, CSC·scalar scale."""
        from .ops import arithmetic, matvec, spgemm

        if isinstance(other, CSC):
            return spgemm.spgemm(self, other)
        other_arr = jnp.asarray(other)
        if other_arr.ndim == 0:
            return arithmetic.scale(self, other_arr)
        if other_arr.ndim == 1:
            return matvec.spmv(self, other_arr)
        return matvec.spmm(self, other_arr)

    def __rmul__(self, other):
        from .ops import arithmetic

        other_arr = jnp.asarray(other)
        if other_arr.ndim == 0:
            return arithmetic.scale(self, other_arr)
        return NotImplemented

    def __matmul__(self, other):
        return self.__mul__(other)

    def dot(self, other):
        """General SpGEMM (reference: csc.py:483-500 ``dot``)."""
        from .ops import spgemm

        return spgemm.spgemm(self, other)

    def __eq__(self, other):  # exact compare, reference csc.py:432-457
        from .ops import arithmetic

        if not isinstance(other, CSC):
            return NotImplemented
        return arithmetic.equal(self, other)

    __hash__ = None  # mutable-ish container

    def __getitem__(self, key):
        from .ops import slicing

        return slicing.getitem(self, key)

    def __setitem__(self, key, value):
        raise TypeError(
            "CSC is immutable; build with TripletBuilder / LilMat instead "
            "(matches reference csc.py:288-292)"
        )

    def t(self) -> "CSC":
        from .ops import construct

        return construct.transpose(self)

    @property
    def T(self) -> "CSC":
        return self.t()

    def conj(self) -> "CSC":
        return CSC(
            self.m, self.n, self.indptr, self.indices, jnp.conj(self.data),
            nnz=self.nnz, canonical=self.canonical,
        )

    def islands(self):
        from .ops import graph

        return graph.islands(self)

    def get_nnz(self) -> int:
        return self.nnz

    def norm(self, ord=1):
        from .ops import norms

        return norms.norm(self, ord=ord)

    def diagonal(self):
        from .ops import reductions

        return reductions.diagonal(self)

    def sum(self, axis=None):
        from .ops import reductions

        return reductions.sum(self, axis=axis)


@jax.tree_util.register_pytree_node_class
class CSR(_SparseBase):
    """Compressed sparse row matrix (row-gather SpMV format,
    reference kernels: src/sparsetools/csr.h)."""

    def __init__(self, m, n, indptr, indices, data, nnz=None, canonical=True):
        self.m = int(m)
        self.n = int(n)
        self._np = _host_cache(indptr, indices, data)
        self._indptr = indptr
        self._indices = indices
        self._data = data
        self.nnz = int(nnz) if nnz is not None else int(np.shape(indices)[0])
        self.canonical = bool(canonical)

    indptr = property(lambda self: _lazy(self, "_indptr"))
    indices = property(lambda self: _lazy(self, "_indices"))
    data = property(lambda self: _lazy(self, "_data"))

    def tree_flatten(self):
        return (self.indptr, self.indices, self.data), (
            self.m,
            self.n,
            self.nnz,
            self.canonical,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        m, n, nnz, canonical = aux
        indptr, indices, data = children
        obj = object.__new__(cls)
        obj.m, obj.n, obj.nnz, obj.canonical = m, n, nnz, canonical
        obj._indptr, obj._indices, obj._data = indptr, indices, data
        obj._np = None
        return obj

    def __repr__(self):
        return (
            f"CSR(m={self.m}, n={self.n}, nnz={self.nnz}, "
            f"cap={self.capacity}, dtype={self.data.dtype})"
        )

    def np_arrays(self):
        k = self.nnz
        if self._np is not None:
            ip, ix, dt = self._np
            return ip, ix[:k], dt[:k]
        return (
            np.asarray(self.indptr),
            np.asarray(self.indices)[:k],
            np.asarray(self.data)[:k],
        )

    def to_csc(self) -> CSC:
        from .ops import construct

        return construct.csr_to_csc(self)

    def todense(self):
        from .ops import construct

        return construct.csc_to_dense(self.to_csc())

    def to_scipy(self):
        import scipy.sparse as sp

        ip, ix, dt = self.np_arrays()
        return sp.csr_matrix((dt, ix, ip), shape=self.shape)

    @classmethod
    def from_scipy(cls, a) -> "CSR":
        a = a.tocsr()
        return cls(a.shape[0], a.shape[1], a.indptr, a.indices, a.data)

    def t(self) -> CSC:
        """Transpose — zero-copy: the CSR arrays of A ARE the CSC arrays
        of A^T (reference: csr.h:418 csr_tocsc doubles as transpose)."""
        ip, ix, dt = self.np_arrays()
        return CSC(self.n, self.m, ip, ix, dt, canonical=self.canonical)

    @property
    def T(self) -> CSC:
        return self.t()

    # operators delegate to the CSC op layer (CSC is the primary format;
    # reference csc.h delegates to csr.h the same way, with roles swapped);
    # CSR (op) CSR comes back as CSR
    def __matmul__(self, other):
        if isinstance(other, CSR):
            return (self.to_csc() @ other.to_csc()).to_csr()
        return self.to_csc() @ other

    def __mul__(self, other):
        if isinstance(other, CSR):
            return (self.to_csc() * other.to_csc()).to_csr()
        return self.to_csc() * other

    def __rmul__(self, other):
        return self.to_csc().__rmul__(other)

    def __add__(self, other):
        other = other.to_csc() if isinstance(other, CSR) else other
        return (self.to_csc() + other).to_csr()

    def __sub__(self, other):
        other = other.to_csc() if isinstance(other, CSR) else other
        return (self.to_csc() - other).to_csr()

    def __neg__(self):
        ip, ix, dt = self.np_arrays()
        return CSR(self.m, self.n, ip, ix, -dt, canonical=self.canonical)


@jax.tree_util.register_pytree_node_class
class COO(_SparseBase):
    """Triplet (coordinate) matrix — the construction format
    (reference: src/CSparse3/coo.py)."""

    def __init__(self, m, n, rows, cols, data, nnz=None):
        self.m = int(m)
        self.n = int(n)
        self._np = _host_cache(rows, cols, data)
        self._rows = rows
        self._cols = cols
        self._data = data
        self.nnz = int(nnz) if nnz is not None else int(np.shape(rows)[0])

    rows = property(lambda self: _lazy(self, "_rows"))
    cols = property(lambda self: _lazy(self, "_cols"))
    data = property(lambda self: _lazy(self, "_data"))

    def tree_flatten(self):
        return (self.rows, self.cols, self.data), (self.m, self.n, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        m, n, nnz = aux
        rows, cols, data = children
        obj = object.__new__(cls)
        obj.m, obj.n, obj.nnz = m, n, nnz
        obj._rows, obj._cols, obj._data = rows, cols, data
        obj._np = None
        return obj

    def __repr__(self):
        return f"COO(m={self.m}, n={self.n}, nnz={self.nnz}, dtype={self.data.dtype})"

    def np_arrays(self):
        k = self.nnz
        if self._np is not None:
            r, c, d = self._np
            return r[:k], c[:k], d[:k]
        return (
            np.asarray(self.rows)[:k],
            np.asarray(self.cols)[:k],
            np.asarray(self.data)[:k],
        )

    def to_csc(self, sum_duplicates: bool = True) -> CSC:
        from .ops import construct

        return construct.coo_to_csc(self, sum_duplicates=sum_duplicates)

    def to_csr(self, sum_duplicates: bool = True) -> CSR:
        from .ops import construct

        return construct.coo_to_csc(self, sum_duplicates=sum_duplicates).to_csr()

    def to_dense(self):
        from .ops import construct

        return construct.coo_to_dense(self)

    def to_scipy(self):
        import scipy.sparse as sp

        r, c, d = self.np_arrays()
        return sp.coo_matrix((d, (r, c)), shape=self.shape)

    @classmethod
    def from_scipy(cls, a) -> "COO":
        a = a.tocoo()
        return cls(a.shape[0], a.shape[1], a.row, a.col, a.data)


@jax.tree_util.register_pytree_node_class
class BSR(_SparseBase):
    """Block sparse row matrix with matmul-sized dense blocks.

    The internal compute format: data has shape (nblocks, R, C) so each
    block feeds a matmul directly (reference blueprint:
    src/sparsetools/bsr.h:249-316 block-Gustavson; csr.h:157/204
    count_blocks / tobsr).  mb = m/R block rows, nb = n/C block cols; the
    logical matrix is zero-padded up to (mb*R, nb*C).
    """

    def __init__(self, m, n, R, C, indptr, indices, data, nnz_blocks=None):
        self.m = int(m)
        self.n = int(n)
        self.R = int(R)
        self.C = int(C)
        self.indptr = _asarray(indptr)
        self.indices = _asarray(indices)
        self.data = _asarray(data)
        self.nnz_blocks = (
            int(nnz_blocks) if nnz_blocks is not None else int(self.indices.shape[0])
        )

    @property
    def mb(self) -> int:
        return -(-self.m // self.R)

    @property
    def nb(self) -> int:
        return -(-self.n // self.C)

    @property
    def nnz(self) -> int:  # dense-count inside blocks
        return self.nnz_blocks * self.R * self.C

    def tree_flatten(self):
        return (self.indptr, self.indices, self.data), (
            self.m,
            self.n,
            self.R,
            self.C,
            self.nnz_blocks,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        m, n, R, C, nnzb = aux
        indptr, indices, data = children
        obj = object.__new__(cls)
        obj.m, obj.n, obj.R, obj.C, obj.nnz_blocks = m, n, R, C, nnzb
        obj.indptr, obj.indices, obj.data = indptr, indices, data
        return obj

    def __repr__(self):
        return (
            f"BSR(m={self.m}, n={self.n}, block={self.R}x{self.C}, "
            f"nnz_blocks={self.nnz_blocks}, dtype={self.data.dtype})"
        )

    def todense(self):
        from .ops import construct

        return construct.bsr_to_dense(self)

    def to_csc(self) -> "CSC":
        """Expand blocks to entries (explicit zeros inside blocks are
        dropped) — the bsr_tocsr idiom (reference: bsr.h:722)."""
        from .ops import construct

        nbk = self.nnz_blocks
        ip = np.asarray(self.indptr)
        bcols = np.asarray(self.indices)[:nbk]
        dat = np.asarray(self.data)[:nbk]
        brows = np.repeat(np.arange(self.mb, dtype=np.int64), np.diff(ip))
        R, C = self.R, self.C
        shape3 = (len(brows), R, C)
        rr = np.broadcast_to(
            brows[:, None, None] * R + np.arange(R)[None, :, None],
            shape3).ravel()
        cc = np.broadcast_to(
            bcols[:, None, None].astype(np.int64) * C
            + np.arange(C)[None, None, :], shape3).ravel()
        vv = dat.ravel()
        keep = (vv != 0) & (rr < self.m) & (cc < self.n)
        return construct.from_triplets(rr[keep], cc[keep], vv[keep],
                                       (self.m, self.n))

    def t(self) -> "BSR":
        """Block transpose (reference: bsr_transpose, bsr.h:212) — block
        permutation + one batched swapaxes, no CSC round-trip."""
        from .ops import bsr_ops

        return bsr_ops.bsr_transpose(self)

    @property
    def T(self) -> "BSR":
        return self.t()

    # native block binops (reference kernels: bsr.h:349-694) — union
    # block pattern on host, blockwise device arithmetic; CSC fallback
    # only for mixed-format operands
    def __add__(self, other):
        from .ops import bsr_ops

        if isinstance(other, BSR) and (self.R, self.C) == (other.R, other.C):
            return bsr_ops.bsr_add(self, other)
        other = other.to_csc() if isinstance(other, BSR) else other
        return (self.to_csc() + other).to_bsr(block=(self.R, self.C))

    def __sub__(self, other):
        from .ops import bsr_ops

        if isinstance(other, BSR) and (self.R, self.C) == (other.R, other.C):
            return bsr_ops.bsr_add(self, other, beta=-1.0)
        other = other.to_csc() if isinstance(other, BSR) else other
        return (self.to_csc() - other).to_bsr(block=(self.R, self.C))

    def __neg__(self):
        return BSR(self.m, self.n, self.R, self.C, self.indptr,
                   self.indices, -self.data, self.nnz_blocks)

    def multiply(self, other) -> "BSR":
        """Elementwise product (reference: bsr_elmul_bsr, bsr.h:593+)."""
        from .ops import bsr_ops

        return bsr_ops.bsr_binop(self, other, jnp.multiply)

    def __matmul__(self, other):
        if isinstance(other, BSR):
            if self.C == other.R:
                # block-Gustavson as matmuls (bsr.h:249-316 blueprint)
                from .ops import bsr_ops

                return bsr_ops.bsr_matmat(self, other)
            return (self.to_csc() @ other.to_csc()).to_bsr(
                block=(self.R, other.C))
        from .ops import matvec

        return matvec.bsr_spmm(self, jnp.asarray(other))

    def to_scipy(self):
        import scipy.sparse as sp

        nbk = self.nnz_blocks
        return sp.bsr_matrix(
            (np.asarray(self.data)[:nbk],
             np.asarray(self.indices)[:nbk], np.asarray(self.indptr)),
            shape=(self.mb * self.R, self.nb * self.C),
        )[: self.m, : self.n].tobsr(blocksize=(self.R, self.C)) \
            if (self.m % self.R or self.n % self.C) else sp.bsr_matrix(
            (np.asarray(self.data)[:nbk],
             np.asarray(self.indices)[:nbk], np.asarray(self.indptr)),
            shape=(self.m, self.n))

    @classmethod
    def from_scipy(cls, a) -> "BSR":
        a = a.tobsr()
        R, C = a.blocksize
        return cls(a.shape[0], a.shape[1], R, C, a.indptr, a.indices,
                   a.data)


@jax.tree_util.register_pytree_node_class
class DIA(_SparseBase):
    """Diagonal-offset sparse matrix (reference: src/sparsetools/dia.h).

    ``offsets`` (k,) int32, ``data`` (k, n) — data[i, j] is the value at
    (j - offsets[i], j), scipy dia_matrix layout.  The natural device format
    for banded matrices: SpMV is k shifted dense multiply-adds (pure
    slicing, no gather/scatter at all).
    """

    def __init__(self, m, n, offsets, data):
        self.m = int(m)
        self.n = int(n)
        self._np = _host_cache(offsets, data)
        self._offsets = offsets
        self._data = data

    offsets = property(lambda self: _lazy(self, "_offsets"))
    data = property(lambda self: _lazy(self, "_data"))

    def np_arrays(self):
        """(offsets, data) as host numpy without a device round-trip
        when the container was built from host data."""
        if self._np is not None:
            return self._np
        return np.asarray(self.offsets), np.asarray(self.data)

    @property
    def nnz(self) -> int:  # stored count (incl. explicit zeros in bands)
        total = 0
        offs = self.np_arrays()[0]
        for off in offs:
            lo = max(0, int(off))
            hi = min(self.n, self.m + int(off))
            total += max(0, hi - lo)
        return total

    def tree_flatten(self):
        return (self.offsets, self.data), (self.m, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.m, obj.n = aux
        obj._offsets, obj._data = children
        obj._np = None
        return obj

    def __repr__(self):
        return (
            f"DIA(m={self.m}, n={self.n}, ndiag={self.data.shape[0]}, "
            f"dtype={self.data.dtype})"
        )

    def to_scipy(self):
        import scipy.sparse as sp

        offs, dat = self.np_arrays()
        return sp.dia_matrix((dat, offs), shape=self.shape)

    @classmethod
    def from_scipy(cls, a) -> "DIA":
        a = a.todia()
        return cls(a.shape[0], a.shape[1], a.offsets, a.data)

    def to_csc(self):
        from .ops import construct

        return construct.dia_to_csc(self)

    def todense(self):
        return self.to_csc().todense()
