"""ctypes binding of the native host kernels (native/host_ext.cpp).

The reference binds its C++ through SWIG-generated wrappers
(reference: src/sparsetools/*_wrap.cxx); here a 200-line ctypes shim
replaces 228k lines of generated code.  The library is compiled from
``native/`` on first import (``native.ensure_built``); importing this
module raises ImportError when that build fails — callers
(linalg.lu.splu, ops.construct) then fall back to the numpy host kernels.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..linalg.lu_host import HostLU
from . import ensure_built

_LIB_PATH = ensure_built("libhost_ext.so")
_lib = ctypes.CDLL(_LIB_PATH)

_i64p = ctypes.POINTER(ctypes.c_int64)


class _LUResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("lnz", ctypes.c_int64),
        ("unz", ctypes.c_int64),
        ("nsing", ctypes.c_int64),
        ("Lp", _i64p),
        ("Li", _i64p),
        ("Up", _i64p),
        ("Ui", _i64p),
        ("perm_r", _i64p),
        ("sing", _i64p),
        ("Lx", ctypes.c_void_p),
        ("Ux", ctypes.c_void_p),
    ]


class _LDLTResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("lnz", ctypes.c_int64),
        ("nsing", ctypes.c_int64),
        ("Lp", _i64p),
        ("Li", _i64p),
        ("sing", _i64p),
        ("Lx", ctypes.c_void_p),
        ("D", ctypes.c_void_p),
    ]


for _name in ("ldlt_factor_d", "ldlt_factor_z"):
    fn = getattr(_lib, _name)
    fn.restype = ctypes.POINTER(_LDLTResult)
    fn.argtypes = [ctypes.c_int64, _i64p, _i64p, ctypes.c_void_p]
_lib.ldlt_free.restype = None
_lib.ldlt_free.argtypes = [ctypes.POINTER(_LDLTResult)]


def ldlt_factor(n, Ap, Ai, Ax):
    """A = L D L^T of a symmetric CSC (values: full matrix, both
    triangles).  Returns (Lp, Li, Lx, D, sing) with L unit-lower
    (unit diagonal stored)."""
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    Ax = np.ascontiguousarray(np.asarray(Ax))
    if np.issubdtype(Ax.dtype, np.complexfloating):
        Ax = Ax.astype(np.complex128, copy=False)
        fn, vdt = _lib.ldlt_factor_z, np.complex128
    else:
        Ax = Ax.astype(np.float64, copy=False)
        fn, vdt = _lib.ldlt_factor_d, np.float64
    res = fn(ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai),
             Ax.ctypes.data_as(ctypes.c_void_p))
    r = res.contents
    try:
        def icopy(ptr, cnt):
            if cnt == 0:
                return np.zeros(0, dtype=np.int64)
            return np.ctypeslib.as_array(ptr, shape=(cnt,)).copy()

        def vcopy(ptr, cnt):
            if cnt == 0:
                return np.zeros(0, dtype=vdt)
            p = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_double))
            k = cnt * (2 if vdt == np.complex128 else 1)
            return np.ctypeslib.as_array(p, shape=(k,)).copy().view(vdt)

        Lp = icopy(r.Lp, n + 1)
        Li = icopy(r.Li, r.lnz)
        Lx = vcopy(r.Lx, r.lnz)
        D = vcopy(r.D, n)
        sing = icopy(r.sing, r.nsing)
    finally:
        _lib.ldlt_free(res)
    return Lp, Li, Lx, D, sing


for _name in ("lu_factor_d", "lu_factor_z"):
    fn = getattr(_lib, _name)
    fn.restype = ctypes.POINTER(_LUResult)
    fn.argtypes = [
        ctypes.c_int64, _i64p, _i64p, ctypes.c_void_p, _i64p, ctypes.c_double,
        ctypes.c_int64,
    ]
for _name in ("lu_factor_sn_d", "lu_factor_sn_z"):
    fn = getattr(_lib, _name)
    fn.restype = ctypes.POINTER(_LUResult)
    fn.argtypes = [ctypes.c_int64, _i64p, _i64p, ctypes.c_void_p, _i64p]
_lib.lu_load_blas.restype = ctypes.c_int
_lib.lu_load_blas.argtypes = [ctypes.c_char_p]


def _load_blas() -> bool:
    """Point the dense-tail LU at scipy's bundled OpenBLAS (getrf)."""
    import glob

    try:
        import scipy
    except ImportError:
        return False
    for root in (os.path.dirname(os.path.dirname(scipy.__file__)),):
        for pat in ("scipy.libs/libscipy_openblas*.so*",
                    "numpy.libs/libscipy_openblas*.so*"):
            for cand in sorted(glob.glob(os.path.join(root, pat))):
                if _lib.lu_load_blas(cand.encode()):
                    return True
    return False


_HAVE_BLAS = _load_blas()
_lib.lu_free.restype = None
_lib.lu_free.argtypes = [ctypes.POINTER(_LUResult)]
_lib.amd_order.restype = None
_lib.amd_order.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
_lib.rcm_order.restype = None
_lib.rcm_order.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
_lib.nd_order.restype = None
_lib.nd_order.argtypes = [ctypes.c_int64, _i64p, _i64p, ctypes.c_int64, _i64p]
_lib.max_transversal.restype = ctypes.c_int64
_lib.max_transversal.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p]
_lib.btf_order.restype = None
_lib.btf_order.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p]
_lib.coo_to_csc_d.restype = ctypes.c_int64
_lib.coo_to_csc_d.argtypes = [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    _i64p, _i64p, ctypes.c_void_p, _i64p, _i64p, ctypes.c_void_p,
]


def _as_i64(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.int64)


def _i64_ptr(a):
    return a.ctypes.data_as(_i64p)


def lu_factor(n, Ap, Ai, Ax, q=None, tol: float = 1.0,
              dense_cap: int = 8192) -> HostLU:
    """Native twin of linalg.lu_host.lu_factor_host (P A Q = L U).

    dense_cap > 0 enables the dense trailing-block finish (LAPACK getrf on
    the final Schur complement once it turns dense — the separator clique
    carries 80%+ of the flops on grid cases).  It uses strict partial
    pivoting, so it is disabled automatically when tol == 0 (the
    no-row-exchange mode BandedSolvePlan depends on)."""
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    Ax = np.ascontiguousarray(np.asarray(Ax))
    if np.issubdtype(Ax.dtype, np.complexfloating):
        Ax = Ax.astype(np.complex128, copy=False)
        fn, vdt = _lib.lu_factor_z, np.complex128
    else:
        Ax = Ax.astype(np.float64, copy=False)
        fn, vdt = _lib.lu_factor_d, np.float64
    qa = _as_i64(q if q is not None else np.arange(n))
    if tol == 0.0 or not _HAVE_BLAS:
        dense_cap = 0  # strict-partial-pivot tail would break no-exchange
        # mode; without getrf the kernel would also just ignore it
    res = fn(
        ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai),
        Ax.ctypes.data_as(ctypes.c_void_p), _i64_ptr(qa),
        ctypes.c_double(tol), ctypes.c_int64(int(dense_cap)),
    )
    return _unpack_lu(res, n, qa, vdt)


def _unpack_lu(res, n, qa, vdt) -> HostLU:
    r = res.contents
    try:
        def icopy(ptr, cnt):
            if cnt == 0:
                return np.zeros(0, dtype=np.int64)
            return np.ctypeslib.as_array(ptr, shape=(cnt,)).copy()

        def vcopy(ptr, cnt):
            if cnt == 0:
                return np.zeros(0, dtype=vdt)
            p = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_double))
            k = cnt * (2 if vdt == np.complex128 else 1)
            return np.ctypeslib.as_array(p, shape=(k,)).copy().view(vdt)

        out = HostLU(
            n=n,
            Lp=icopy(r.Lp, n + 1),
            Li=icopy(r.Li, r.lnz),
            Lx=vcopy(r.Lx, r.lnz),
            Up=icopy(r.Up, n + 1),
            Ui=icopy(r.Ui, r.unz),
            Ux=vcopy(r.Ux, r.unz),
            perm_r=icopy(r.perm_r, n),
            perm_c=qa.copy(),
            singular_cols=icopy(r.sing, r.nsing),
        )
    finally:
        _lib.lu_free(res)
    return out


def lu_factor_sn(n, Ap, Ai, Ax, q=None):
    """Supernodal multifrontal LU (native/lu_sn.cpp): BLAS-3 fronts with
    within-front partial pivoting.  Intended for structurally symmetric,
    well-conditioned systems (Ybus/B'); returns None when the native
    kernel declines (no BLAS-3, exactly singular fully-summed block, or
    inconsistent structure) — callers fall back to ``lu_factor``."""
    if not _HAVE_BLAS:
        return None
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    Ax = np.ascontiguousarray(np.asarray(Ax))
    if np.issubdtype(Ax.dtype, np.complexfloating):
        Ax = Ax.astype(np.complex128, copy=False)
        fn, vdt = _lib.lu_factor_sn_z, np.complex128
    else:
        Ax = Ax.astype(np.float64, copy=False)
        fn, vdt = _lib.lu_factor_sn_d, np.float64
    qa = _as_i64(q if q is not None else np.arange(n))
    res = fn(ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai),
             Ax.ctypes.data_as(ctypes.c_void_p), _i64_ptr(qa))
    if not res:
        return None
    return _unpack_lu(res, n, qa, vdt)


def amd(n, Ap, Ai) -> np.ndarray:
    """Approximate-minimum-degree elimination order for the symmetrized
    pattern of a square CSC (native twin of linalg.ordering.mindeg)."""
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    out = np.empty(n, dtype=np.int64)
    _lib.amd_order(ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai), _i64_ptr(out))
    return out


def rcm(n, Ap, Ai) -> np.ndarray:
    """Reverse Cuthill-McKee order (native twin of linalg.ordering.rcm;
    tie-breaking may differ, the bandwidth profile is the contract)."""
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    out = np.empty(n, dtype=np.int64)
    _lib.rcm_order(ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai), _i64_ptr(out))
    return out


def nd(n, Ap, Ai, leaf_size: int = 5000) -> np.ndarray:
    """Nested-dissection elimination order (BFS level-set separators,
    AMD leaves) — the fill-controlling choice for large near-planar
    grids where plain minimum-degree fill blows up superlinearly."""
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    out = np.empty(n, dtype=np.int64)
    _lib.nd_order(ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai),
                  ctypes.c_int64(leaf_size), _i64_ptr(out))
    return out


def max_transversal(n, Ap, Ai):
    """Maximum bipartite matching of columns to rows (MC21-class).
    Returns (match, size): match[c] = row for column c, -1 if unmatched;
    size == n iff the matrix is structurally nonsingular."""
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    out = np.empty(n, dtype=np.int64)
    size = _lib.max_transversal(ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai),
                                _i64_ptr(out))
    return out, int(size)


def btf(n, Ap, Ai):
    """Block triangular form: returns (p, q, blocks) such that A[p][:, q]
    is block triangular with block b spanning rows/cols
    [blocks[b], blocks[b+1])."""
    Ap = _as_i64(Ap)
    Ai = _as_i64(Ai)
    p = np.empty(n, dtype=np.int64)
    q = np.empty(n, dtype=np.int64)
    bp = np.zeros(n + 1, dtype=np.int64)
    nb = np.zeros(1, dtype=np.int64)
    _lib.btf_order(ctypes.c_int64(n), _i64_ptr(Ap), _i64_ptr(Ai),
                   _i64_ptr(p), _i64_ptr(q), _i64_ptr(bp), _i64_ptr(nb))
    return p, q, bp[: int(nb[0]) + 1]


def coo_to_csc(m, n, rows, cols, vals):
    """Native triplet->CSC assembly (float64; sums duplicates).
    Returns (indptr, indices, data) trimmed to the unique count."""
    rows = _as_i64(rows)
    cols = _as_i64(cols)
    vals = np.ascontiguousarray(np.asarray(vals), dtype=np.float64)
    nnz = len(rows)
    out_p = np.zeros(n + 1, dtype=np.int64)
    out_i = np.empty(max(nnz, 1), dtype=np.int64)
    out_x = np.empty(max(nnz, 1), dtype=np.float64)
    u = _lib.coo_to_csc_d(
        m, n, nnz, _i64_ptr(rows), _i64_ptr(cols),
        vals.ctypes.data_as(ctypes.c_void_p), _i64_ptr(out_p), _i64_ptr(out_i),
        out_x.ctypes.data_as(ctypes.c_void_p),
    )
    return out_p, out_i[:u], out_x[:u]


class _RefactorBuild(ctypes.Structure):
    _fields_ = [
        ("total", ctypes.c_int64),
        ("ndiv", ctypes.c_int64),
        ("nlev", ctypes.c_int64),
        ("upd_dst", _i64p),
        ("upd_L", _i64p),
        ("upd_U", _i64p),
        ("upd_lev", _i64p),
        ("div_dst", _i64p),
        ("div_piv", _i64p),
        ("div_lev", _i64p),
        ("a_dst", _i64p),
    ]


_lib.refactor_build.restype = ctypes.POINTER(_RefactorBuild)
_lib.refactor_build.argtypes = [
    ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
    ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
]
_lib.refactor_free.restype = None
_lib.refactor_free.argtypes = [ctypes.POINTER(_RefactorBuild)]


def refactor_build(n, Lp, Li, Up, Ui, Ap, Ai, perm_r, q):
    """Native symbolic build for linalg.refactor.RefactorPlan: update
    triples + division pairs (level-sorted) and the A->X scatter map."""
    Lp, Li, Up, Ui = map(_as_i64, (Lp, Li, Up, Ui))
    Ap, Ai, perm_r, q = map(_as_i64, (Ap, Ai, perm_r, q))
    a_nnz = len(Ai)
    res = _lib.refactor_build(
        n, _i64_ptr(Lp), _i64_ptr(Li), _i64_ptr(Up), _i64_ptr(Ui),
        a_nnz, _i64_ptr(Ap), _i64_ptr(Ai), _i64_ptr(perm_r), _i64_ptr(q),
    )
    r = res.contents
    try:
        def cp(ptr, cnt):
            if cnt == 0:
                return np.zeros(0, dtype=np.int64)
            return np.ctypeslib.as_array(ptr, shape=(cnt,)).copy()

        out = dict(
            nlev=int(r.nlev),
            upd_dst=cp(r.upd_dst, r.total),
            upd_L=cp(r.upd_L, r.total),
            upd_U=cp(r.upd_U, r.total),
            upd_lev=cp(r.upd_lev, r.total),
            div_dst=cp(r.div_dst, r.ndiv),
            div_piv=cp(r.div_piv, r.ndiv),
            div_lev=cp(r.div_lev, r.ndiv),
            a_dst=cp(r.a_dst, a_nnz),
        )
    finally:
        _lib.refactor_free(res)
    return out


_i32p = ctypes.POINTER(ctypes.c_int32)


def _reg(name, argtypes, restype=None):
    f = getattr(_lib, name)
    f.restype = restype
    f.argtypes = argtypes
    return f


for _ip in (_i64p, _i32p):
    _sfx = "" if _ip is _i64p else "32"
    _reg("csc_spgemm_size" + _sfx,
         [ctypes.c_int64, _ip, _ip, ctypes.c_int64, _ip, _ip, _ip],
         ctypes.c_int64)
    for _n in ("csc_spgemm_numeric_d", "csc_spgemm_numeric_z",
               "csc_spgemm_numeric_s"):
        _reg(_n + _sfx, [
            ctypes.c_int64, _ip, _ip, ctypes.c_void_p,
            ctypes.c_int64, _ip, _ip, ctypes.c_void_p,
            _ip, _ip, ctypes.c_void_p, ctypes.c_int,
        ])
    for _n in ("csc_transpose_d", "csc_transpose_z", "csc_transpose_s"):
        _reg(_n + _sfx, [
            ctypes.c_int64, ctypes.c_int64, _ip, _ip, ctypes.c_void_p,
            _ip, _ip, ctypes.c_void_p,
        ])
    for _n in ("csc_axpby_d", "csc_axpby_s"):
        _reg(_n + _sfx, [
            ctypes.c_int64, _ip, _ip, ctypes.c_void_p, ctypes.c_double,
            _ip, _ip, ctypes.c_void_p, ctypes.c_double,
            _ip, _ip, ctypes.c_void_p,
        ], ctypes.c_int64)
    _reg("csc_axpby_z" + _sfx, [
        ctypes.c_int64, _ip, _ip, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double,
        _ip, _ip, ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        _ip, _ip, ctypes.c_void_p,
    ], ctypes.c_int64)
    _reg("csc_gram_size" + _sfx,
         [ctypes.c_int64, ctypes.c_int64, _ip, _ip, _ip],
         ctypes.c_int64)
    for _n in ("csc_gram_numeric_d", "csc_gram_numeric_s",
               "csc_gram_numeric_z"):
        _reg(_n + _sfx, [
            ctypes.c_int64, ctypes.c_int64, _ip, _ip, ctypes.c_void_p,
            _ip, _ip, ctypes.c_void_p,
        ], ctypes.c_int)


def _index_env(*arrays):
    """(np index dtype, fn-name suffix, ctypes ptr caster) for a call.

    int32 operands stay int32 — half the index memory traffic and no
    int64 conversion copies (the default config index dtype is int32);
    anything else is normalized to int64.
    """
    if all(np.asarray(a).dtype == np.int32 for a in arrays):
        idt = np.dtype(np.int32)
        cast = lambda a: np.ascontiguousarray(a).ctypes.data_as(_i32p)  # noqa: E731
        return idt, "32", cast
    idt = np.dtype(np.int64)
    cast = lambda a: _i64_ptr(_as_i64(a))  # noqa: E731
    return idt, "", cast


def _host_vdt(cx, *vals):
    """Value dtype for a native call: complex128 when any operand is
    complex, float32 when EVERY operand already is (grid data — skips
    the up/down conversion copies), float64 otherwise."""
    if cx:
        return np.complex128
    if all(np.asarray(v).dtype == np.float32 for v in vals):
        return np.float32
    return np.float64


def _spgemm_raw(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, vdt, cx, sorted_, env):
    """Gustavson passes; emit order per ``sorted_``.  Arrays must already
    be contiguous in the env's index dtype."""
    idt, sfx, ptr = env
    Cp = np.empty(nB + 1, dtype=idt)  # pass1 writes every entry
    nnz = getattr(_lib, "csc_spgemm_size" + sfx)(
        m, ptr(Ap), ptr(Ai), nB, ptr(Bp), ptr(Bi), ptr(Cp),
    )
    if nnz < 0:  # int32 overflow in the symbolic pass: redo in int64
        env64 = (np.dtype(np.int64), "", lambda a: _i64_ptr(_as_i64(a)))
        return _spgemm_raw(m, _as_i64(Ap), _as_i64(Ai), Ax, nB,
                           _as_i64(Bp), _as_i64(Bi), Bx, vdt, cx, sorted_,
                           env64)
    Ci = np.empty(max(nnz, 1), dtype=idt)
    Cx = np.empty(max(nnz, 1), dtype=vdt)
    fn = getattr(_lib, ("csc_spgemm_numeric_z" if cx else
                        "csc_spgemm_numeric_s" if vdt == np.float32 else
                        "csc_spgemm_numeric_d") + sfx)
    fn(
        m, ptr(Ap), ptr(Ai), Ax.ctypes.data_as(ctypes.c_void_p),
        nB, ptr(Bp), ptr(Bi), Bx.ctypes.data_as(ctypes.c_void_p),
        ptr(Cp), ptr(Ci), Cx.ctypes.data_as(ctypes.c_void_p),
        1 if sorted_ else 0,
    )
    return Cp, Ci[:nnz], Cx[:nnz]


def _transpose_raw(rows, ncols, Xp, Xi, Xx, vdt, cx, env):
    idt, sfx, ptr = env
    nz = len(Xi)
    Tp = np.zeros(rows + 1, dtype=idt)
    Ti = np.empty(max(nz, 1), dtype=idt)
    Tx = np.empty(max(nz, 1), dtype=vdt)
    fn = getattr(_lib, ("csc_transpose_z" if cx else
                        "csc_transpose_s" if vdt == np.float32 else
                        "csc_transpose_d") + sfx)
    fn(rows, ncols, ptr(Xp), ptr(Xi), Xx.ctypes.data_as(ctypes.c_void_p),
       ptr(Tp), ptr(Ti), Tx.ctypes.data_as(ctypes.c_void_p))
    return Tp, Ti[:nz], Tx[:nz]


def csc_spgemm(m, Ap, Ai, Ax, nB, Bp, Bi, Bx):
    """Native C = A @ B for CSC operands; returns canonical
    (indptr, indices, data).

    Route: direct A·B Gustavson, both passes FLOP-balanced across
    threads (columns of C are independent given the symbolic offsets),
    with canonical per-column sort+gather emit.  The former
    transpose-canonicalized formulations lose to this: the unsorted
    emit's count-scatter transpose is a cache-hostile random scatter
    (~8x a canonical-input transpose) and its fresh output buffers hit
    the sandbox's fresh-page cliff, while the per-column sort
    parallelizes with the numeric pass for free."""
    env = _index_env(Ap, Ai, Bp, Bi)
    idt = env[0]
    Ap, Ai, Bp, Bi = (np.ascontiguousarray(a, dtype=idt)
                      for a in (Ap, Ai, Bp, Bi))
    cx = np.iscomplexobj(Ax) or np.iscomplexobj(Bx)
    vdt = _host_vdt(cx, Ax, Bx)
    Ax = np.ascontiguousarray(np.asarray(Ax), dtype=vdt)
    Bx = np.ascontiguousarray(np.asarray(Bx), dtype=vdt)
    return _spgemm_raw(m, Ap, Ai, Ax, nB, Bp, Bi, Bx, vdt, cx,
                       sorted_=True, env=env)


def csc_axpby(n, Ap, Ai, Ax, alpha, Bp, Bi, Bx, beta, res_dt=None):
    """Native C = alpha*A + beta*B for canonical CSC operands; returns
    canonical (indptr, indices, data)."""
    env = _index_env(Ap, Ai, Bp, Bi)
    cap = len(Ai) + len(Bi)
    if env[1] == "32" and cap > np.iinfo(np.int32).max:
        env = (np.dtype(np.int64), "", lambda a: _i64_ptr(_as_i64(a)))
    idt, sfx, ptr = env
    Ap, Ai, Bp, Bi = (np.ascontiguousarray(a, dtype=idt)
                      for a in (Ap, Ai, Bp, Bi))
    cx = (np.iscomplexobj(Ax) or np.iscomplexobj(Bx)
          or np.iscomplexobj(alpha) or np.iscomplexobj(beta))
    # accumulate in the CALLER's result dtype: f32 inputs with an f64
    # result contract (numpy-2 promotion with python scalars) must not
    # silently round in f32
    if res_dt is not None and not cx:
        vdt = np.float32 if np.dtype(res_dt) == np.float32 else np.float64
    else:
        vdt = _host_vdt(cx, Ax, Bx)
    Ax = np.ascontiguousarray(np.asarray(Ax), dtype=vdt)
    Bx = np.ascontiguousarray(np.asarray(Bx), dtype=vdt)
    cap = max(cap, 1)
    Cp = np.zeros(n + 1, dtype=idt)
    Ci = np.empty(cap, dtype=idt)
    Cx = np.empty(cap, dtype=vdt)
    if cx:
        al, be = complex(alpha), complex(beta)
        nnz = getattr(_lib, "csc_axpby_z" + sfx)(
            n, ptr(Ap), ptr(Ai),
            Ax.ctypes.data_as(ctypes.c_void_p), al.real, al.imag,
            ptr(Bp), ptr(Bi),
            Bx.ctypes.data_as(ctypes.c_void_p), be.real, be.imag,
            ptr(Cp), ptr(Ci), Cx.ctypes.data_as(ctypes.c_void_p),
        )
    else:
        nnz = getattr(_lib, ("csc_axpby_s" if vdt == np.float32 else
                             "csc_axpby_d") + sfx)(
            n, ptr(Ap), ptr(Ai),
            Ax.ctypes.data_as(ctypes.c_void_p), float(alpha),
            ptr(Bp), ptr(Bi),
            Bx.ctypes.data_as(ctypes.c_void_p), float(beta),
            ptr(Cp), ptr(Ci), Cx.ctypes.data_as(ctypes.c_void_p),
        )
    return Cp, Ci[:nnz], Cx[:nnz]


def csc_gram(m, k, Ap, Ai, Ax):
    """C = A @ A.T for A (m x k) CSC — the reference's flagship
    connectivity product (test3_lil_matrix.py:29-48, A = C * C.t()).

    Fused native kernel: lower-half Gustavson + sorted mirror (symmetric
    output, including complex without conjugation — (A Aᵀ)ᵀ = A Aᵀ).
    Returns canonical (Cp, Ci, Cx).
    """
    env = _index_env(Ap, Ai)
    idt, sfx, ptr = env
    Ap = np.ascontiguousarray(Ap, dtype=idt)
    Ai = np.ascontiguousarray(Ai, dtype=idt)
    cx = np.iscomplexobj(Ax)
    vdt = _host_vdt(cx, Ax)
    Ax = np.ascontiguousarray(np.asarray(Ax), dtype=vdt)
    Cp = np.empty(m + 1, dtype=idt)
    nnz = getattr(_lib, "csc_gram_size" + sfx)(m, k, ptr(Ap), ptr(Ai), ptr(Cp))
    if nnz < 0:
        raise OverflowError(
            "gram output nnz exceeds index dtype (reference guard: "
            "sparsetools csr.h:591-596); use int64 indices"
        )
    Ci = np.empty(max(nnz, 1), dtype=idt)
    Cx = np.empty(max(nnz, 1), dtype=vdt)
    fn = getattr(_lib, ("csc_gram_numeric_z" if cx else
                        "csc_gram_numeric_s" if vdt == np.float32 else
                        "csc_gram_numeric_d") + sfx)
    ok = fn(m, k, ptr(Ap), ptr(Ai), Ax.ctypes.data_as(ctypes.c_void_p),
            ptr(Cp), ptr(Ci), Cx.ctypes.data_as(ctypes.c_void_p))
    if not ok:
        raise RuntimeError("gram numeric pass called without matching size pass")
    return Cp, Ci[:nnz], Cx[:nnz]


_lib.csc_gram_symbolic_take.restype = ctypes.c_int64
_lib.csc_gram_symbolic_take.argtypes = [_i64p, _i64p, _i64p, _i64p]


def csc_gram_cached(m, k, Ap, Ai, Ax):
    """Like ``csc_gram`` but also returns the symbolic state (A^T pattern,
    output pattern, upper counts) for later ``csc_gram_revalue`` calls —
    the SpGEMM analogue of KLU refactorization: pattern fixed, values new.
    Returns (Cp, Ci, Cx, sym)."""
    env = _index_env(Ap, Ai)
    idt, sfx, ptr = env
    Ap = np.ascontiguousarray(Ap, dtype=idt)
    Ai = np.ascontiguousarray(Ai, dtype=idt)
    cx = np.iscomplexobj(Ax)
    vdt = _host_vdt(cx, Ax)
    Ax = np.ascontiguousarray(np.asarray(Ax), dtype=vdt)
    Cp = np.empty(m + 1, dtype=idt)
    nnz = getattr(_lib, "csc_gram_size" + sfx)(m, k, ptr(Ap), ptr(Ai), ptr(Cp))
    if nnz < 0:
        raise OverflowError(
            "gram output nnz exceeds index dtype (reference guard: "
            "sparsetools csr.h:591-596); use int64 indices")
    annz = int(Ap[k])
    Tp = np.empty(m + 1, dtype=np.int64)
    Ti = np.empty(max(annz, 1), dtype=np.int64)
    Tpos = np.empty(max(annz, 1), dtype=np.int64)
    up_cnt = np.empty(max(m, 1), dtype=np.int64)
    got = _lib.csc_gram_symbolic_take(
        Tp.ctypes.data_as(_i64p), Ti.ctypes.data_as(_i64p),
        Tpos.ctypes.data_as(_i64p), up_cnt.ctypes.data_as(_i64p))
    if got != annz:
        raise RuntimeError("gram symbolic context unavailable")
    Ci = np.empty(max(nnz, 1), dtype=idt)
    Cx = np.empty(max(nnz, 1), dtype=vdt)
    fn = getattr(_lib, ("csc_gram_numeric_z" if cx else
                        "csc_gram_numeric_s" if vdt == np.float32 else
                        "csc_gram_numeric_d") + sfx)
    ok = fn(m, k, ptr(Ap), ptr(Ai), Ax.ctypes.data_as(ctypes.c_void_p),
            ptr(Cp), ptr(Ci), Cx.ctypes.data_as(ctypes.c_void_p))
    if not ok:
        raise RuntimeError("gram numeric pass lost its symbolic context")
    sym = {"Tp": Tp, "Ti": Ti, "Tpos": Tpos, "up_cnt": up_cnt,
           "Cp": Cp, "Ci": Ci, "nnz": int(nnz), "m": int(m), "k": int(k),
           "annz": annz, "env": (idt, sfx), "vdt": vdt}
    return Cp, Ci[:nnz], Cx[:nnz], sym


def csc_gram_revalue(Ap, Ai, Ax, sym):
    """Numeric-only gram over a cached symbolic (``csc_gram_cached``):
    no pattern discovery, no sorting — accumulate + gather + mirror.
    Returns the new Cx (pattern arrays live in ``sym``)."""
    idt, sfx = sym["env"]
    m = sym["m"]
    Ap = np.ascontiguousarray(Ap, dtype=idt)
    Ai = np.ascontiguousarray(Ai, dtype=idt)
    cx = np.iscomplexobj(Ax)
    vdt = _host_vdt(cx, Ax)
    if vdt != sym["vdt"]:
        raise ValueError("value dtype changed since the symbolic pass")
    Ax = np.ascontiguousarray(np.asarray(Ax), dtype=vdt)
    if int(Ap[sym["k"]]) != sym["annz"]:
        raise ValueError("pattern changed since the symbolic pass")
    Cx = np.empty(max(sym["nnz"], 1), dtype=vdt)
    ptr = _index_env(Ap, Ai)[2]
    fn = getattr(_lib, ("csc_gram_revalue_z" if cx else
                        "csc_gram_revalue_s" if vdt == np.float32 else
                        "csc_gram_revalue_d") + sfx)
    fn(m, ptr(Ap), ptr(Ai), Ax.ctypes.data_as(ctypes.c_void_p),
       sym["Tp"].ctypes.data_as(_i64p), sym["Ti"].ctypes.data_as(_i64p),
       sym["Tpos"].ctypes.data_as(_i64p),
       sym["up_cnt"].ctypes.data_as(_i64p),
       ptr(sym["Cp"]), ptr(sym["Ci"]),
       Cx.ctypes.data_as(ctypes.c_void_p))
    return Cx


def csc_transpose(m, n, Ap, Ai, Ax):
    """Native A^T for CSC (count-scatter, O(nnz)); returns canonical CSC
    arrays of the (n, m) transpose."""
    env = _index_env(Ap, Ai)
    idt = env[0]
    Ap = np.ascontiguousarray(Ap, dtype=idt)
    Ai = np.ascontiguousarray(Ai, dtype=idt)
    cx = np.iscomplexobj(Ax)
    vdt = _host_vdt(cx, Ax)
    Ax = np.ascontiguousarray(np.asarray(Ax), dtype=vdt)
    return _transpose_raw(m, n, Ap, Ai, Ax, vdt, cx, env)
