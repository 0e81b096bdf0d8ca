"""Persistence: save/load of sparse matrices and factorizations.

The reference has no persistence at all (SURVEY §5.4 "Checkpoint /
resume: none — matrices are plain numpy arrays"); this module provides
the equivalent the north star needs (factor once on host, reuse
the factorization across batched-solve jobs):

* ``save_npz`` / ``load_npz`` — scipy-compatible .npz container for
  CSC/CSR/COO (scipy.sparse.load_npz reads our files and vice versa).
* ``save_lu`` / ``load_lu``   — a factorization bundle (L, U, perm_r,
  perm_c, singular_cols) that rebuilds a jittable SolvePlan without
  re-factoring.

Containers are also plain pytrees of arrays, so orbax/flax checkpointing
of solver states that embed them works out of the box.
"""

from __future__ import annotations

import numpy as np

from ..types import COO, CSC, CSR

__all__ = ["save_npz", "load_npz", "save_lu", "load_lu",
           "save_banded", "load_banded"]


def save_npz(path, a, compressed: bool = True):
    """Write a CSC/CSR/COO matrix in scipy's .npz layout."""
    if isinstance(a, CSC):
        fmt, arrays = "csc", {}
        ip, ix, dt = a.np_arrays()
        arrays = {"indptr": ip, "indices": ix, "data": dt}
    elif isinstance(a, CSR):
        fmt = "csr"
        ip, ix, dt = a.np_arrays()
        arrays = {"indptr": ip, "indices": ix, "data": dt}
    elif isinstance(a, COO):
        fmt = "coo"
        r, c, d = a.np_arrays()
        arrays = {"row": r, "col": c, "data": d}
    else:
        raise TypeError(f"cannot save {type(a).__name__}")
    payload = dict(
        format=np.array(fmt.encode("ascii")),
        shape=np.array(a.shape, dtype=np.int64),
        **arrays,
    )
    (np.savez_compressed if compressed else np.savez)(path, **payload)


def load_npz(path):
    """Read a scipy-or-ours .npz sparse container."""
    with np.load(path, allow_pickle=False) as f:
        fmt = f["format"].item()
        if isinstance(fmt, bytes):
            fmt = fmt.decode("ascii")
        m, n = (int(s) for s in f["shape"])
        if fmt == "csc":
            return CSC(m, n, f["indptr"], f["indices"], f["data"])
        if fmt == "csr":
            return CSR(m, n, f["indptr"], f["indices"], f["data"])
        if fmt == "coo":
            return COO(m, n, f["row"], f["col"], f["data"])
    raise ValueError(f"unsupported sparse format {fmt!r} in {path}")


def save_lu(path, lu, compressed: bool = True):
    """Persist a linalg.SparseLU factorization (host arrays)."""
    h = lu._h
    payload = dict(
        n=np.int64(h.n),
        Lp=h.Lp, Li=h.Li, Lx=h.Lx,
        Up=h.Up, Ui=h.Ui, Ux=h.Ux,
        perm_r=h.perm_r, perm_c=h.perm_c,
        singular_cols=h.singular_cols,
    )
    (np.savez_compressed if compressed else np.savez)(path, **payload)


def load_lu(path):
    """Rebuild a SparseLU (and its jittable solve plan) from disk."""
    from ..linalg.lu import SparseLU
    from ..linalg.lu_host import HostLU

    with np.load(path, allow_pickle=False) as f:
        h = HostLU(
            n=int(f["n"]),
            Lp=f["Lp"], Li=f["Li"], Lx=f["Lx"],
            Up=f["Up"], Ui=f["Ui"], Ux=f["Ux"],
            perm_r=f["perm_r"], perm_c=f["perm_c"],
            singular_cols=f["singular_cols"],
        )
    return SparseLU(h, h.Lx.dtype)


def save_banded(path, plan, compressed: bool = True):
    """Persist a linalg.BandedLU (block-Thomas factor stacks + layout).

    The factor-once / solve-many pattern at 100k+ nodes makes the factor
    the expensive step; this checkpoints it so later processes (or other
    hosts) skip straight to device solves (SURVEY §5.4)."""
    if plan._h is None:
        raise ValueError("host factor stacks lost through pytree flattening")
    ehat, sinv, uhat, perm = plan._h
    payload = dict(
        n=np.int64(plan.n), s=np.int64(plan.s), bw=np.int64(plan.bw),
        ehat=ehat, sinv=sinv, uhat=uhat, perm=np.asarray(perm),
    )
    (np.savez_compressed if compressed else np.savez)(path, **payload)


def load_banded(path):
    """Rebuild a BandedLU from disk (host stacks; device upload stays
    lazy, on first device use)."""
    from ..linalg.banded import BandedLU

    with np.load(path, allow_pickle=False) as f:
        ehat, sinv, uhat = f["ehat"], f["sinv"], f["uhat"]
        perm = f["perm"]
        obj = BandedLU._from_stacks(
            ehat, sinv, uhat, perm,
            int(f["n"]), int(f["s"]), int(f["bw"]))
        obj._h = (ehat, sinv, uhat, perm)
    return obj
