"""Three-phase (symmetric) short-circuit analysis.

Fault studies are the third canonical GridCal-class workload on this
matrix stack (after power flow and contingency): the fault current at bus
``i`` is read off the bus impedance matrix ``Z = Ybus^{-1}``, whose
columns are exactly multi-RHS solves against the complex LU factorization
(SURVEY scope note: the library's purpose is `Ybus . V = I` solves).  The
reference has no fault layer; this is new device capability:

* one complex ``splu`` of Ybus (native host kernel), then
* Z columns for all faulted buses as chunked multi-RHS solves (the
  BASELINE config-3 batched-solve shape; complex RHS cross the transfer
  boundary as split float pairs, ``utils.xfer``),
* post-fault voltages and branch currents as dense broadcasted algebra +
  one sparse SpMM.

Classical assumptions (MATPOWER/short-circuit-standard): pre-fault
voltage profile given (default flat 1.0 p.u.), loads neglected, fault
through impedance ``zf``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..linalg import splu
from ..ops import construct
from .grids import Grid, ybus

__all__ = ["SCResult", "zbus_columns", "short_circuit"]


class SCResult(NamedTuple):
    buses: np.ndarray    # faulted bus per scenario, (K,)
    ifault: np.ndarray   # complex fault current (p.u.), (K,)
    vpost: np.ndarray    # post-fault bus voltages, (K, n_bus)
    iflow: np.ndarray    # post-fault from-side branch currents, (K, n_branch)
    ok: np.ndarray       # False = no finite solution (islanded/singular)


def zbus_columns(Y, buses, ordering="auto", chunk: int = 512):
    """Columns ``Z[:, buses]`` of ``Ybus^{-1}`` via one complex LU and
    chunked multi-RHS solves.  Returns an (n, len(buses)) complex array.

    Never forms the dense inverse — at grid scale Z is dense even though
    Y is sparse; only the requested columns are ever materialized.
    """
    buses = np.asarray(buses, dtype=np.int64)
    n = Y.shape[0]
    if buses.size and (buses.min() < 0 or buses.max() >= n):
        raise IndexError("fault bus index out of range")
    lu = splu(Y, ordering=ordering)
    cols = np.empty((n, len(buses)), dtype=np.complex128)
    for s in range(0, len(buses), chunk):
        e = min(s + chunk, len(buses))
        rhs = np.zeros((n, e - s), dtype=np.complex128)
        rhs[buses[s:e], np.arange(e - s)] = 1.0
        cols[:, s:e] = np.asarray(lu.solve(rhs))
    return cols


def short_circuit(grid: Grid, buses=None, zf: complex = 0.0,
                  vpre=None, ordering="auto", chunk: int = 512) -> SCResult:
    """Screen three-phase bus faults.

    ``buses`` — faulted buses (default: all).  ``zf`` — fault impedance.
    ``vpre`` — pre-fault voltage phasors, (n_bus,) complex (default flat
    1.0 p.u.; pass a power-flow solution for accurate studies).

    Returns per-scenario fault currents, post-fault voltages, and
    from-side branch currents (``Yf @ v``).
    """
    n = grid.n_bus
    buses = (np.arange(n) if buses is None
             else np.asarray(buses, dtype=np.int64))
    vpre = (np.ones(n, dtype=np.complex128) if vpre is None
            else np.asarray(vpre, dtype=np.complex128))
    if vpre.shape != (n,):
        raise ValueError("vpre must be (n_bus,)")
    Y, Yf, _ = ybus(grid)
    Z = zbus_columns(Y, buses, ordering=ordering, chunk=chunk)  # (n, K)

    zii = Z[buses, np.arange(len(buses))] + zf
    with np.errstate(divide="ignore", invalid="ignore"):
        ifault = vpre[buses] / zii
    # v_k = vpre - Z[:, i] * If_i   (superposition)
    vpost = vpre[None, :] - (Z * ifault[None, :]).T  # (K, n)
    ok = (np.abs(zii) > 1e-12) & np.isfinite(vpost).all(axis=1)
    vpost[~ok] = np.nan
    ifault = np.where(ok, ifault, np.nan)

    # branch from-side currents: sparse SpMM over all scenarios, in host
    # complex128 — this step is O(nnz(Yf) * K), host-trivial next to the
    # Z-column solves
    ip, ix, dt = Yf.np_arrays()
    cols = construct.expand_indptr_np(ip)
    res = np.zeros((Yf.shape[0], len(buses)), dtype=np.complex128)
    np.add.at(res, ix, dt[:, None] * vpost.T[cols])
    return SCResult(buses, ifault, vpost, res.T, ok)
