"""The canonical GridCal flow, end to end (reference: test3_lil_matrix.py
and docs/connectivity_matrix.rst) — build branch connectivity with LilMat,
form the bus adjacency by SpGEMM, find islands, then go beyond the
reference: assemble Ybus, factor, and run the fully-jittable AC power flow.

Run: python examples/gridcal_flow.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

# float64 end-to-end: this demo shows exact f64 parity with the reference's
# flow; the f32 device path is what chip_smoke.py and bench.py exercise
jax.config.update("jax_enable_x64", True)

import csparse3_jax as cst
from csparse3_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()
from csparse3_jax.models.grids import ieee14, rcm_grid
from csparse3_jax.models.powerflow import FastDecoupled, NewtonPowerFlow

# --- the reference's 5-bus / 7-branch line table -------------------------
lines = [(3, 1), (4, 3), (5, 4), (5, 2), (5, 1), (2, 1), (2, 3)]
m, n = len(lines), 5

f_mat = cst.LilMat(m, n)
t_mat = cst.LilMat(m, n)
for k, (F, T) in enumerate(lines):
    f_mat[k, F - 1] = 1
    t_mat[k, T - 1] = 1

C = f_mat.to_csc() - t_mat.to_csc()        # branch incidence
A = C.t() * C                              # bus adjacency (SpGEMM)
print("islands:", A.islands())             # -> one island of 5 buses

# --- beyond the reference: solve the IEEE 14-bus system -------------------
grid, perm = rcm_grid(ieee14())            # RCM renumbering -> banded Ybus

# gather-free banded path: DIA split-complex SpMV + banded matmul trisolves
fd = FastDecoupled(grid, spmv="dia", solver="banded", tol=1e-10)
vm, va, iters, res = fd.solve()
print(f"fast-decoupled: {iters} iterations, residual {res:.2e}")

npf = NewtonPowerFlow(grid, spmv="dia")
vm2, va2, it2, res2 = npf.solve()
print(f"newton (device refactorization): {it2} iterations, residual {res2:.2e}")

np.testing.assert_allclose(vm, vm2, atol=1e-6)
print("voltage magnitudes (original numbering):",
      np.round(vm2[np.argsort(perm)], 4)[:5], "...")
