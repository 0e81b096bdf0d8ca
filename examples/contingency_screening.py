"""N-1 DC contingency screening on one device.

Factor the base case once, then every branch outage is a device numeric
refactorization + solve, vmapped — the whole sweep is one compiled
program (models/contingency.py).  Run: python examples/contingency_screening.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

from csparse3_jax.models.contingency import DCContingency
from csparse3_jax.models.grids import synthetic_grid
from csparse3_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

grid = synthetic_grid(1000, seed=4)
ca = DCContingency(grid)
print(f"{grid.n_bus} buses, {ca.n_branch} branches")

base = ca.base_theta()
K = min(512, ca.n_branch)
ca.run(np.arange(K), batch=64)  # compile
t0 = time.perf_counter()
flows, theta, ok = ca.run(np.arange(K), batch=64)
dt = time.perf_counter() - t0
print(f"{K} contingencies in {dt:.3f}s -> {K/dt:.0f} scenarios/s")
print(f"islanding outages detected: {int((~ok).sum())}")

# worst post-contingency loading vs the base case
base_flow = np.abs((base[grid.f] - base[grid.t]) / grid.x)
worst = np.abs(flows[ok]).max(axis=0)
overload = worst / np.maximum(base_flow, 1e-9)
top = np.argsort(overload)[-5:][::-1]
print("top-5 post-contingency flow increases (branch: ratio):")
for b in top:
    print(f"  branch {b}: {overload[b]:.2f}x base")
