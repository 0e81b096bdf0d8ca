"""Config-5 demo: distributed SpMV + solves on a 1M-node grid.

Runs on the devices JAX finds (the GPUs of one host), or on a virtual
8-device CPU mesh when JAX_PLATFORMS=cpu asks for it:

    JAX_PLATFORMS=cpu python examples/dist_1m_grid.py
    python examples/dist_1m_grid.py                      # on the GPUs

Everything is verified against scipy on the host.  Four stages:
1. halo-ring SpMV of the RCM-ordered 1M-bus B' matrix (ring k hops =
   band radius / shard size; compute overlaps the ppermute exchanges);
2. point-Jacobi preconditioned distributed BiCGSTAB solve of the
   regularized B' system;
3. SPIKE distributed DIRECT solve (parallel.DistBandedLU) on a 1M
   narrow-band case: per-shard block-Thomas factors + one all_gather of
   the interface blocks per solve;
4. the real wide-band B' (bandwidth ~2453 after RCM) factored ON the
   mesh devices by ``DistBandedLU.factor_device`` and solved.
Timings on the GPUs: not measured here (chip_smoke.py --cards 4 runs the
config-5 phases with their checks).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    # virtual mesh: 8 CPU devices (effective before JAX initializes)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import numpy as np  # noqa: E402
import jax  # noqa: E402

if jax.devices()[0].platform == "cpu":
    jax.config.update("jax_enable_x64", True)  # exact f64 oracles
import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import csparse3_jax as cst  # noqa: E402
from csparse3_jax.linalg.ordering import rcm  # noqa: E402
from csparse3_jax.models.grids import synthetic_grid  # noqa: E402
from csparse3_jax.parallel import (  # noqa: E402
    dist_bicgstab, dist_spmv, partition_rows,
)
from csparse3_jax.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)


def main():
    enable_compile_cache()
    n = 1_000_000
    S = len(jax.devices())
    print(f"== config-5 demo: n={n}, {S}-way mesh ==", flush=True)
    g = synthetic_grid(n, seed=0)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    B = cst.from_triplets(rows, cols, vals, (n, n))
    Breg = cst.add(B, cst.diags(np.full(n, 3.0)))
    perm = rcm(Breg)
    A = Breg[perm, perm]
    a_sp = A.to_scipy().tocsr()
    print(f"B' built: nnz={A.nnz}", flush=True)

    t0 = time.time()
    part = partition_rows(A, S)
    print(f"partition: {time.time() - t0:.2f}s  strategy={part.strategy} "
          f"k={part.k}", flush=True)

    mesh = Mesh(np.array(jax.devices()[:S]), ("rows",))
    x = np.random.RandomState(0).rand(n)
    with mesh:
        y = dist_spmv(part, jnp.asarray(x), mesh)
        jax.block_until_ready(y)
        t0 = time.time()
        y = dist_spmv(part, jnp.asarray(x), mesh)
        jax.block_until_ready(y)
        t_spmv = time.time() - t0
    err = np.abs(np.asarray(part.trim_vector(y)) - a_sp @ x).max()
    print(f"dist SpMV: {t_spmv * 1e3:.1f} ms  max err {err:.2e}", flush=True)
    assert err < 1e-8

    # point-Jacobi, NOT BlockJacobi: per-shard direct factors of the
    # wide-band B' fill at n_loc x bandwidth (~113M nnz per 125k-row
    # shard); the diagonal preconditioner stores one vector and the
    # +3.0 shunt regularization keeps BiCGSTAB convergent
    from csparse3_jax.parallel import DiagJacobi

    prec = DiagJacobi.build(A, part)
    b = np.random.RandomState(1).rand(n)
    with mesh:
        t0 = time.time()
        xs, res, it = dist_bicgstab(part, b, mesh, prec=prec, tol=1e-8,
                                    maxiter=50)
        t_solve = time.time() - t0
    rel = np.linalg.norm(a_sp @ np.asarray(xs) - b) / np.linalg.norm(b)
    print(f"dist BiCGSTAB: {t_solve:.2f}s  iters={int(it)}  "
          f"rel res {rel:.2e}", flush=True)
    assert rel < 1e-6

    # SPIKE distributed direct solve on a 1M narrow-band system
    from csparse3_jax.parallel import DistBandedLU

    d1 = -np.ones(n - 1)
    d16 = -0.5 * np.ones(n - 16)
    band = sp.diags([d16, d1, 4.0 * np.ones(n), d1, d16],
                    [-16, -1, 0, 1, 16]).tocsc()
    Aband = cst.CSC.from_scipy(band)
    t0 = time.time()
    klu = DistBandedLU(Aband, mesh=mesh, ordering=None, s=128)
    t_fac = time.time() - t0
    bb = np.random.RandomState(2).rand(n)
    with mesh:
        t0 = time.time()
        xd = np.asarray(klu(bb))
        t_ds = time.time() - t0
    rel = np.linalg.norm(band @ xd - bb) / np.linalg.norm(bb)
    print(f"SPIKE direct (band, {S}-way): factor {t_fac:.1f}s  "
          f"solve {t_ds:.2f}s  rel res {rel:.2e}", flush=True)
    assert rel < 1e-6

    # stage 4: the REAL wide-band B' (bandwidth ~2453, s=2560), factored
    # ON the mesh devices — SPIKE v2 (parallel/banded.py factor_device):
    # symmetric block-Thomas scan + tip-only spike recurrences, ~21 GB
    # of factor state in all.  This executes config-5's "distributed LU
    # factor + solve" end-to-end at 1M.
    import json
    import resource

    t0 = time.time()
    dk = DistBandedLU.factor_device(A, mesh=mesh, ordering=None)
    jax.block_until_ready((dk._sinv, dk._uhat, dk._r_si))
    t_wfac = time.time() - t0
    with mesh:
        t0 = time.time()
        xw = np.asarray(dk(bb))
        t_ws = time.time() - t0
        t0 = time.time()
        xw = np.asarray(dk(bb))
        t_ws2 = time.time() - t0
    rel_w = np.linalg.norm(a_sp @ xw - bb) / np.linalg.norm(bb)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"SPIKE factor_device (wide-band B', {S}-way): factor {t_wfac:.1f}s"
          f"  solve {t_ws:.2f}s (warm {t_ws2:.2f}s)  rel res {rel_w:.2e}"
          f"  s={dk.s} bw={dk.bw}  maxrss {rss:.1f} GB", flush=True)
    rec = {"n": n, "P": S, "bw": int(dk.bw), "s": int(dk.s),
           "factor_s": round(t_wfac, 1), "solve_s": round(t_ws2, 2),
           "rel_resid": float(rel_w), "maxrss_gb": round(rss, 1),
           "devices": f"{S} x {jax.devices()[0].device_kind}"}
    print(json.dumps(rec), flush=True)
    assert rel_w < 1e-4
    print("CONFIG-5 DEMO PASSED", flush=True)


if __name__ == "__main__":
    main()
