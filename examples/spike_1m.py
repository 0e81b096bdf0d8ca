"""Config 5 at full scale on ONE device: the 1M-node B' factored and
solved via StreamedSPIKE (chunk-rematerialized out-of-core SPIKE).

All P SPIKE chunks stream through the one device's memory (~6 GB
transient per chunk visit; factors rematerialized in pass 2).  The
distributed path over four cards is ``chip_smoke.py --cards 4``.
Timings: not measured on the H100 yet.

Run:  python examples/spike_1m.py [P] [s]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(P=8, s=2560):
    import jax

    import csparse3_jax as cst
    from csparse3_jax.utils.compile_cache import enable_compile_cache
    from csparse3_jax.linalg import StreamedSPIKE
    from csparse3_jax.linalg.ordering import rcm
    from csparse3_jax.models.grids import synthetic_grid

    enable_compile_cache()
    print(f"devices: {jax.devices()}", flush=True)
    N = 1_000_000
    t0 = time.perf_counter()
    g = synthetic_grid(N, seed=0)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    A0 = cst.add(cst.from_triplets(rows, cols, vals, (N, N)),
                 cst.diags(np.full(N, 3.0)))
    perm = rcm(A0)
    A = A0[perm, perm]
    t_build = time.perf_counter() - t0
    print(f"1M B' built + RCM: {t_build:.1f}s nnz={A.nnz}", flush=True)

    t0 = time.perf_counter()
    sk = StreamedSPIKE(A, P=P, ordering=None, s=s)
    t_sym = time.perf_counter() - t0
    print(f"symbolic (chunk maps): {t_sym:.1f}s  "
          f"(P={sk.P} m={sk.m} s={sk.s} bw={sk.bw})", flush=True)

    b = np.random.RandomState(3).rand(N).astype(np.float32)
    # solve #1 includes compile of the two chunk programs
    t0 = time.perf_counter()
    x = sk(b)
    t_first = time.perf_counter() - t0
    a_sp = A.to_scipy().tocsr()
    res = float(np.linalg.norm(a_sp @ x.astype(np.float64) - b)
                / np.linalg.norm(b))
    print(f"factor+solve #1 (incl. compile): {t_first:.1f}s "
          f"rel resid {res:.2e}", flush=True)

    # solve #2: warm — the factor+solve number without compilation
    # (tips/reduced cached; both chunk passes still refactor)
    b2 = np.random.RandomState(4).rand(N).astype(np.float32)
    t0 = time.perf_counter()
    x2 = sk(b2)
    t_warm = time.perf_counter() - t0
    res2 = float(np.linalg.norm(a_sp @ x2.astype(np.float64) - b2)
                 / np.linalg.norm(b2))
    print(f"factor+solve #2 (warm): {t_warm:.1f}s rel resid {res2:.2e}",
          flush=True)

    rec = {"n": N, "P": int(sk.P), "m": int(sk.m), "s": int(sk.s),
           "bw": int(sk.bw), "build_s": t_build, "sym_s": t_sym,
           "first_s": t_first, "warm_s": t_warm,
           "resid1": res, "resid2": res2,
           "device": str(jax.devices()[0])}
    print(json.dumps(rec), flush=True)
    assert res2 < 1e-4


if __name__ == "__main__":
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    s = int(sys.argv[2]) if len(sys.argv) > 2 else 2560
    main(P, s)
