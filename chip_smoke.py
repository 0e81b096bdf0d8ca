"""Run the library's main path once on the GPU and check every result.

    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --cards 4   # four cards: config 5 only

One card runs, through the public entry points and at sizes that
power-system users run:

  device     the platform is a GPU; card name and power limit; the native
             host extension built and loaded; the compile-cache directory
  gridcal    the GridCal flow (SURVEY §3.1) on a 10k-bus grid: incidence
             by from_triplets and LilMat, A = C.t() * C through the SpGEMM
             plan, islands, Ybus, and the split-complex SpMV at 200k buses
  spgemm     config 2: C = A A^T for a random 10k x 10k CSC at 0.1 %
             density and the 3k-bus connectivity gram, through
             SpGEMMPlan.numeric and GramPlan
  lu10k      config 3: splu + a 64-RHS device solve plan, and
             MultifrontalLU from scratch, on a 10k-bus B'
  solve100k  config 4: BandedLU.factor_device on a 100k-bus B', then one
             1024-RHS solve
  newton10k  Newton power flow (multifrontal device refactorization) on a
             10k-bus grid

``--cards 4`` runs config 5 alone: DistBandedLU.factor_device and a solve
of the RCM-ordered 1M-bus B' on a 1-D mesh of the four cards, then the
halo-ring dist_spmv and a block-Jacobi dist_cg on a 200k-bus B', and each
card's peak memory.

Device math is f32 (x64 off, JAX's default).  Every phase prints one line
with its size, wall time, largest error against its reference (scipy, or a
residual computed in f64 on the host) and that error's tolerance.  A phase
that fails raises: the script then exits non-zero and prints no ok line.
The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

import csparse3_jax as cst  # outside the repository this import fails


class PhaseError(AssertionError):
    """A phase's result is outside its tolerance."""


def _report(name, size, t0, err, tol, laps=None):
    dt = time.perf_counter() - t0
    split = "".join(f", {k} {v:.2f} s" for k, v in (laps or {}).items())
    print(f"[{name}] {size}  wall {dt:.2f} s{split}  max err {err:.3e}  "
          f"tol {tol:.0e}", flush=True)
    if not (np.isfinite(err) and err <= tol):
        raise PhaseError(f"{name}: error {err:.3e} above tolerance {tol:.0e}")
    return {"phase": name, "size": size, "wall_s": dt, "err": err,
            "tol": tol}


def _rel(got, ref):
    """max |got - ref| / max |ref| over dense or scipy-sparse operands."""
    d = got - ref
    num = abs(d).max() if sp.issparse(d) else np.abs(d).max()
    den = abs(ref).max() if sp.issparse(ref) else np.abs(ref).max()
    return float(num / max(den, 1e-300))


def _resid(a_sp, x, b):
    """Largest per-column relative residual ||A x - b|| / ||b||, in f64."""
    x = np.asarray(x, np.float64).reshape(len(b), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    r = a_sp @ x - b
    return float(np.max(np.linalg.norm(r, axis=0)
                        / np.maximum(np.linalg.norm(b, axis=0), 1e-300)))


def bprime(n, seed):
    """The B' test matrix of configs 3-5: synthetic-grid susceptances plus
    3 I, as a CSC (bench.py builds the same)."""
    from csparse3_jax.models.grids import synthetic_grid

    g = synthetic_grid(n, seed=seed)
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    return cst.add(cst.from_triplets(rows, cols, vals, (n, n)),
                   cst.diags(np.full(n, 3.0)))


def parse_nvidia_smi(text):
    """[(name, power limit in W)] from ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` output."""
    cards = []
    for line in text.strip().splitlines():
        name, limit = (f.strip() for f in line.rsplit(",", 1))
        cards.append((name, float(limit.split()[0])))
    if not cards:
        raise ValueError("nvidia-smi listed no card")
    return cards


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(cards=1):
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise PhaseError(f"no GPU: JAX runs on {d0.platform} ({d0})")
    if len(devs) < cards:
        raise PhaseError(f"{cards} cards asked for, JAX sees {len(devs)}")
    print(f"[device] platform {d0.platform}  kind {d0.device_kind}  "
          f"count {len(devs)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    parse_nvidia_smi(smi)
    print(smi.strip(), flush=True)

    from csparse3_jax.native import host_ext  # builds on first import

    print(f"[device] native host extension loaded: {host_ext._LIB_PATH}",
          flush=True)
    from csparse3_jax.utils.compile_cache import enable_compile_cache

    print(f"[device] compile cache: {enable_compile_cache()}", flush=True)
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


def phase_gridcal(n_bus=10_000, n_spmv=200_000):
    """SURVEY §3.1: incidence, adjacency by SpGEMM, islands, Ybus, SpMV."""
    from scipy.sparse.csgraph import connected_components

    from csparse3_jax.models.grids import (
        branch_admittances, synthetic_grid, ybus)
    from csparse3_jax.ops.spgemm import spgemm_symbolic

    t0 = time.perf_counter()
    g = synthetic_grid(n_bus, seed=0)
    m, n = g.n_branch, g.n_bus
    br = np.arange(m)
    C = (cst.from_triplets(br, g.f, np.ones(m), (m, n))
         - cst.from_triplets(br, g.t, np.ones(m), (m, n)))
    f_mat, t_mat = cst.LilMat(m, n), cst.LilMat(m, n)
    for k in range(m):
        f_mat[k, int(g.f[k])] = 1
        t_mat[k, int(g.t[k])] = 1
    C_lil = f_mat.to_csc() - t_mat.to_csc()
    Cs = (sp.csr_matrix((np.ones(m), (br, g.f)), (m, n))
          - sp.csr_matrix((np.ones(m), (br, g.t)), (m, n))).tocsc()
    err = max(_rel(C.to_scipy(), Cs), _rel(C_lil.to_scipy(), Cs))

    # bus adjacency A = C^T C: the host product, then the device numeric
    # pass of the reusable SpGEMM plan (f32 values)
    ref = (Cs.T @ Cs).tocsc()
    A = C.t() * C
    err = max(err, _rel(A.to_scipy(), ref))
    Ct = C.t()
    plan = spgemm_symbolic(Ct, C)
    f32 = lambda M: jnp.asarray(np.asarray(M.np_arrays()[2], np.float32))
    A_dev = jax.jit(plan.numeric)(f32(Ct), f32(C))
    err = max(err, _rel(A_dev.to_scipy(), ref))

    # islands: exact match with scipy's connected components
    isl = A.islands()
    ncomp, lab = connected_components(ref, directed=False)
    ref_isl = sorted(tuple(np.flatnonzero(lab == c)) for c in range(ncomp))
    if sorted(tuple(np.asarray(i)) for i in isl) != ref_isl:
        raise PhaseError("gridcal: islands differ from scipy's components")

    # Ybus against MATPOWER's formula assembled in scipy
    Y, _, _ = ybus(g)
    yff, yft, ytf, ytt = branch_admittances(g)
    Cf_s = sp.csr_matrix((np.ones(m), (br, g.f)), (m, n))
    Ct_s = sp.csr_matrix((np.ones(m), (br, g.t)), (m, n))
    Yf = sp.diags(yff) @ Cf_s + sp.diags(yft) @ Ct_s
    Yt = sp.diags(ytf) @ Cf_s + sp.diags(ytt) @ Ct_s
    Y_ref = Cf_s.T @ Yf + Ct_s.T @ Yt + sp.diags(g.gs + 1j * g.bs)
    err = max(err, _rel(Y.to_scipy(), Y_ref.tocsc()))
    size = f"{n_bus} buses, {m} branches, A nnz {ref.nnz}"
    out = [_report("gridcal", size, t0, err, 1e-5)]

    # split-complex SpMV at the bench's headline size
    t0 = time.perf_counter()
    Y2, _, _ = ybus(synthetic_grid(n_spmv, seed=0))
    plan = cst.SplitSpMV(Y2)
    rng = np.random.RandomState(0)
    xr = rng.rand(n_spmv).astype(np.float32)
    xi = rng.rand(n_spmv).astype(np.float32)
    yr, yi = jax.jit(lambda p, a, b: p(a, b))(plan, xr, xi)
    y = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
    y_ref = Y2.to_scipy().tocsr() @ (xr.astype(np.float64)
                                    + 1j * xi.astype(np.float64))
    out.append(_report("gridcal-spmv", f"{n_spmv} buses, nnz {Y2.nnz}",
                       t0, _rel(y, y_ref), 1e-5))
    return out


def phase_spgemm(n_rand=10_000, density=1e-3, n_bus=3000):
    """Config 2: C = A A^T through SpGEMMPlan.numeric and GramPlan."""

    from csparse3_jax.models.grids import connectivity, synthetic_grid
    from csparse3_jax.ops.spgemm import gram_symbolic, spgemm_symbolic

    t0 = time.perf_counter()
    a_rand = sp.random(n_rand, n_rand, density=density, format="csc",
                       random_state=np.random.RandomState(0))
    Cf, Ct = connectivity(synthetic_grid(n_bus, seed=1))
    cases = [(f"random {n_rand}^2 at {density:g}",
              cst.CSC.from_scipy(a_rand)),
             (f"{n_bus}-bus connectivity", Cf - Ct)]
    err, sizes = 0.0, []
    for label, A in cases:
        As = A.to_scipy()
        ref = (As @ As.T).tocsc()
        At = A.t()
        vals = lambda M: jnp.asarray(
            np.asarray(M.np_arrays()[2], np.float32))
        gen = spgemm_symbolic(A, At)
        got = jax.jit(gen.numeric)(vals(A), vals(At))
        err = max(err, _rel(got.to_scipy(), ref))
        gp = gram_symbolic(A)
        got = jax.jit(gp.numeric)(vals(A))
        err = max(err, _rel(got.to_scipy(), ref))
        sizes.append(f"{label} (C nnz {ref.nnz})")
    return [_report("spgemm", "; ".join(sizes), t0, err, 1e-5)]


def phase_lu10k(n=10_000, rhs=64):
    """Config 3: splu with a device solve plan, and MultifrontalLU."""
    import scipy.sparse.linalg as spla

    from csparse3_jax.linalg import MultifrontalLU, splu

    t0 = time.perf_counter()
    laps, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        laps[name] = time.perf_counter() - t
        t = time.perf_counter()

    A = bprime(n, seed=1)
    a_sp = A.to_scipy().tocsc()
    B = np.random.RandomState(1).rand(n, rhs).astype(np.float32)
    lu = splu(A)
    plan = lu.solve_plan()
    lap("splu+plan")
    X = jax.block_until_ready(
        jax.jit(lambda p, b: p(b))(plan, jnp.asarray(B)))
    lap("solve (compile+run)")
    err = _resid(a_sp, X, B)
    # the host reference solver meets the same bound in f64
    err_ref = _resid(a_sp, spla.spsolve(a_sp, B.astype(np.float64)), B)

    mf = MultifrontalLU.from_matrix(A)
    data = np.asarray(A.np_arrays()[2], np.float32)
    lap("multifrontal symbolic")

    @jax.jit
    def factor_solve(p, d, b):
        fac, stats = p.factor_piv(d)
        return p.solve_piv(fac, b), stats["min_pivot"]

    x, min_piv = jax.block_until_ready(
        factor_solve(mf, jnp.asarray(data), jnp.asarray(B[:, 0])))
    lap("multifrontal factor+solve (compile+run)")
    err = max(err, _resid(a_sp, x, B[:, 0]), err_ref)
    if not float(min_piv) > 0:
        raise PhaseError(f"lu10k: multifrontal min pivot {float(min_piv)}")
    return [_report("lu10k", f"{n} buses, {rhs} RHS, fill "
                    f"{lu.lnz + lu.unz}", t0, err, 1e-4, laps)]


def phase_solve100k(n=100_000, rhs=1024):
    """Config 4: device block-Thomas factor, then one many-RHS solve."""

    from csparse3_jax.linalg import BandedLU

    t0 = time.perf_counter()
    A = bprime(n, seed=1)
    lu, _rf = BandedLU.factor_device(A)
    B = np.random.RandomState(1).rand(n, rhs).astype(np.float32)
    X = np.asarray(jax.jit(lambda p, b: p(b))(lu, jnp.asarray(B)))
    err = _resid(A.to_scipy().tocsr(), X, B)
    return [_report("solve100k", f"{n} buses, {rhs} RHS, s {lu.s}, "
                    f"bw {lu.bw}", t0, err, 1e-4)]


def phase_newton10k(n=10_000):
    """Newton power flow on device; the AC mismatch rebuilt in scipy."""

    from csparse3_jax.models.grids import synthetic_grid, ybus
    from csparse3_jax.models.powerflow import NewtonPowerFlow, sbus

    t0 = time.perf_counter()
    g = synthetic_grid(n, seed=3)
    # f32 device math: the stopping tolerance sits above the f32
    # mismatch floor; the host-rebuilt gate below is 1e-4
    pf = NewtonPowerFlow(g, tol=5e-5, solver="multifrontal")
    laps = {"build": time.perf_counter() - t0}
    sb = sbus(g)
    t = time.perf_counter()
    vm, va, it, _res, _bad = jax.block_until_ready(
        jax.jit(NewtonPowerFlow.run_fn)(
            pf, jnp.asarray(g.vm0), jnp.zeros(n), jnp.asarray(sb.real),
            jnp.asarray(sb.imag)))
    laps["solve (compile+run)"] = time.perf_counter() - t
    Y, _, _ = ybus(g)
    v = (np.asarray(vm, np.float64)
         * np.exp(1j * np.asarray(va, np.float64)))
    mis = v * np.conj(Y.to_scipy().tocsr() @ v) - sb
    pvpq = np.concatenate([g.pv, g.pq])
    err = float(max(np.abs(mis.real[pvpq]).max(),
                    np.abs(mis.imag[g.pq]).max()))
    return [_report("newton10k", f"{n} buses, {int(it)} iterations",
                    t0, err, 1e-4, laps)]


def phase_config5(devices, n_lu=1_000_000, n_ring=200_000):
    """Config 5 on a 1-D mesh of ``devices``: distributed banded LU of the
    RCM-ordered B', ring SpMV and block-Jacobi CG; per-card memory."""
    from jax.sharding import Mesh

    from csparse3_jax.linalg.ordering import rcm
    from csparse3_jax.parallel import (
        BlockJacobi, DistBandedLU, dist_cg, dist_spmv, partition_rows)

    mesh = Mesh(np.array(devices), ("rows",))
    S = len(devices)
    out = []

    t0 = time.perf_counter()
    A0 = bprime(n_lu, seed=0)
    p = rcm(A0)
    A = A0[p, p]
    dk = DistBandedLU.factor_device(A, mesh=mesh, ordering=None)
    b = np.random.RandomState(3).rand(n_lu).astype(np.float32)
    x = np.asarray(dk(b))
    err = _resid(A.to_scipy().tocsr(), x, b)
    held = {s.device for s in dk._sinv.addressable_shards}
    if held != set(devices):
        raise PhaseError(f"config5: factor shards on {held}, "
                         f"mesh is {set(devices)}")
    out.append(_report("config5-lu", f"{n_lu} buses on {S} cards, "
                       f"s {dk.s}, bw {dk.bw}", t0, err, 1e-4))

    t0 = time.perf_counter()
    A0 = bprime(n_ring, seed=1)
    p = rcm(A0)
    A = A0[p, p]
    a_sp = A.to_scipy().tocsr()
    part = partition_rows(A, S)
    xv = np.linspace(0.0, 1.0, n_ring, dtype=np.float32)
    y = np.asarray(dist_spmv(part, jnp.asarray(xv), mesh))[:n_ring]
    err = _rel(y.astype(np.float64), a_sp @ xv.astype(np.float64))
    out.append(_report("config5-spmv", f"{n_ring} buses, {part.strategy} "
                       f"k={part.k}", t0, err, 1e-5))

    t0 = time.perf_counter()
    prec = BlockJacobi.build(A, part)
    rhs = np.ones(n_ring)  # device dtype follows the matrix (f32, x64 off)
    xs, _res, it = dist_cg(part, jnp.asarray(rhs), mesh, prec=prec,
                           tol=1e-6, maxiter=200)
    err = _resid(a_sp, np.asarray(xs)[:n_ring], rhs)
    out.append(_report("config5-cg", f"{n_ring} buses, {int(it)} "
                       f"iterations", t0, err, 1e-4))

    stats = [d.memory_stats() for d in devices]
    if all(s is not None for s in stats):
        peaks = [int(s["peak_bytes_in_use"]) for s in stats]
        for d, pk in zip(devices, peaks):
            print(f"[config5] {d} peak_bytes_in_use {pk}", flush=True)
        if min(peaks) <= 0 or (S > 1 and peaks[0] > 0.5 * sum(peaks)):
            raise PhaseError(f"config5: unbalanced peak memory {peaks}")
    elif devices[0].platform == "gpu":
        raise PhaseError("config5: memory_stats unavailable on the GPU")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run config 5 across four cards, nothing else")
    args = ap.parse_args(argv)

    device = phase_device(args.cards)
    if args.cards == 4:
        phase_config5(jax.devices()[:4])
    else:
        phase_gridcal()
        phase_spgemm()
        phase_lu10k()
        phase_solve100k()
        phase_newton10k()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
