"""Conjugate-gradient solvers (matrix-free, jittable, scan-friendly).

The large-mesh path: the pressure-Poisson and viscous systems are SPD (with
periodic DOF-merging instead of the reference's CG-hostile ±1e10 penalty —
SURVEY.md §7.3), so CG with a Jacobi preconditioner and optional constant-
nullspace deflation replaces dense solves.

Two drivers:

* :func:`cg` — tolerance-controlled ``lax.while_loop`` (fast exit),
* :func:`cg_fixed` — fixed iteration count under ``lax.scan`` so the whole
  timestep compiles to a static program (preferred inside scan bodies; the
  returned residual norm is still reported for observability).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


def _vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Inner product at full f32 precision (no TF32 rounding on the GPU)."""
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def _deflate(x: jnp.ndarray, weights: jnp.ndarray | None) -> jnp.ndarray:
    """Project out the nullspace component along ``weights`` (default: the
    constant vector).  This is an orthogonal projection x − (v·x/v·v)v —
    NOT a global mean shift, which would contaminate entries outside the
    support of v (e.g. merged-out slave dofs)."""
    if weights is None:
        return x - jnp.mean(x)
    return x - (_vdot(weights, x) / _vdot(weights, weights)) * weights


def cg(
    matvec: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    tol: float = 1e-10,
    maxiter: int = 1000,
    precond: Callable | None = None,
    deflate: bool = False,
    deflate_weights: jnp.ndarray | None = None,
):
    """Preconditioned CG; returns (x, info) with info = (iters, resnorm)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    M = precond if precond is not None else (lambda r: r)

    def project(v):
        return _deflate(v, deflate_weights) if deflate else v

    b = project(b)
    r0 = project(b - matvec(x0))
    z0 = project(M(r0))
    p0 = z0
    rz0 = _vdot(r0, z0)
    bnorm = jnp.linalg.norm(b)
    atol2 = (tol * jnp.maximum(bnorm, 1e-30)) ** 2

    def cond(state):
        x, r, p, rz, k = state
        return jnp.logical_and(k < maxiter, _vdot(r, r) > atol2)

    def body(state):
        x, r, p, rz, k = state
        Ap = project(matvec(p))
        alpha = rz / _vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        # deflate the preconditioned direction, matching cg_fixed — roundoff
        # along the nullspace otherwise drives p·Ap → 0 and alpha explodes
        z = project(M(r))
        rz_new = _vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (project(x) if deflate else x, r, p, rz_new, k + 1)

    x, r, p, rz, k = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    return x, (k, jnp.linalg.norm(r))


def cg_fixed(
    matvec: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    iters: int = 100,
    precond: Callable | None = None,
    deflate: bool = False,
    deflate_weights: jnp.ndarray | None = None,
):
    """CG with a static iteration count (scan-friendly). Returns (x, resnorm)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    M = precond if precond is not None else (lambda r: r)

    def project(v):
        return _deflate(v, deflate_weights) if deflate else v

    b = project(b)
    r0 = project(b - matvec(x0))
    z0 = project(M(r0))
    rz0 = _vdot(r0, z0)

    def body(state, _):
        x, r, p, rz = state
        Ap = project(matvec(p))
        denom = _vdot(p, Ap)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        # the preconditioned direction must be deflated too — otherwise
        # roundoff along the nullspace makes p·Ap → 0 and alpha explodes
        z = project(M(r))
        rz_new = _vdot(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, r, _, _), _ = jax.lax.scan(body, (x0, r0, z0, rz0), None, length=iters)
    return (project(x) if deflate else x), jnp.linalg.norm(r)


def jacobi_pcg(matvec, diag, b, **kwargs):
    """CG preconditioned with the operator diagonal."""
    inv_diag = jnp.where(diag != 0, 1.0 / diag, 1.0)
    return cg(matvec, b, precond=lambda r: inv_diag * r, **kwargs)


def chebyshev_preconditioner(matvec, inv_diag, lmax: float, degree: int = 4,
                             lmin_frac: float = 0.06):
    """Fixed-degree Chebyshev approximate inverse of the Jacobi-scaled
    operator — a *linear, SPD* preconditioner for CG.

    Runs ``degree`` Chebyshev iterations for A z = r (A pre-scaled by the
    inverse diagonal) targeting the spectrum [lmin_frac·λmax, λmax].  One
    application costs ``degree`` matvecs but damps the high end of the
    spectrum far better than plain Jacobi, cutting outer CG iterations on
    large ill-conditioned meshes.
    """
    lmax = float(lmax)
    lmin = lmin_frac * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def scaled_mv(v):
        return inv_diag * matvec(v)

    def M(r):
        rs = inv_diag * r
        z = rs / theta
        if degree == 1:
            return z
        d = z
        sigma = theta / delta
        rho_old = 1.0 / sigma
        resid = rs - scaled_mv(z)
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = rho * rho_old * d + (2.0 * rho / delta) * resid
            z = z + d
            resid = resid - scaled_mv(d)
            rho_old = rho
        return z

    return M


def estimate_lmax(matvec, inv_diag, n: int, iters: int = 25, seed: int = 0):
    """Power-iteration estimate of λmax of the Jacobi-scaled operator
    (host/build-time; returns a float with a 5% safety margin)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.standard_normal(n))
    lam = 1.0
    for _ in range(iters):
        w = inv_diag * matvec(v)
        lam = jnp.linalg.norm(w)
        v = w / (lam + 1e-30)
    lam = float(lam)
    # loud failure beats a silent NaN ω poisoning every later solve
    # (the smoother damping 1/λmax feeds all preconditioner paths)
    assert np.isfinite(lam) and lam > 0, (
        f"power iteration returned λmax={lam} — operator or device fault"
    )
    return lam * 1.05


def bicgstab_fixed(
    matvec: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    iters: int = 100,
    precond: Callable | None = None,
    tol: float = 0.0,
):
    """BiCGStab with a static iteration count (scan-friendly) for
    NON-symmetric systems (per-step advection operators).  Right-
    preconditioned; returns (x, residual_norm).  ``tol > 0`` switches to
    a ``while_loop`` with relative-residual early exit (``iters`` becomes
    the cap) — for one-shot large solves, not scan bodies."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    M = precond if precond is not None else (lambda r: r)

    r0 = b - matvec(x0)
    rhat = r0

    def fin(v):
        # finite-or-zero: ratios at BiCGStab breakdown (ρ or ω denormal —
        # which accelerators may flush to zero in f32 — or overflowing) poison every
        # later iterate with inf/NaN; a zeroed step degrades to "no
        # progress this iteration" instead.  Bit-exact when healthy.
        return jnp.where(jnp.isfinite(v), v, jnp.zeros_like(v))

    def body(state, _):
        x, r, p, v, rho, alpha, omega = state
        rho_new = _vdot(rhat, r)
        beta = fin(jnp.where(
            (rho != 0) & (omega != 0), (rho_new / rho) * (alpha / omega), 0.0
        ))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        denom = _vdot(rhat, v)
        alpha = fin(jnp.where(denom != 0, rho_new / denom, 0.0))
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        tt = _vdot(t, t)
        omega = fin(jnp.where(tt != 0, _vdot(t, s) / tt, 0.0))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega), None

    zeros = jnp.zeros_like(b)
    one = jnp.asarray(1.0, dtype=b.dtype)
    st0 = (x0, r0, zeros, zeros, one, one, one)
    if tol > 0:
        atol2 = (tol * jnp.maximum(jnp.linalg.norm(b), 1e-30)) ** 2

        def cond(st):
            state, k = st
            return jnp.logical_and(
                k < iters, _vdot(state[1], state[1]).real > atol2
            )

        def wbody(st):
            state, k = st
            return body(state, None)[0], k + 1

        (x, r, *_), _ = jax.lax.while_loop(cond, wbody, (st0, jnp.int32(0)))
        return x, jnp.linalg.norm(r)
    (x, r, *_), _ = jax.lax.scan(body, st0, None, length=iters)
    return x, jnp.linalg.norm(r)
