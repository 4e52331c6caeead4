"""Matrix-free solvers for the large-mesh regime.

The dense fast path caps out around N ≈ 4k nodes (O(N²) matvecs, O(N³)
host factorization).  Beyond that, systems are solved with
Jacobi-preconditioned CG over static-pattern CSR operators — O(nnz)
per application, O(N) memory — the scaling path SURVEY.md §7 calls for
(the reference itself cannot scale past ~1k nodes).

* :class:`ViscousCG` — (I + Δt·ν·K) with the reference's symmetric
  Dirichlet row+column surgery expressed as masking:
      A(x) = m ∘ (x + Δt·ν·K(m ∘ x)) + (1−m) ∘ x,  m = interior mask.
* :class:`PressureCG` — the periodic pressure Poisson in merged symmetric
  weak form.  Note (K/M_L) p = b  ⟺  K p = M_L ∘ b row-by-row, so this is
  the same system the reference solves (StokesColor.py:478); the DOF-merge
  sums the *unscaled* rows (weak-consistent, SPD), which differs from the
  penalty limit only in the mass weighting of the merged boundary-pair
  equations.  The constant nullspace is handled by deflation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.solve.cg import cg_fixed


def _solve_columns(matvec, b, x0=None, tol: float = 0.0, **kw):
    """Batched CG: one iteration stream drives all columns of b (N, k)
    simultaneously (per-column step lengths), instead of k separate CG
    runs — halves the SpMV count for the (uₓ, u_y) viscous solve.

    ``x0`` warm-starts the iteration; ``tol > 0`` switches to a
    ``while_loop`` that exits once EVERY column's residual drops below
    tol·‖b_col‖ (``iters`` becomes the cap) — near steady state a
    warm-started solve finishes in a handful of iterations instead of
    the full fixed count."""
    if b.ndim == 1:
        if tol > 0:
            from tpufem.solve.cg import cg

            x, _ = cg(matvec, b, x0=x0, tol=tol, maxiter=kw.pop("iters"),
                      precond=kw.pop("precond", None))
            return x
        x, _ = cg_fixed(matvec, b, x0=x0, **kw)
        return x
    iters = kw.pop("iters")
    precond = kw.pop("precond", None)
    M = precond if precond is not None else (lambda r: r)

    def colsum(a, c):
        return jnp.sum(a * c, axis=0)  # (k,)

    mv = lambda x: jax.vmap(matvec, in_axes=1, out_axes=1)(x)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - mv(x0)
    z0 = M(r0)
    rz0 = colsum(r0, z0)

    def advance(x, r, p, rz):
        ap = mv(p)
        denom = colsum(p, ap)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = colsum(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    if tol > 0:
        atol2 = (tol * jnp.maximum(jnp.sqrt(colsum(b, b)), 1e-30)) ** 2  # (k,)

        def cond(state):
            _, r, _, _, k = state
            return jnp.logical_and(k < iters, jnp.any(colsum(r, r) > atol2))

        def body(state):
            x, r, p, rz, k = state
            x, r, p, rz = advance(x, r, p, rz)
            return (x, r, p, rz, k + 1)

        x, *_ = jax.lax.while_loop(cond, body, (x0, r0, z0, rz0, 0))
        return x

    def body(state, _):
        return advance(*state), None

    (x, _, _, _), _ = jax.lax.scan(body, (x0, r0, z0, rz0), None, length=iters)
    return x


@dataclasses.dataclass(frozen=True)
class ViscousCG:
    K: object  # any operator exposing .matvec(x) and .diag(): CSROperator
    # (gather/segment-sum), ops.banded.BandedOperator (RCM shift-multiply)
    # or ops.stencil.StencilOperator (offset shift-multiply)
    interior_mask: jnp.ndarray  # (N,) 1.0 interior / 0.0 dirichlet
    dt_nu: float
    iters: int
    tol: float = 0.0  # > 0: early-exit while-loop CG (relative tolerance;
    # ``iters`` becomes the cap) — pair with an x0 warm start

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        m = self.interior_mask
        return m * (x + self.dt_nu * self.K.matvec(m * x)) + (1.0 - m) * x

    def solve(self, b: jnp.ndarray, x0: jnp.ndarray | None = None) -> jnp.ndarray:
        diag = 1.0 + self.dt_nu * self.K.diag()
        inv_diag = jnp.where(self.interior_mask > 0, 1.0 / diag, 1.0)
        # (inv ∘ r) for both (N,) and (N,k) residuals
        precond = lambda r: (inv_diag * r.T).T
        return _solve_columns(
            self.matvec, b, x0=x0, tol=self.tol, iters=self.iters, precond=precond
        )


@dataclasses.dataclass(frozen=True)
class PressureCG:
    K_merged: object  # stiffness on slave→master relabeled connectivity
    # (CSROperator or BandedOperator — see ViscousCG.K)
    m_lumped: jnp.ndarray
    masters: np.ndarray
    slaves: np.ndarray
    active_mask: jnp.ndarray  # 0.0 at slave dofs
    iters: int
    precond: str = "jacobi"  # "jacobi" | "chebyshev" | "twolevel"
    cheby_degree: int = 4
    lmax: float = 0.0  # power-iteration estimate (build-time)
    twolevel: object = None  # solve.twolevel.TwoLevel (precond="twolevel")
    tol: float = 0.0  # > 0: tolerance-based while-loop CG (early exit —
    # with warm starts the steady-state solves finish in a few iterations
    # instead of the full fixed count; ``iters`` becomes the cap)
    pin: int = -1  # ≥ 0: "report"-variant gauge fixing — the pinned dof is
    # masked out of the operator (symmetric row+col surgery as masking,
    # the CG form of scripts/stokes_clean_for_report.py:404,427-429) and
    # the constant-nullspace deflation is skipped (the pin fixes the gauge)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.pin >= 0:
            mp = self._pin_mask
            return mp * self.K_merged.matvec(mp * x) + (1.0 - mp) * x
        return self.K_merged.matvec(x)

    @property
    def _pin_mask(self) -> jnp.ndarray:
        return self.active_mask * (
            1.0 - jnp.zeros_like(self.active_mask).at[self.pin].set(1.0)
        )

    def solve(self, b: jnp.ndarray, x0: jnp.ndarray | None = None) -> jnp.ndarray:
        """Solve (K/M_L)-equivalent system: K_merged p = merge(M_L ∘ b).

        ``x0`` warm-starts CG (e.g. the previous timestep's pressure —
        near steady state this slashes the iterations needed)."""
        rhs = self.m_lumped * b
        if len(self.masters):
            m = jnp.asarray(self.masters)
            s = jnp.asarray(self.slaves)
            rhs = rhs.at[m].add(rhs[s])
            rhs = rhs * self.active_mask
        if self.pin >= 0:
            rhs = rhs * self._pin_mask  # identity row at the pin → p[pin]=0
        diag = self.K_merged.diag()
        if self.pin >= 0:
            diag = jnp.where(self._pin_mask > 0, diag, 0.0)
        inv_diag = jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0), 1.0)
        if self.precond == "chebyshev":
            from tpufem.solve.cg import chebyshev_preconditioner

            M = chebyshev_preconditioner(
                self.matvec, inv_diag, self.lmax, degree=self.cheby_degree
            )
        elif self.precond == "twolevel":
            from tpufem.solve.twolevel import twolevel_preconditioner

            M = twolevel_preconditioner(
                self.matvec, inv_diag, self.twolevel, active_mask=self.active_mask
            )
        else:
            M = lambda r: inv_diag * r
        if x0 is not None:
            x0 = x0 * (self._pin_mask if self.pin >= 0 else self.active_mask)
        # the pin fixes the gauge — deflating the constant out as well
        # would solve a different (zero-mean) problem
        deflate = self.pin < 0
        if self.tol > 0:
            from tpufem.solve.cg import cg

            p, _ = cg(
                self.matvec,
                rhs,
                x0=x0,
                tol=self.tol,
                maxiter=self.iters,
                precond=M,
                deflate=deflate,
                deflate_weights=self.active_mask,
            )
        else:
            p, _ = cg_fixed(
                self.matvec,
                rhs,
                x0=x0,
                iters=self.iters,
                precond=M,
                deflate=deflate,
                deflate_weights=self.active_mask,
            )
        if len(self.masters):
            p = p.at[jnp.asarray(self.slaves)].set(p[jnp.asarray(self.masters)])
        return p
