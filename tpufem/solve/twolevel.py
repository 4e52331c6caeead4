"""Two-level (aggregation AMG-lite) preconditioner for the pressure CG.

Plain Jacobi-PCG on the pressure Poisson operator needs O(1/h) ~ O(√N)
iterations: the low-frequency error modes decay one mesh cell per
iteration.  A coarse-level correction kills exactly those modes, making
the outer iteration count (nearly) mesh-independent — the "real
O(√N)-killer" for the large-mesh regime (the reference itself never
scales past ~1k nodes, ``/root/reference/code/StokesColor.py:549-555``
re-solves a dense system per step instead).

Construction (all host-side, once per problem):

* **Aggregation** — nodes are binned into geometric grid cells over the
  mesh coordinates (piecewise-constant prolongation ``P``: node i belongs
  to aggregate ``agg[i]``).  Geometric binning is deterministic, O(N),
  and naturally load-balanced on quasi-uniform meshes.
* **Galerkin coarse operator** — ``A_c = Pᵀ K P`` accumulated directly
  from the fine COO entries; the constant nullspace is inherited
  (``A_c·1 = 0``) and regularized with a rank-one shift whose inverse
  acts like ``pinv(A_c)`` plus an (irrelevant, deflated-away) constant.
* **Damped-Jacobi smoother** — ω = 1/λ̂max(D⁻¹K) via power iteration.

Per application (device-side, inside the jitted CG):

    z₁ = ω D⁻¹ r                      pre-smooth
    z₂ = z₁ + P A_c⁻¹ Pᵀ (r − K z₁)   coarse correction
    z  = z₂ + ω D⁻¹ (r − K z₂)        post-smooth

which is symmetric positive definite on the active subspace (identical
pre/post smoothing), so CG theory applies.  Device mapping: the
restriction is a single sorted ``segment_sum``, the interpolation a single
row gather, and the coarse solve one dense (N_c, N_c) matvec — no
sequential sweeps, no dynamic shapes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class TwoLevel:
    """Device-side pieces of the two-level preconditioner."""

    agg_sorted: jnp.ndarray  # (N,) int32 aggregate id, sorted ascending
    order: jnp.ndarray  # (N,) int32 node permutation making agg sorted
    agg: jnp.ndarray  # (N,) int32 aggregate id in node order (interp gather)
    ac_inv: jnp.ndarray  # (Nc, Nc) regularized coarse inverse
    omega: float  # damped-Jacobi weight = 1/λ̂max(D⁻¹K)

    @property
    def n_coarse(self) -> int:
        return self.ac_inv.shape[0]


def build_aggregates(coords: np.ndarray, target_coarse: int = 2048):
    """Geometric grid aggregation: (agg ids (N,), n_coarse).

    Cells per side is chosen so the number of *non-empty* cells lands
    near ``target_coarse`` (empty cells are compressed away).
    """
    n = coords.shape[0]
    nc_goal = int(min(target_coarse, max(1, n // 4)))
    g = max(1, int(round(np.sqrt(nc_goal / 0.8))))  # ~80% cell occupancy

    def norm(v):
        lo, hi = float(v.min()), float(v.max())
        return np.clip((v - lo) / max(hi - lo, 1e-30), 0.0, 1.0 - 1e-12)

    ix = np.minimum((norm(coords[:, 0]) * g).astype(np.int64), g - 1)
    iy = np.minimum((norm(coords[:, 1]) * g).astype(np.int64), g - 1)
    uniq, agg = np.unique(ix * g + iy, return_inverse=True)
    return agg.astype(np.int32), len(uniq)


def galerkin_coarse(csr_op, agg: np.ndarray, n_coarse: int) -> np.ndarray:
    """A_c = Pᵀ A P for piecewise-constant P, straight from COO entries."""
    rows = np.asarray(csr_op.row_ids, dtype=np.int64)
    cols = np.asarray(csr_op.indices, dtype=np.int64)
    data = np.asarray(csr_op.data, dtype=np.float64)
    ac = np.zeros((n_coarse, n_coarse))
    np.add.at(ac, (agg[rows], agg[cols]), data)
    return ac


def coarse_inverse(ac: np.ndarray) -> np.ndarray:
    """Regularized inverse of the (singular, Neumann) coarse operator.

    ``inv(A_c + α·𝟙𝟙ᵀ/n) = pinv(A_c) + (1/α)·𝟙𝟙ᵀ/n`` on the constant-
    orthogonal complement — the extra constant component is projected out
    by the CG deflation.  Aggregates with an empty row (all-slave cells on
    the merged periodic operator) are decoupled with a unit diagonal.
    """
    nc = ac.shape[0]
    d = np.diag(ac).copy()
    dead = d <= 0
    if dead.any():
        ac = ac.copy()
        ac[dead, :] = 0.0
        ac[:, dead] = 0.0
        ac[dead, dead] = 1.0
        d = np.diag(ac)
    alpha = float(d.mean())
    return np.linalg.inv(ac + alpha * np.ones((nc, nc)) / nc)


def build_twolevel(
    csr_op,
    coords: np.ndarray,
    matvec,
    inv_diag: jnp.ndarray,
    *,
    target_coarse: int = 2048,
    dtype=jnp.float64,
    coarse_dtype=None,
    lmax: float | None = None,
) -> TwoLevel:
    """Host-side construction from the (merged) fine CSR operator.

    ``coarse_dtype`` overrides the storage dtype of the dense coarse
    inverse (e.g. ``jnp.bfloat16``): the coarse matvec is the byte-
    dominant part of one preconditioner application at large N, and a
    preconditioner tolerates approximation — elementwise rounding keeps
    ``ac_inv`` exactly symmetric, and the ~0.4% bf16 relative error is
    far below the smoother's approximation level (measured: iteration
    counts unchanged at 26k–160k nodes)."""
    from tpufem.solve.cg import estimate_lmax

    agg, nc = build_aggregates(np.asarray(coords), target_coarse)
    ac_inv = coarse_inverse(galerkin_coarse(csr_op, agg, nc))
    if lmax is None:
        lmax = estimate_lmax(matvec, inv_diag, coords.shape[0])
    order = np.argsort(agg, kind="stable").astype(np.int32)
    return TwoLevel(
        agg_sorted=jnp.asarray(agg[order]),
        order=jnp.asarray(order),
        agg=jnp.asarray(agg),
        ac_inv=jnp.asarray(ac_inv, dtype=coarse_dtype or dtype),
        omega=1.0 / float(lmax),
    )


def twolevel_preconditioner(matvec, inv_diag, tl: TwoLevel, active_mask=None):
    """M(r) closure for CG (SPD on the active subspace)."""
    nc = tl.n_coarse

    def smooth(r):
        return tl.omega * (inv_diag * r)

    def coarse(r):
        rc = jax.ops.segment_sum(
            r[tl.order], tl.agg_sorted, num_segments=nc, indices_are_sorted=True
        )
        # matvec in the coarse storage dtype, accumulate back in the field
        # dtype.  The bf16 coarse inverse (coarse_dtype) is the one product
        # on the step path deliberately left at reduced precision; every
        # other coarse matvec runs at HIGHEST (no TF32 rounding on the GPU)
        prec = (None if tl.ac_inv.dtype == jnp.bfloat16
                else jax.lax.Precision.HIGHEST)
        z = jnp.matmul(tl.ac_inv, rc.astype(tl.ac_inv.dtype), precision=prec)
        z = z.astype(r.dtype)[tl.agg]
        return z if active_mask is None else z * active_mask

    def M(r):
        z1 = smooth(r)
        z2 = z1 + coarse(r - matvec(z1))
        return z2 + smooth(r - matvec(z2))

    return M
