"""Dense solvers with setup-time factorization.

The reference re-runs a full O(N³) ``np.linalg.solve`` on the *same*
matrix every timestep — 4× per Stokes step, 6000 steps
(``/root/reference/code/StokesColor.py:544-555``, ``code/heatEq.py:323``).
All system matrices are constant across a run, so we factor **once** at
setup and each step costs only O(N²).

The factorization is done once on the **host** (LAPACK, full f64
accuracy) at setup, and only its *application* ships to the device:

* :class:`DenseInverse` — host ``np.linalg.inv`` once; the per-step solve
  is a single (N,N)@(N,) matvec that fuses into the surrounding step
  program.  The fast path of the dense regime, in f32 or f64.
* :class:`DenseLU` — host LAPACK LU once, device triangular solves per
  step (numerically identical to the reference's per-step solve).  The
  bit-tight parity path.

f32 products run at ``HIGHEST`` precision: the GPU's default would round
the operands to TF32 (about three decimal digits).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsla
import numpy as np
import scipy.linalg as sla


@dataclasses.dataclass(frozen=True)
class DenseLU:
    """Host-factored LU; ``solve`` runs jittable triangular solves."""

    lu: jnp.ndarray
    piv: jnp.ndarray

    @classmethod
    def factor(cls, A) -> "DenseLU":
        lu, piv = sla.lu_factor(np.asarray(A))
        return cls(lu=jnp.asarray(lu), piv=jnp.asarray(piv))

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        return jsla.lu_solve((self.lu, self.piv), b)


@dataclasses.dataclass(frozen=True)
class DenseInverse:
    """Host-computed explicit inverse; ``solve`` is one matvec."""

    inv: jnp.ndarray

    @classmethod
    def factor(cls, A) -> "DenseInverse":
        return cls(inv=jnp.asarray(np.linalg.inv(np.asarray(A))))

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        return jnp.matmul(self.inv, b, precision=jax.lax.Precision.HIGHEST)


def make_dense_solver(A, method: str = "lu"):
    """Factor A once; returns an object with a jittable ``.solve(b)``.

    ``lu`` — exact (reference-parity) path; ``inverse`` — fastest path.
    """
    if method == "lu":
        return DenseLU.factor(A)
    if method == "inverse":
        return DenseInverse.factor(A)
    raise ValueError(f"unknown dense solver method: {method}")
