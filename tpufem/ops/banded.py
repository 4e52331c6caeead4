"""Banded sparse operators via RCM reordering — a gather-free SpMV.

Reverse-Cuthill-McKee reordering compresses a P1 mesh operator to
bandwidth ~O(√N); the matrix is then stored as (2b+1) diagonals and the
matvec becomes pure shift-multiply-accumulate — zero gathers, fully
vectorized, but it reads the O(bw·N) band envelope.  The fallback of
``cg_storage="auto"`` on the GPU when the numbering does not suit the
stencil decomposition (``ops/stencil.py``).

The permutation is internal to the operator: callers stay in global node
order (``matvec`` permutes in, computes banded, permutes out — the two
permutation gathers are O(N) and negligible against the band sweep).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.ops.sparse import CSROperator


@dataclasses.dataclass(frozen=True)
class BandedOperator:
    diags: jnp.ndarray  # (2b+1, N) band diagonals, permuted ordering
    perm: np.ndarray  # global → banded order
    inv_perm: np.ndarray
    bandwidth: int

    @property
    def n(self) -> int:
        return self.diags.shape[1]

    @classmethod
    def build(cls, op: CSROperator, dtype=jnp.float32) -> "BandedOperator":
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        n = op.shape[0]
        A = sp.csr_matrix(
            (np.asarray(op.data, dtype=np.float64), np.asarray(op.indices), np.asarray(op.indptr)),
            shape=(n, n),
        )
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[perm][:, perm].tocoo()
        bw = int(np.abs(Ap.row - Ap.col).max()) if Ap.nnz else 0
        diags = np.zeros((2 * bw + 1, n))
        diags[(Ap.col - Ap.row) + bw, Ap.row] = Ap.data
        inv_perm = np.empty(n, dtype=np.int64)
        inv_perm[perm] = np.arange(n)
        return cls(
            diags=jnp.asarray(diags, dtype=dtype),
            perm=perm,
            inv_perm=inv_perm,
            bandwidth=bw,
        )

    def matvec_permuted(self, xp: jnp.ndarray) -> jnp.ndarray:
        """y = A x in the banded (permuted) ordering."""
        bw = self.bandwidth
        n = self.n
        padded = jnp.pad(xp, (bw, bw))
        y = jnp.zeros_like(xp)
        for k in range(2 * bw + 1):
            y = y + self.diags[k] * jax.lax.dynamic_slice(padded, (k,), (n,))
        return y

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A x in global node ordering."""
        xp = x[jnp.asarray(self.perm)]
        return self.matvec_permuted(xp)[jnp.asarray(self.inv_perm)]

    def diag(self) -> jnp.ndarray:
        """Main diagonal in global ordering."""
        return self.diags[self.bandwidth][jnp.asarray(self.inv_perm)]
