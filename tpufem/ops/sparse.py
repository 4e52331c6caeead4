"""Static-shape CSR operators and their segment-sum matvec.

The matrix-free path for meshes too large for dense solves, and the
building block for the sharded multi-device CG.  Shapes are static: the
sparsity pattern is computed once on the host, so the jitted matvec is a
gather → multiply → segment-sum with fixed sizes.  On the GPU the
workloads prefer the gather-free ``ops.stencil.StencilOperator`` /
``ops.banded.BandedOperator`` (``tpufem.platform``) — CSR is the
CPU-friendly and sharding-friendly (row-slab) form.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class CSROperator:
    """Compressed-sparse-row matrix with static pattern.

    ``indptr``/``indices`` live as NumPy (compile-time constants); ``data``
    is a device array so values can be re-assembled (e.g. C(u) each step)
    without recompiling.
    """

    indptr: np.ndarray  # (N+1,) int32
    indices: np.ndarray  # (nnz,) int32
    data: jnp.ndarray  # (nnz,)
    shape: tuple[int, int]

    @property
    def row_ids(self) -> np.ndarray:
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int32), np.diff(self.indptr)
        )

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return csr_matvec(self, x)

    def todense(self) -> jnp.ndarray:
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        return out.at[self.row_ids, self.indices].add(self.data)

    def with_data(self, data: jnp.ndarray) -> "CSROperator":
        return dataclasses.replace(self, data=data)

    def astype(self, dtype) -> "CSROperator":
        """Value-dtype cast (pattern unchanged) — mirrors
        ``StencilOperator.astype``."""
        return dataclasses.replace(self, data=self.data.astype(dtype))

    def diag(self) -> jnp.ndarray:
        rows = jnp.asarray(self.row_ids)
        is_diag = rows == jnp.asarray(self.indices)
        return jax.ops.segment_sum(
            jnp.where(is_diag, self.data, 0.0), rows, num_segments=self.shape[0]
        )


def csr_matvec(op: CSROperator, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x via gather + segment_sum (row ids are sorted, which the
    segment reduction is told)."""
    gathered = op.data * x[op.indices]
    return jax.ops.segment_sum(
        gathered,
        jnp.asarray(self_rows(op)),
        num_segments=op.shape[0],
        indices_are_sorted=True,
    )


_ROWS_CACHE: dict[int, np.ndarray] = {}


def self_rows(op: CSROperator) -> np.ndarray:
    key = id(op.indptr)
    hit = _ROWS_CACHE.get(key)
    if hit is None or hit[0] is not op.indptr:
        hit = (op.indptr, op.row_ids)
        _ROWS_CACHE[key] = hit
    return hit[1]


def csr_from_coo(rows, cols, data, shape,
                 sum_duplicates: bool = False) -> CSROperator:
    """CSR from host COO triplets.  Default assumes unique (row, col)
    pairs (the permutation of an already-assembled pattern);
    ``sum_duplicates=True`` coalesces repeated pairs by summation (the
    BC-surgery row additions of :func:`tpufem.bc.bc_surgery_csr`)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    data = np.asarray(data)
    if sum_duplicates:
        keys = rows * int(shape[1]) + cols
        uniq, inv = np.unique(keys, return_inverse=True)
        summed = np.zeros(len(uniq), dtype=np.float64)
        np.add.at(summed, inv, data.astype(np.float64))
        rows = uniq // int(shape[1])
        cols = uniq % int(shape[1])
        data = summed
    order = np.lexsort((cols, rows))
    indptr = np.zeros(shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, rows[order] + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CSROperator(
        indptr=indptr,
        indices=cols[order].astype(np.int32),
        data=jnp.asarray(data[order]),
        shape=tuple(shape),
    )

