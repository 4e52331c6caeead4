"""Stencil-offset sparse operators — the O(nnz) gather-free SpMV.

Banded (RCM) storage reads the whole O(2·bw·N) band envelope per matvec
even though P1 mesh operators have only ~7 nonzeros per row (band density
0.4–1.6% at 19k–115k nodes).  CSR reads O(nnz) but through a gather and a
segment-sum.  Static-offset shift-multiply-accumulate (constant-offset
``dynamic_slice`` + FMA) reads O(nnz) contiguously and XLA fuses it into
one elementwise kernel.

This operator therefore decomposes A = Σ_k diag(d_k)·Shift(o_k) + R:

* the ``s`` most frequent column−row offsets become dense diagonals
  (static offsets — compile-time constants, no gathers);
* the few entries off those offsets form a small COO remainder applied
  with one (tiny) gather + scatter-add.

On meshes generated with grid-preserving numbering
(``generate_annulus_mesh(pad_hole=True)``) the 9 grid-stencil offsets
cover ≳95% of nnz and the remainder is O(perimeter).  On arbitrary
orderings the decomposition is still exact — just with a larger
remainder (``coverage`` reports the split; the auto storage picker falls
back to banded when coverage is poor).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    offsets: tuple  # (s,) static python ints (column − row)
    diags: jnp.ndarray  # (s, N): diags[k, r] = A[r, r + offsets[k]]
    rest_rows: np.ndarray  # (m,) int32, sorted (host/static)
    rest_cols_j: jnp.ndarray  # (m,) int32 device
    rest_rows_j: jnp.ndarray  # (m,) int32 device
    rest_data: jnp.ndarray  # (m,)
    coverage: float  # fraction of nnz on the stencil offsets

    @property
    def n(self) -> int:
        return self.diags.shape[1]

    @classmethod
    def build(
        cls,
        op,
        dtype=jnp.float32,
        max_offsets: int = 16,
        offsets=None,
        min_fill: float = 0.05,
    ) -> "StencilOperator":
        """Decompose a CSROperator; host-side, O(nnz).

        ``min_fill`` trims near-empty diagonals: an offset whose entry
        count is below ``min_fill·N`` costs a full O(N) FMA pass to apply
        a handful of values (on pad_hole annulus meshes the 9 grid
        offsets carry ~99.4% of nnz while the next 7 candidates hold ~30
        entries EACH) — such offsets go to the COO remainder instead,
        which also narrows the distributed halo strips
        (parallel/halo_stencil.py).  Explicit ``offsets`` bypass trimming."""
        n = op.shape[0]
        rows = np.asarray(op.row_ids, dtype=np.int64)
        cols = np.asarray(op.indices, dtype=np.int64)
        data = np.asarray(op.data, dtype=np.float64)
        off = cols - rows
        if offsets is None:
            vals, counts = np.unique(off, return_counts=True)
            order = np.argsort(-counts)
            keep = order[:max_offsets]
            keep = [k for k in keep if counts[k] >= min_fill * n or vals[k] == 0]
            chosen = list(vals[keep])
            if 0 not in chosen:
                chosen.append(0)
            offsets = sorted(int(o) for o in chosen)
        else:
            offsets = sorted(int(o) for o in offsets)
            assert 0 in offsets, "offset 0 (the diagonal) is required"
        offsets = tuple(offsets)

        diags = np.zeros((len(offsets), n))
        in_stencil = np.zeros(len(off), dtype=bool)
        for k, o in enumerate(offsets):
            sel = off == o
            # rows are unique per (row, col) in an assembled CSR pattern
            diags[k, rows[sel]] = data[sel]
            in_stencil |= sel
        rest = ~in_stencil
        r_rows = rows[rest].astype(np.int32)
        r_cols = cols[rest].astype(np.int32)
        r_data = data[rest]
        o = np.argsort(r_rows, kind="stable")
        r_rows, r_cols, r_data = r_rows[o], r_cols[o], r_data[o]
        return cls(
            offsets=offsets,
            diags=jnp.asarray(diags, dtype=dtype),
            rest_rows=r_rows,
            rest_rows_j=jnp.asarray(r_rows),
            rest_cols_j=jnp.asarray(r_cols),
            rest_data=jnp.asarray(r_data, dtype=dtype),
            coverage=float(in_stencil.mean()) if len(off) else 1.0,
        )

    def astype(self, dtype) -> "StencilOperator":
        """Value-dtype cast (pattern unchanged) — mirrors
        ``CSROperator.astype`` so matrix-free workloads can switch
        precision without caring which materialization they hold."""
        return dataclasses.replace(
            self,
            diags=self.diags.astype(dtype),
            rest_data=self.rest_data.astype(dtype),
        )

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        n = self.n
        pad = max(max(abs(o) for o in self.offsets), 1)
        padded = jnp.pad(x, (pad, pad))
        y = jnp.zeros_like(x)
        for k, o in enumerate(self.offsets):
            y = y + self.diags[k] * jax.lax.dynamic_slice(padded, (pad + o,), (n,))
        if len(self.rest_rows):
            y = y.at[self.rest_rows_j].add(
                self.rest_data * x[self.rest_cols_j],
                indices_are_sorted=True,
            )
        return y

    def diag(self) -> jnp.ndarray:
        d = self.diags[self.offsets.index(0)]
        same = self.rest_rows_j == self.rest_cols_j  # normally empty
        if len(self.rest_rows):
            d = d.at[self.rest_rows_j].add(
                jnp.where(same, self.rest_data, 0.0), indices_are_sorted=True
            )
        return d


@dataclasses.dataclass(frozen=True)
class StencilRefill:
    """Per-step VALUE refill of a stencil operator with a static PATTERN.

    For state-dependent operators — the convection matrix C(u) rebuilt
    every step (``scripts/operator_spitting_ns.py:559``) — the sparsity
    is the mesh adjacency (static) while the values change with u.  A
    matrix-free apply pays one gather + one segment-sum PER ITERATION of
    the Krylov solve; this class instead scatters the (T, 3, 3) element
    values into stencil-diagonal planes ONCE per step (a single
    segment-sum over the 9T entries), after which every iteration runs
    the shift-FMA ``StencilOperator.matvec`` — no gathers.

    Host-precomputed: element entry → flat destination ``k·N + row`` for
    entries on the template's offsets, ``s·N + rest slot`` for the
    remainder (same ordering as ``StencilOperator.build``, so the
    refilled operator is drop-in)."""

    template: StencilOperator  # pattern donor; its values are ignored
    dest: jnp.ndarray  # (E,) int32: ordered element entry → flat slot
    order: np.ndarray  # (E,) host: elem.reshape(-1) gather order
    n_flat: int  # s·N + len(rest)
    order_k: np.ndarray | None = None  # (E,) host: gather order into the
    # K-MAJOR (9·T,) flat layout of ``assembly.element_convection_flat``

    @classmethod
    def build(cls, mesh, dtype=jnp.float32, max_offsets: int = 16,
              offsets=None) -> "StencilRefill":
        from tpufem.ops import assembly

        # unit-valued CSR on the adjacency pattern fixes offsets/remainder
        pattern = assembly._csr_pattern(mesh)
        n = mesh.n_nodes
        template = StencilOperator.build(
            _PatternCSR(pattern, n), dtype=dtype, max_offsets=max_offsets,
            offsets=offsets,
        )
        rows = np.repeat(
            np.arange(n, dtype=np.int64),
            np.diff(pattern["indptr"]).astype(np.int64),
        )
        cols = pattern["indices"].astype(np.int64)
        off = cols - rows
        s = len(template.offsets)
        slot_dest = np.empty(pattern["nnz"], dtype=np.int64)
        in_stencil = np.zeros(pattern["nnz"], dtype=bool)
        for k, o in enumerate(template.offsets):
            sel = off == o
            slot_dest[sel] = k * n + rows[sel]
            in_stencil |= sel
        rest = np.nonzero(~in_stencil)[0]
        # remainder ordering must match StencilOperator.build: stable
        # sort by row (CSR slots are already row-major ⇒ identity, kept
        # explicit for safety)
        o_r = np.argsort(rows[rest], kind="stable")
        slot_dest[rest[o_r]] = s * n + np.arange(len(rest))
        dest = slot_dest[pattern["inverse"]]
        order = pattern["order"]
        return cls(
            template=template,
            dest=jnp.asarray(dest, dtype=jnp.int32),
            order=order,
            n_flat=s * n + len(rest),
            order_k=(order % 9) * mesh.n_tris + order // 9,
        )

    def refill(self, elem: jnp.ndarray) -> StencilOperator:
        """(T, 3, 3) element values → a ready StencilOperator (jittable)."""
        return self._from_gathered(elem.reshape(-1)[self.order])

    def refill_flat(self, flat_k: jnp.ndarray) -> StencilOperator:
        """(9·T,) K-MAJOR element values (``k·T + t`` layout, see
        ``assembly.element_convection_flat``) → StencilOperator without
        ever materializing a rank-3 (T, 3, 3) tensor on device."""
        return self._from_gathered(
            flat_k[jnp.asarray(self.order_k, dtype=jnp.int32)]
        )

    def _from_gathered(self, vals: jnp.ndarray) -> StencilOperator:
        flat = jax.ops.segment_sum(
            vals, self.dest, num_segments=self.n_flat,
        )
        s, n = self.template.diags.shape
        return dataclasses.replace(
            self.template,
            diags=flat[: s * n].reshape(s, n),
            rest_data=flat[s * n:],
        )


class _PatternCSR:
    """Minimal CSR view of an adjacency pattern (unit values)."""

    def __init__(self, pattern, n):
        self.indptr = pattern["indptr"]
        self.indices = pattern["indices"]
        self.data = np.ones(pattern["nnz"])
        self.shape = (n, n)

    @property
    def row_ids(self):
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int64),
            np.diff(self.indptr).astype(np.int64),
        )
