"""FEM operator assembly as gather → elementwise → scatter pipelines.

The reference assembles every operator with a Python ``for tri in
triangles`` loop and in-place ``A[i, j] +=`` scatter (e.g. stiffness
``/root/reference/code/StokesColor.py:98-128``, consistent mass
``/root/reference/scripts/navier_stokes.py:178-204``, convection
``/root/reference/scripts/operator_spitting_ns.py:382-430``).  Here every
element matrix is computed for *all* T elements at once from the
precomputed geometry tensors, then scattered in one ``segment_sum`` /
``scatter-add`` — a single fused XLA op instead of 9·T Python statements.

Two materializations are offered:

* **dense** ``(N, N)`` — ideal for the bundled meshes (N ≤ ~4k): the
  per-step solves are dense (LU triangular solves / inverse matvecs).
* **CSR** (static shape) — the matrix-free path for large meshes and the
  sharded multi-chip solver.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.mesh.core import Mesh

# f32 products at full precision (the GPU default rounds operands to TF32)
_HI = jax.lax.Precision.HIGHEST


def _f(mesh: Mesh, arr):
    """Promote a geometry array to the active float dtype."""
    from tpufem.config import default_float

    return jnp.asarray(arr, dtype=default_float())


def element_stiffness(mesh: Mesh, signed: bool = False) -> jnp.ndarray:
    """(T, 3, 3) P1 stiffness element matrices.

    K^e_ij = (y_diffs_i · y_diffs_j + x_diffs_i · x_diffs_j) / (2·|det|)
           = (∇φ_i · ∇φ_j) · area.

    ``signed=True`` reproduces the early reference variant that divides by
    the *signed* determinant (``code/poisson.py:111-124``) — needed for
    bit-level parity with the Poisson workload; the robust default uses
    ``abs`` like the later scripts (``code/StokesColor.py:122-124``).
    """
    grads = _f(mesh, mesh.grads)  # (T,3,2), already /det (signed)
    det = _f(mesh, mesh.det)
    # (∇φ_i·∇φ_j), carries 1/det²
    gg = jnp.einsum("tid,tjd->tij", grads, grads, precision=_HI)
    scale = det * det / (2.0 * (det if signed else jnp.abs(det)))
    ke = gg * scale[:, None, None]
    return jnp.where(_f(mesh, mesh.valid)[:, None, None] != 0, ke, 0.0)


def element_mass(mesh: Mesh) -> jnp.ndarray:
    """(T, 3, 3) consistent P1 mass: M^e = (area/12)·[[2,1,1],[1,2,1],[1,1,2]].

    Cf. ``/root/reference/scripts/navier_stokes.py:178-204``.
    """
    area = _f(mesh, mesh.area)
    base = (jnp.ones((3, 3)) + jnp.eye(3)).astype(area.dtype)
    me = area[:, None, None] / 12.0 * base
    return jnp.where(_f(mesh, mesh.valid)[:, None, None] != 0, me, 0.0)


def element_convection(mesh: Mesh, u: jnp.ndarray, variant: str = "stokescolor") -> jnp.ndarray:
    """(T, 3, 3) convection element matrices C(u).

    C^e_ij = (area/3) · (ū · ∇φ_j) with ū the element-centroid velocity.
    Row index i is uniform (test-function lumping).  The reference carries
    two inconsistent scalings of this scheme across its iterations:

    * ``variant="stokescolor"`` — ∇φ = diffs/(2|det|), area unsigned
      (``code/StokesColor.py:286-312``, also visualize_stokes_flow's dye)
    * ``variant="opsplit"`` — ∇φ = diffs/det, area *signed* — exactly 2×
      the former on CCW meshes (``scripts/operator_spitting_ns.py:382-430``)

    Dtype follows ``u`` (the per-step assembly runs in the state precision).
    """
    dtype = u.dtype
    grads = jnp.asarray(mesh.grads, dtype=dtype)
    area = jnp.asarray(mesh.area, dtype=dtype)
    det = jnp.asarray(mesh.det, dtype=dtype)
    u_c = u[mesh.tris].mean(axis=1)  # (T,2)
    # stored grads = diffs/det (signed)
    if variant == "stokescolor":
        # wants diffs/(2|det|) = grads · sign(det)/2, unsigned area
        scale = det / (2.0 * jnp.abs(det))
        row = (area / 3.0) * jnp.ones_like(det)
    elif variant == "opsplit":
        # wants diffs/det (= grads), signed area 0.5·det
        scale = jnp.ones_like(det)
        row = 0.5 * det / 3.0
    else:
        raise ValueError(f"unknown convection variant: {variant}")
    udotg = jnp.einsum(
        "td,tjd->tj", u_c, grads * scale[:, None, None], precision=_HI
    )  # (T,3)
    ce = row[:, None, None] * jnp.broadcast_to(
        udotg[:, None, :], (mesh.n_tris, 3, 3)
    )
    return jnp.where(
        jnp.asarray(mesh.valid, dtype=dtype)[:, None, None] != 0, ce, 0.0
    )


def element_convection_flat(mesh: Mesh, u: jnp.ndarray,
                            variant: str = "stokescolor") -> jnp.ndarray:
    """(9·T,) k-major flat convection values: entry ``k·T + t`` equals
    ``element_convection(mesh, u, variant)[t, k // 3, k % 3]``.

    The per-step form for the scanned NS programs: every array here is
    1-D (the (T, 3, 2) ``mesh.grads`` operand is pre-sliced into six (T,)
    constants), so ``StencilRefill.refill_flat`` gathers straight from
    this layout and no rank-3 ``(T, 3, 3)`` temporary exists in the
    step."""
    dtype = u.dtype
    grads = np.asarray(mesh.grads)
    det = jnp.asarray(mesh.det, dtype=dtype)
    tris = np.asarray(mesh.tris)
    # sum-then-/3 matches element_convection's mean() bitwise
    ucx = (u[tris[:, 0], 0] + u[tris[:, 1], 0] + u[tris[:, 2], 0]) / 3.0
    ucy = (u[tris[:, 0], 1] + u[tris[:, 1], 1] + u[tris[:, 2], 1]) / 3.0
    if variant == "stokescolor":
        scale = det / (2.0 * jnp.abs(det))
        row = jnp.asarray(mesh.area, dtype=dtype) / 3.0
    elif variant == "opsplit":
        scale = jnp.ones_like(det)
        row = 0.5 * det / 3.0
    else:
        raise ValueError(f"unknown convection variant: {variant}")
    row = jnp.where(jnp.asarray(mesh.valid, dtype=dtype) != 0, row, 0.0)
    w = []
    for j in range(3):
        gx = jnp.asarray(grads[:, j, 0], dtype=dtype) * scale
        gy = jnp.asarray(grads[:, j, 1], dtype=dtype) * scale
        w.append(row * (ucx * gx + ucy * gy))
    # k = i·3 + j with the row index i uniform → tile [w0, w1, w2] 3×
    return jnp.concatenate(w * 3)


# ---------------------------------------------------------------------------
# Scatter / materialization
# ---------------------------------------------------------------------------


def assemble_coo(mesh: Mesh, elem: jnp.ndarray):
    """Flatten (T,3,3) element matrices to COO triplets (rows, cols, vals)."""
    tris = jnp.asarray(mesh.tris)
    rows = jnp.repeat(tris, 3, axis=1).reshape(-1)  # i index varies slower
    cols = jnp.tile(tris, (1, 3)).reshape(-1)
    vals = elem.reshape(-1)
    return rows, cols, vals


def assemble_dense(mesh: Mesh, elem: jnp.ndarray) -> jnp.ndarray:
    """Scatter element matrices into a dense (N, N) global matrix."""
    rows, cols, vals = assemble_coo(mesh, elem)
    n = mesh.n_nodes
    flat = rows.astype(jnp.int32) * n + cols.astype(jnp.int32)
    out = jax.ops.segment_sum(vals, flat, num_segments=n * n)
    return out.reshape(n, n)


def assemble_csr(mesh: Mesh, elem: jnp.ndarray):
    """Materialize element matrices as a static-shape CSR operator.

    The sparsity pattern depends only on connectivity, so it is computed
    once on the host (NumPy) and the values are filled on device — the
    pattern is reusable across operators (K, M, C(u)) with identical layout.
    """
    from tpufem.ops.sparse import CSROperator

    pattern = _csr_pattern(mesh)
    vals = _coo_to_csr_values(pattern, elem)
    return CSROperator(
        indptr=pattern["indptr"],
        indices=pattern["indices"],
        data=vals,
        shape=(mesh.n_nodes, mesh.n_nodes),
    )


_PATTERN_CACHE: dict[int, dict] = {}


def _csr_pattern(mesh: Mesh) -> dict:
    # cache holds the mesh itself: bare id() keys can collide after GC
    key = id(mesh)
    hit = _PATTERN_CACHE.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    tris = np.asarray(mesh.tris)
    rows = np.repeat(tris, 3, axis=1).reshape(-1)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    order = np.lexsort((cols, rows))
    rs, cs = rows[order], cols[order]
    # unique (row, col) pairs; map each COO entry to its nnz slot
    keys = rs.astype(np.int64) * mesh.n_nodes + cs
    uniq, inverse = np.unique(keys, return_inverse=True)
    urows = (uniq // mesh.n_nodes).astype(np.int32)
    ucols = (uniq % mesh.n_nodes).astype(np.int32)
    indptr = np.zeros(mesh.n_nodes + 1, dtype=np.int32)
    np.add.at(indptr, urows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    pattern = {
        "indptr": indptr,
        "indices": ucols,
        "order": order,
        "inverse": inverse.astype(np.int32),
        "nnz": uniq.shape[0],
    }
    _PATTERN_CACHE[key] = (mesh, pattern)
    return pattern


def _coo_to_csr_values(pattern: dict, elem: jnp.ndarray) -> jnp.ndarray:
    vals = elem.reshape(-1)[pattern["order"]]
    return jax.ops.segment_sum(
        vals, jnp.asarray(pattern["inverse"]), num_segments=pattern["nnz"]
    )


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------


def lumped_mass(mesh: Mesh) -> jnp.ndarray:
    """(N,) lumped mass: M_L[i] = Σ_incident area/3.

    Cf. ``/root/reference/code/StokesColor.py:266-284``.  Note the reference
    does *not* skip degenerate triangles here; neither do we (area = 0).
    """
    area = _f(mesh, mesh.area)
    contrib = jnp.broadcast_to((area / 3.0)[:, None], (mesh.n_tris, 3)).reshape(-1)
    return jax.ops.segment_sum(
        contrib, jnp.asarray(mesh.tris).reshape(-1), num_segments=mesh.n_nodes
    )


def load_vector(mesh: Mesh, g_source, signed_area: bool = False, negate: bool = True):
    """(N,) load vector for source g: b_j = g(centroid) · area/3 per corner.

    ``negate=True`` returns −b like the reference's ``buildFemSystem``
    (``code/poisson.py:146``); ``signed_area=True`` reproduces its use of
    the *signed* area (``code/poisson.py:131``).
    """
    area = _f(mesh, 0.5 * mesh.det if signed_area else mesh.area)
    if callable(g_source):
        cent = mesh.centroids()
        g = jnp.asarray(g_source(cent[:, 0], cent[:, 1]), dtype=area.dtype)
    else:
        g = jnp.full(mesh.n_tris, g_source, dtype=area.dtype)
    contrib = g * area / 3.0
    contrib = jnp.where(_f(mesh, mesh.valid) != 0, contrib, 0.0)
    contrib3 = jnp.broadcast_to(contrib[:, None], (mesh.n_tris, 3)).reshape(-1)
    b = jax.ops.segment_sum(
        contrib3, jnp.asarray(mesh.tris).reshape(-1), num_segments=mesh.n_nodes
    )
    return -b if negate else b


def load_vector_nodal(mesh: Mesh, g_nodal: jnp.ndarray) -> jnp.ndarray:
    """Consistent-mass load for a nodal source: b += (A/12)(2gᵢ+gⱼ+gₖ).

    Cf. ``/root/reference/scripts/operator_spitting_ns.py:304-315``.
    """
    area = _f(mesh, mesh.area)
    g_loc = g_nodal[mesh.tris]  # (T,3)
    total = g_loc.sum(axis=1, keepdims=True)
    contrib = (area[:, None] / 12.0) * (g_loc + total)  # 2g_i + g_j + g_k
    return jax.ops.segment_sum(
        contrib.reshape(-1), jnp.asarray(mesh.tris).reshape(-1), num_segments=mesh.n_nodes
    )


def assemble_csr_conn(conn_rows, conn_cols, elem, shape):
    """CSR from arbitrary (possibly rectangular) element blocks.

    ``conn_rows (T, kr)`` / ``conn_cols (T, kc)`` give each element
    block's global row/col ids; ``elem (T, kr, kc)`` the values.  The
    generalization of :func:`assemble_csr` beyond P1 square operators —
    used for the P2 stiffness/mass and the P1×P2 divergence-coupling
    blocks of the sparse Taylor–Hood solver (``workloads/th_sparse.py``).
    """
    from tpufem.ops.sparse import CSROperator

    conn_rows = np.asarray(conn_rows, dtype=np.int64)
    conn_cols = np.asarray(conn_cols, dtype=np.int64)
    t, kr = conn_rows.shape
    kc = conn_cols.shape[1]
    rows = np.repeat(conn_rows, kc, axis=1).reshape(-1)
    cols = np.tile(conn_cols, (1, kr)).reshape(-1)
    order = np.lexsort((cols, rows))
    keys = rows[order] * np.int64(shape[1]) + cols[order]
    uniq, inverse = np.unique(keys, return_inverse=True)
    urows = (uniq // shape[1]).astype(np.int32)
    ucols = (uniq % shape[1]).astype(np.int32)
    indptr = np.zeros(shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, urows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    vals = jnp.asarray(elem).reshape(-1)[order]
    data = jax.ops.segment_sum(
        vals, jnp.asarray(inverse.astype(np.int32)), num_segments=len(uniq)
    )
    return CSROperator(
        indptr=indptr, indices=ucols, data=data, shape=tuple(shape)
    )
