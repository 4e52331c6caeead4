"""Discrete nodal vector calculus: divergence, gradient, vorticity.

These are the matrix-free node-field → node-field operators the reference
evaluates with Python element loops every step
(``/root/reference/code/StokesColor.py:130-165`` divergence,
``:224-263`` gradient, ``scripts/stokes_clean_for_report.py:309-344``
vorticity, ``:267-307`` consistent RHS).  Semantics are preserved exactly:

* element-constant derivative via the signed determinant,
* ⅓-area lumping to nodes,
* normalization by the accumulated ⅓-areas (+1e-12),
* degenerate triangles (|det| < 1e-14) contribute nothing — including to
  the accumulated area.

Each function is a pure jittable map compiled to one fused
gather → elementwise → segment-sum pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.mesh.core import Mesh
from tpufem.ops.assembly import _f

# f32 products at full precision (the GPU default rounds operands to TF32)
_HI = jax.lax.Precision.HIGHEST

_EPS_AREA = 1e-12


def _lump(mesh: Mesh, per_element: jnp.ndarray) -> jnp.ndarray:
    """Scatter a per-element quantity to nodes with ⅓-area lumping and
    normalize by the accumulated area (reference's shared idiom).
    Dtype follows the input field."""
    dtype = per_element.dtype
    area = jnp.asarray(mesh.area, dtype=dtype)
    valid = jnp.asarray(mesh.valid, dtype=dtype)
    w = jnp.where(valid != 0, area / 3.0, 0.0)
    seg = jnp.asarray(mesh.tris).reshape(-1)
    n = mesh.n_nodes

    def scatter(q):
        contrib = jnp.broadcast_to((q * w)[:, None], (mesh.n_tris, 3)).reshape(-1)
        return jax.ops.segment_sum(contrib, seg, num_segments=n)

    area_sum = jax.ops.segment_sum(
        jnp.broadcast_to(w[:, None], (mesh.n_tris, 3)).reshape(-1), seg, num_segments=n
    )
    if per_element.ndim == 1:
        return scatter(per_element) / (area_sum + _EPS_AREA)
    cols = [scatter(per_element[:, k]) for k in range(per_element.shape[1])]
    return jnp.stack(cols, axis=1) / (area_sum + _EPS_AREA)[:, None]


def element_gradient(mesh: Mesh, p: jnp.ndarray) -> jnp.ndarray:
    """(T, 2) element-constant gradient of a nodal scalar p."""
    # stored grads = diffs/det — identical to the reference's basis-gradient
    # stack in calculate_gradiant (StokesColor.py:244-248).
    grads = jnp.asarray(mesh.grads, dtype=p.dtype)  # (T,3,2)
    p_loc = p[mesh.tris]  # (T,3)
    return jnp.einsum("ti,tid->td", p_loc, grads, precision=_HI)


def gradient(mesh: Mesh, p: jnp.ndarray) -> jnp.ndarray:
    """(N, 2) lumped nodal gradient (``calculate_gradiant`` parity)."""
    return _lump(mesh, element_gradient(mesh, p))


def element_divergence(mesh: Mesh, u: jnp.ndarray) -> jnp.ndarray:
    """(T,) element-constant divergence of nodal velocity u (N, 2)."""
    grads = jnp.asarray(mesh.grads, dtype=u.dtype)
    u_loc = u[mesh.tris]  # (T,3,2)
    dudx = jnp.einsum("ti,ti->t", u_loc[..., 0], grads[..., 0], precision=_HI)
    dvdy = jnp.einsum("ti,ti->t", u_loc[..., 1], grads[..., 1], precision=_HI)
    return dudx + dvdy


def divergence(mesh: Mesh, u: jnp.ndarray) -> jnp.ndarray:
    """(N,) lumped nodal divergence (``calculate_divergence`` parity)."""
    return _lump(mesh, element_divergence(mesh, u))


def vorticity(mesh: Mesh, u: jnp.ndarray) -> jnp.ndarray:
    """(N,) lumped nodal vorticity ω = ∂u_y/∂x − ∂u_x/∂y.

    Cf. ``/root/reference/scripts/stokes_clean_for_report.py:309-344``.
    """
    grads = jnp.asarray(mesh.grads, dtype=u.dtype)
    u_loc = u[mesh.tris]
    duy_dx = jnp.einsum("ti,ti->t", u_loc[..., 1], grads[..., 0], precision=_HI)
    dux_dy = jnp.einsum("ti,ti->t", u_loc[..., 0], grads[..., 1], precision=_HI)
    return _lump(mesh, duy_dx - dux_dy)


def divergence_matrices(mesh: Mesh):
    """(Dx, Dy) host NumPy (N, N) matrices with div(u) = Dx uₓ + Dy u_y.

    The lumped divergence is linear in u, so it can be materialized once
    as two dense operators; the per-step evaluation then becomes dense
    matvecs instead of gather/segment-sum pipelines (the dense
    regime).  Numerically identical (up to
    summation order) to :func:`divergence`.
    """
    n, t = mesh.n_nodes, mesh.n_tris
    w = np.where(mesh.valid, mesh.area / 3.0, 0.0)  # (T,)
    area_sum = np.zeros(n)
    np.add.at(area_sum, mesh.tris.reshape(-1), np.repeat(w, 3))
    inv_area = 1.0 / (area_sum + _EPS_AREA)
    Dx = np.zeros((n, n))
    Dy = np.zeros((n, n))
    rows = np.repeat(mesh.tris, 3, axis=1).reshape(-1)  # i (receiver)
    cols = np.tile(mesh.tris, (1, 3)).reshape(-1)  # j (source dof)
    gx = np.broadcast_to(mesh.grads[:, None, :, 0], (t, 3, 3)).reshape(-1)
    gy = np.broadcast_to(mesh.grads[:, None, :, 1], (t, 3, 3)).reshape(-1)
    w9 = np.broadcast_to(w[:, None, None], (t, 3, 3)).reshape(-1)
    np.add.at(Dx, (rows, cols), w9 * gx)
    np.add.at(Dy, (rows, cols), w9 * gy)
    return inv_area[:, None] * Dx, inv_area[:, None] * Dy


def divergence_csr_operators(mesh: Mesh):
    """(Dx, Dy) as static CSR operators — the sparse (large-mesh) form of
    :func:`divergence_matrices`, sharing the stiffness sparsity pattern.

    The same maps as :func:`divergence`/:func:`gradient` without their
    per-call gather/segment-sum pipelines: as assembled sparse operators
    (stencil storage on pad_hole meshes) div(u) = Dx uₓ + Dy u_y and
    ∇p = (Dx p, Dy p)."""
    from tpufem.ops import assembly

    t, n = mesh.n_tris, mesh.n_nodes
    w = np.where(mesh.valid, mesh.area / 3.0, 0.0)
    ex = np.broadcast_to((w[:, None] * mesh.grads[:, :, 0])[:, None, :], (t, 3, 3))
    ey = np.broadcast_to((w[:, None] * mesh.grads[:, :, 1])[:, None, :], (t, 3, 3))
    area_sum = np.zeros(n)
    np.add.at(area_sum, mesh.tris.reshape(-1), np.repeat(w, 3))
    inv_area = 1.0 / (area_sum + _EPS_AREA)
    dx = assembly.assemble_csr(mesh, jnp.asarray(ex))
    dy = assembly.assemble_csr(mesh, jnp.asarray(ey))
    scale = jnp.asarray(inv_area)[jnp.asarray(dx.row_ids)]
    return dx.with_data(dx.data * scale), dy.with_data(dy.data * scale)


def gradient_matrices(mesh: Mesh):
    """(Gx, Gy) host NumPy (N, N) with ∇p = (Gx p, Gy p) — the lumped
    nodal gradient as dense operators (same construction as
    :func:`divergence_matrices`; identical sparsity pattern to K)."""
    return divergence_matrices(mesh)  # same weights: ∂x from grads[...,0],
    # ∂y from grads[...,1] — div(u)=Dx ux+Dy uy and ∇p=(Dx p, Dy p) share
    # the exact same per-dof coefficients.


def mass_apply(mesh: Mesh, c: jnp.ndarray) -> jnp.ndarray:
    """Matrix-free consistent-mass product M @ c (O(T), no matrix).

    Per element, (M^e c)_i = (A/12)(2c_i + c_j + c_k) — the same local
    mass as ``assembly.element_mass``."""
    area = jnp.asarray(mesh.area, dtype=c.dtype)
    valid = jnp.asarray(mesh.valid, dtype=c.dtype)
    c_loc = c[mesh.tris]  # (T,3)
    tot = c_loc.sum(axis=1, keepdims=True)
    contrib = (valid * area / 12.0)[:, None] * (tot + c_loc)
    return jax.ops.segment_sum(
        contrib.reshape(-1), jnp.asarray(mesh.tris).reshape(-1),
        num_segments=mesh.n_nodes,
    )


def convection_apply(
    mesh: Mesh, u: jnp.ndarray, c: jnp.ndarray, variant: str = "stokescolor"
) -> jnp.ndarray:
    """Matrix-free convection product C(u) @ c.

    (C c)_i = Σ_{e∋i} row_e · ū_e · (Σ_j ∇̃φ_j c_j) — the two reference
    scalings of ``assembly.element_convection`` (same math, never
    materialized):

    * ``"stokescolor"``: ∇̃ = diffs/(2|det|), row = area/3
      (``code/StokesColor.py:286-312``)
    * ``"opsplit"``: ∇̃ = diffs/det, row = 0.5·det/3 — the per-step
      rebuilt advection operator of the NS projection scripts
      (``scripts/operator_spitting_ns.py:382-430``)
    """
    dtype = c.dtype
    grads = jnp.asarray(mesh.grads, dtype=dtype)  # diffs/det (signed)
    det = jnp.asarray(mesh.det, dtype=dtype)
    area = jnp.asarray(mesh.area, dtype=dtype)
    valid = jnp.asarray(mesh.valid, dtype=dtype)
    if variant == "stokescolor":
        scale = det / (2.0 * jnp.abs(det))  # grads → diffs/(2|det|)
        row = area / 3.0
    elif variant == "opsplit":
        scale = jnp.ones_like(det)  # grads as stored
        row = 0.5 * det / 3.0  # signed area / 3
    else:
        raise ValueError(f"unknown convection variant: {variant}")
    u_c = u[mesh.tris].mean(axis=1)  # (T,2)
    gradc = jnp.einsum(
        "ti,tid->td", c[mesh.tris], grads * scale[:, None, None], precision=_HI
    )
    val = valid * row * jnp.einsum("td,td->t", u_c, gradc, precision=_HI)  # (T,)
    contrib = jnp.broadcast_to(val[:, None], (mesh.n_tris, 3)).reshape(-1)
    return jax.ops.segment_sum(
        contrib, jnp.asarray(mesh.tris).reshape(-1), num_segments=mesh.n_nodes
    )


def consistent_divergence_rhs(mesh: Mesh, u: jnp.ndarray) -> jnp.ndarray:
    """(N,) consistent pressure RHS: b_i = −∫ ∇φ_i · ū dV, element-avg ū.

    Cf. ``/root/reference/scripts/stokes_clean_for_report.py:267-307``.
    """
    grads = _f(mesh, mesh.grads)
    area = _f(mesh, mesh.area)
    valid = _f(mesh, mesh.valid)
    u_avg = u[mesh.tris].mean(axis=1)  # (T,2)
    contrib = -jnp.einsum("td,tid->ti", u_avg, grads, precision=_HI) * area[:, None]
    contrib = jnp.where(valid[:, None] != 0, contrib, 0.0)
    return jax.ops.segment_sum(
        contrib.reshape(-1), jnp.asarray(mesh.tris).reshape(-1),
        num_segments=mesh.n_nodes,
    )
