"""Steady FEM Poisson solver — parity workload for ``code/poisson.py``.

Pipeline (cites are reference lines the behavior mirrors):
  assemble K (signed-determinant variant) and load −∫gφ  (poisson.py:100-146)
  → periodic x-pairs, wall pairs filtered                (poisson.py:221-246)
  → master/slave elimination                             (poisson.py:187-213)
  → Dirichlet rows: walls (y≈0,H) = outer value, inner-marker nodes =
    inner value, inner winning on overlap                (poisson.py:258-278)
  → one linear solve (dense LU on device, or deflated CG).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np

from tpufem import bc
from tpufem.mesh.core import Mesh
from tpufem.ops import assembly
from tpufem.solve import make_dense_solver


def default_source(x, y):
    """g(x, y) = 50 sin(3y) (poisson.py:235-236)."""
    return 50.0 * jnp.sin(3.0 * y)


@dataclasses.dataclass
class PoissonConfig:
    g_source: Callable | float = default_source
    inner_marker: int = 2
    outer_value: float = 1.0  # top/bottom walls (poisson.py:23)
    inner_value: float = 0.0  # inner circle    (poisson.py:24)
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    signed_det: bool = True  # reference buildFemSystem divides by signed det
    periodic: bool = True
    solver: str = "lu"  # "lu" | "inverse" (dense, ≤~4k nodes) | "cg":
    # matrix-free BiCGStab on the EXACT row-surgery operator
    # (bc.bc_surgery_csr — the same matrix the dense path factors, so
    # solutions agree to solver tolerance), O(nnz) memory; the only path
    # at ≥100k nodes (reference meshes cap at 1067, code/poisson.py:283)
    cg_iters: int = 2000
    cg_tol: float = 1e-10
    cg_precond: str = "twolevel"  # | "jacobi"
    cg_coarse_nodes: int = 2048
    precision: str = "f64"  # "f32": cast the surgery operator + rhs (half
    # the bytes per matvec); the dense parity paths stay f64


def build_system(mesh: Mesh, config: PoissonConfig = PoissonConfig()):
    """Assemble the BC-applied (A, b) system. Returns (A, b, boundary).

    Runs on the host backend (setup-time work; see utils.host)."""
    from tpufem.utils.host import host_context

    with host_context():
        return _build_system(mesh, config)


def _build_system(mesh: Mesh, config: PoissonConfig):
    ke = assembly.element_stiffness(mesh, signed=config.signed_det)
    A = assembly.assemble_dense(mesh, ke)
    b = assembly.load_vector(
        mesh, config.g_source, signed_area=config.signed_det, negate=True
    )

    boundary = bc.ChannelBoundary.build(
        mesh, inner_marker=config.inner_marker, L=config.L, H=config.H, tol=config.tol
    )
    if config.periodic and len(boundary.masters):
        A, b = bc.periodic_elimination(A, b, boundary.masters, boundary.slaves)

    # Dirichlet: inner value wins where a node is both wall and inner
    # (reference checks is_inner_boundary first, poisson.py:276-278)
    values = np.full(len(boundary.dirichlet), config.outer_value)
    inner_set = set(boundary.inner.tolist())
    for i, node in enumerate(boundary.dirichlet):
        if int(node) in inner_set:
            values[i] = config.inner_value
    A = bc.dirichlet_rows(A, boundary.dirichlet)
    b = b.at[jnp.asarray(boundary.dirichlet)].set(jnp.asarray(values, dtype=b.dtype))
    return A, b, boundary


def solve(mesh: Mesh, config: PoissonConfig = PoissonConfig()):
    """Solve the Poisson problem; returns (f, residual_norm)."""
    if config.solver == "cg":
        return solve_cg(mesh, config)
    A, b, _ = build_system(mesh, config)
    solver = make_dense_solver(A, config.solver)
    f = solver.solve(b)
    residual = jnp.linalg.norm(A @ f - b)
    return f, residual


def build_system_csr(mesh: Mesh, config: PoissonConfig = PoissonConfig()):
    """Matrix-free twin of :func:`build_system`: the BC-row-surgery
    operator as CSR (stencil-offset where the numbering supports it) plus
    the BC-applied load — same matrix/rhs the dense path materializes
    (``code/poisson.py:187-278``), O(nnz) host work."""
    from tpufem.ops.stencil import StencilOperator
    from tpufem.utils.host import host_context

    with host_context():
        ke = assembly.element_stiffness(mesh, signed=config.signed_det)
        K = assembly.assemble_csr(mesh, ke)
        b = assembly.load_vector(
            mesh, config.g_source, signed_area=config.signed_det, negate=True
        )
        boundary = bc.ChannelBoundary.build(
            mesh, inner_marker=config.inner_marker, L=config.L, H=config.H,
            tol=config.tol,
        )
        masters = boundary.masters if config.periodic else np.zeros(0, np.int64)
        slaves = boundary.slaves if config.periodic else np.zeros(0, np.int64)
        K_mod, b = bc.bc_surgery_csr(K, masters, slaves,
                                     boundary.dirichlet, b=b)
        values = np.full(len(boundary.dirichlet), config.outer_value)
        inner_set = set(boundary.inner.tolist())
        for i, node in enumerate(boundary.dirichlet):
            if int(node) in inner_set:
                values[i] = config.inner_value
        b = b.at[jnp.asarray(boundary.dirichlet)].set(
            jnp.asarray(values, dtype=b.dtype)
        )
        st = StencilOperator.build(K_mod, dtype=b.dtype)
        op = st if st.coverage >= 0.9 else K_mod
        return op, K_mod, b, boundary


def make_cg_solver(mesh: Mesh, config: PoissonConfig = PoissonConfig()):
    """(run, op, b, boundary) for the matrix-free path: ``run(b)`` is the
    jitted BiCGStab solve on the exact row-surgery operator (split out of
    :func:`solve_cg` so benchmarks can time build/compile/solve apart)."""
    from tpufem.solve.cg import bicgstab_fixed

    op, K_csr, b, boundary = build_system_csr(mesh, config)
    if config.precision == "f32":
        op = op.astype(jnp.float32)
        b = b.astype(jnp.float32)
    diag = op.diag()
    inv_diag = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1.0), 1.0)
    if config.cg_precond == "twolevel":
        from tpufem.solve.twolevel import (build_twolevel,
                                           twolevel_preconditioner)

        tl = build_twolevel(
            K_csr, np.asarray(mesh.coords), op.matvec, inv_diag,
            target_coarse=config.cg_coarse_nodes, dtype=b.dtype,
        )
        precond = twolevel_preconditioner(op.matvec, inv_diag, tl)
    else:
        precond = lambda r: inv_diag * r

    import jax

    @jax.jit
    def run(b):
        return bicgstab_fixed(
            op.matvec, b, iters=config.cg_iters, precond=precond,
            tol=config.cg_tol,
        )

    return run, op, b, boundary


def solve_cg(mesh: Mesh, config: PoissonConfig = PoissonConfig()):
    """Matrix-free Poisson: Jacobi/two-level right-preconditioned
    BiCGStab on the exact row-surgery operator (nonsymmetric at the
    constraint/Dirichlet rows, SPD elsewhere).  Matches the dense path to
    solver tolerance; scales to ≥1M nodes (``benchmarks/poisson_r4``)."""
    run, op, b, _ = make_cg_solver(mesh, config)
    f, res = run(b)
    return f, res
