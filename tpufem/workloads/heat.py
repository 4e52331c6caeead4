"""Implicit-Euler heat equation — parity workload for ``code/heatEq.py``.

Reference quirks preserved exactly (SURVEY.md Appendix B):
  * BC surgery (periodic elimination + Dirichlet rows) is applied to the
    *stiffness* matrix first, and only then A = I + dt·K_modified
    (heatEq.py:240-305) — so Dirichlet diagonals become 1+dt and periodic
    slave rows (1+dt, −dt); the per-step field re-application
    (u[slave]=u[master]; walls=1, inner=0) is what actually enforces BCs.
  * The RHS source is deliberately zeroed: rhs = u + dt·b·0 (heatEq.py:322).

Structure: the system is LU-factored once; the whole run is one
``lax.scan`` whose body is two triangular solves + two fused scatters.
The reference instead calls O(N³) ``np.linalg.solve`` on the same matrix
600 times (heatEq.py:323).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from tpufem import bc
from tpufem.mesh.core import Mesh
from tpufem.ops import assembly
from tpufem.solve import make_dense_solver
from tpufem.workloads.poisson import PoissonConfig, build_system, default_source


@dataclasses.dataclass
class HeatConfig:
    dt: float = 0.02  # heatEq.py:304
    steps: int = 600  # heatEq.py:320
    g_source: Callable | float = default_source
    inner_marker: int = 2
    outer_value: float = 1.0
    inner_value: float = 0.0
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    solver: str = "lu"  # "lu" | "inverse" (dense, ≤~4k nodes) | "cg":
    # matrix-free BiCGStab on A = I + dt·K_mod with the EXACT row-surgery
    # operator (bc.bc_surgery_csr — same matrix the dense path factors,
    # reference quirks included), warm-started from uⁿ; the only path at
    # ≥100k nodes (reference meshes cap at 1067, code/heatEq.py:320-333)
    precision: str = "f64"  # "f32": host-factored inverse applied as f32
    # matvecs (like StokesConfig.precision)
    cg_iters: int = 100
    cg_tol: float = 1e-10


@dataclasses.dataclass(frozen=True)
class HeatProblem:
    solver: object
    boundary: bc.ChannelBoundary
    dirichlet_values: jnp.ndarray
    config: HeatConfig

    @classmethod
    def build(cls, mesh: Mesh, config: HeatConfig = HeatConfig()) -> "HeatProblem":
        from tpufem.utils.host import host_context

        with host_context():
            return cls._build(mesh, config)

    @classmethod
    def _build(cls, mesh: Mesh, config: HeatConfig) -> "HeatProblem":
        pcfg = PoissonConfig(
            g_source=config.g_source,
            inner_marker=config.inner_marker,
            outer_value=config.outer_value,
            inner_value=config.inner_value,
            L=config.L,
            H=config.H,
            tol=config.tol,
        )
        if config.solver == "cg":
            return _build_heat_matfree(mesh, config, pcfg)
        K, _, boundary = build_system(mesh, pcfg)  # BC-applied stiffness
        n = K.shape[0]
        A = jnp.eye(n, dtype=K.dtype) + config.dt * K  # heatEq.py:305
        values = np.full(len(boundary.dirichlet), config.outer_value)
        inner_set = set(boundary.inner.tolist())
        for i, node in enumerate(boundary.dirichlet):
            if int(node) in inner_set:
                values[i] = config.inner_value
        if config.precision == "f32":
            from tpufem.solve.dense import DenseInverse

            solver = DenseInverse(
                inv=jnp.asarray(np.linalg.inv(np.asarray(A)), dtype=jnp.float32)
            )
            values = values.astype(np.float32)
        else:
            solver = make_dense_solver(A, config.solver)
        return cls(
            solver=solver,
            boundary=boundary,
            dirichlet_values=jnp.asarray(values),
            config=config,
        )


@dataclasses.dataclass(frozen=True)
class _MatfreeHeatSolver:
    """Per-step BiCGStab on ``A x = x + dt·K_mod x = b`` — K_mod is the
    exact row-surgery operator of the dense path, so trajectories agree
    to solver tolerance.  Warm-started from the RHS (uⁿ⁺¹ ≈ uⁿ: at
    dt·λ ≪ 1 the system is identity-dominated — a handful of iterations
    per step)."""

    op: object  # stencil/CSR K_mod
    inv_diag: jnp.ndarray
    dt: float
    iters: int
    tol: float

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        from tpufem.solve.cg import bicgstab_fixed

        mv = lambda x: x + self.dt * self.op.matvec(x)
        pre = lambda r: self.inv_diag.astype(b.dtype) * r
        x, _ = bicgstab_fixed(
            mv, b, x0=b, iters=self.iters, precond=pre, tol=self.tol
        )
        return x


def _build_heat_matfree(mesh, config, pcfg):
    from tpufem.workloads.poisson import build_system_csr

    op, _, _, boundary = build_system_csr(mesh, pcfg)
    dtype = jnp.float32 if config.precision == "f32" else jnp.float64
    op = op.astype(dtype)
    diag_a = 1.0 + config.dt * op.diag()
    inv_diag = jnp.where(diag_a != 0, 1.0 / diag_a, 1.0)
    values = np.full(len(boundary.dirichlet), config.outer_value)
    inner_set = set(boundary.inner.tolist())
    for i, node in enumerate(boundary.dirichlet):
        if int(node) in inner_set:
            values[i] = config.inner_value
    solver = _MatfreeHeatSolver(
        op=op, inv_diag=inv_diag.astype(dtype), dt=config.dt,
        iters=config.cg_iters, tol=config.cg_tol,
    )
    return HeatProblem(
        solver=solver,
        boundary=boundary,
        dirichlet_values=jnp.asarray(values.astype(
            np.float32 if config.precision == "f32" else np.float64
        )),
        config=config,
    )


def apply_field_bcs(problem: HeatProblem, u: jnp.ndarray) -> jnp.ndarray:
    """Periodic copy then Dirichlet overwrite (heatEq.py:324-325 order)."""
    b = problem.boundary
    if len(b.masters):
        u = bc.apply_periodic_field(u, b.masters, b.slaves)
    return bc.apply_dirichlet_field(
        u, b.dirichlet, problem.dirichlet_values.astype(u.dtype)
    )


def initial_state(problem: HeatProblem, n: int) -> jnp.ndarray:
    dtype = jnp.float32 if problem.config.precision == "f32" else jnp.float64
    u = jnp.zeros(n, dtype=dtype)
    return apply_field_bcs(problem, u)


def make_step(problem: HeatProblem):
    def step(u, _):
        u = problem.solver.solve(u)  # rhs = u + dt·b·0 = u (heatEq.py:322)
        u = apply_field_bcs(problem, u)
        return u, jnp.max(jnp.abs(u))

    return step


_RUN_CACHE: dict = {}


def run(mesh: Mesh, config: HeatConfig = HeatConfig(), steps: int | None = None):
    """Run the full heat simulation; returns (u_final, per-step max|u|)."""
    problem = HeatProblem.build(mesh, config)
    u0 = initial_state(problem, mesh.n_nodes)
    n_steps = steps if steps is not None else config.steps

    key = (id(problem), n_steps)
    hit = _RUN_CACHE.get(key)
    if hit is not None and hit[0] is problem:
        scan_all = hit[1]
    else:
        step = make_step(problem)

        @jax.jit
        def scan_all(u0):
            return jax.lax.scan(step, u0, None, length=n_steps)

        _RUN_CACHE[key] = (problem, scan_all)

    u, maxu = scan_all(u0)
    return u, maxu
