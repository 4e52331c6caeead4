"""Navier–Stokes workloads: monolithic saddle-point Stokes and
operator-split NS with implicit advection.

* :func:`solve_monolithic` — the 3N×3N coupled [u_x; u_y; p] one-shot
  steady Stokes solve of ``scripts/navier_stokes.py:260-452``: viscous
  blocks on the velocity diagonals, symmetric B/Bᵀ pressure coupling
  (−y_diffs/6, −x_diffs/6), no-slip outer walls, tangential inner-boundary
  velocity U0·(−y/r, x/r) *measured from the origin* (a reference quirk,
  navier_stokes.py:415-419 — the cylinder sits at (0.5,0.5) but the BC
  normalizes by distance from (0,0); preserved for parity), pressure
  pinned at node 0.

* :class:`NSProblem` — the projection Navier–Stokes of
  ``scripts/operator_spitting_ns.py:550-604``: the advection matrix C(u)
  is rebuilt from the current velocity every step and the velocity system
  (I + Δt·C + ν·Δt·K) is solved fresh each step (no Dirichlet surgery on
  the in-loop matrix — the reference's BC block is commented out; BCs are
  enforced on the field after projection), pressure Poisson is the
  signed-det stiffness pinned at node 0 (row-only).

Device notes: the per-step matrix changes with u, so it cannot be
factored ahead of time; the dense step re-assembles C(u) as one fused
scatter and calls ``jnp.linalg.solve`` on device.  The one-shot
monolithic solve is factored on host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.mesh.core import Mesh
from tpufem.ops import assembly, calculus
from tpufem.solve import make_dense_solver


# ---------------------------------------------------------------------------
# Monolithic saddle-point Stokes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MonolithicConfig:
    nu: float = 1.0
    U0: float = 1.0  # squirmer swimming speed (navier_stokes.py:367)
    outer_marker: int = 1
    inner_marker: int = 2
    # "lstsq" (default): min-norm least-squares.  The P1/P1 equal-order
    # saddle-point system is NOT LBB-stable — it is rank-deficient by a few
    # checkerboard pressure modes even on a clean mesh, and the reference's
    # own committed configuration (mesh2.2 read with the P1 reader,
    # orphaning all midside nodes) is outright singular, so its
    # ``jnp.linalg.solve`` returns non-finite values.  lstsq projects the
    # null modes out and returns the physical solution.
    solver: str = "lstsq"


def assemble_monolithic(mesh: Mesh, config: MonolithicConfig = MonolithicConfig()):
    """(A, b) of the 3N×3N coupled system with BCs applied (host NumPy)."""
    n = mesh.n_nodes
    total = 3 * n
    A = np.zeros((total, total))

    tris = mesh.tris
    det = mesh.det
    valid = det != 0.0  # reference skips exact zero only (navier_stokes.py:299)
    pc = mesh.coords[tris]
    x, y = pc[..., 0], pc[..., 1]
    yd = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    xd = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)

    # viscous blocks: ν (yd_i yd_j + xd_i xd_j) / (2·det_signed)
    safe = np.where(valid, det, 1.0)
    ke = (
        config.nu
        * (yd[:, :, None] * yd[:, None, :] + xd[:, :, None] * xd[:, None, :])
        / (2.0 * safe[:, None, None])
    )
    ke = np.where(valid[:, None, None], ke, 0.0)
    rows = np.repeat(tris, 3, axis=1).reshape(-1)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    np.add.at(A, (rows, cols), ke.reshape(-1))
    np.add.at(A, (rows + n, cols + n), ke.reshape(-1))

    # pressure coupling: B[p_i, u_j] += −diff_j/6 for every i (3× per elem)
    bx = np.broadcast_to((-yd / 6.0)[:, None, :], ke.shape).reshape(-1)
    by = np.broadcast_to((-xd / 6.0)[:, None, :], ke.shape).reshape(-1)
    p_rows = rows + 2 * n
    np.add.at(A, (p_rows, cols), bx)
    np.add.at(A, (p_rows, cols + n), by)
    np.add.at(A, (cols, p_rows), bx)
    np.add.at(A, (cols + n, p_rows), by)

    b = np.zeros(total)
    outer = np.nonzero(mesh.markers == config.outer_marker)[0]
    inner = np.nonzero(mesh.markers == config.inner_marker)[0]

    for idx in outer:
        for dof in (idx, idx + n):
            A[dof, :] = 0.0
            A[dof, dof] = 1.0
            b[dof] = 0.0
    coords = mesh.coords
    for idx in inner:
        px, py = coords[idx]
        r = np.hypot(px, py) or 1.0  # origin-normalized (reference quirk)
        for dof, val in ((idx, -config.U0 * py / r), (idx + n, config.U0 * px / r)):
            A[dof, :] = 0.0
            A[dof, dof] = 1.0
            b[dof] = val
    # pin p at node 0 (navier_stokes.py:425-428)
    A[2 * n, :] = 0.0
    A[2 * n, 2 * n] = 1.0
    b[2 * n] = 0.0
    return A, b


def solve_monolithic(mesh: Mesh, config: MonolithicConfig = MonolithicConfig()):
    """One-shot coupled solve → (u (N,2), p (N,), residual)."""
    A, b = assemble_monolithic(mesh, config)
    if config.solver == "lstsq":
        sol = jnp.asarray(np.linalg.lstsq(A, b, rcond=None)[0])
    else:
        solver = make_dense_solver(jnp.asarray(A), config.solver)
        sol = solver.solve(jnp.asarray(b))
    n = mesh.n_nodes
    u = jnp.stack([sol[:n], sol[n : 2 * n]], axis=1)
    p = sol[2 * n :]
    residual = jnp.linalg.norm(jnp.asarray(A) @ sol - jnp.asarray(b))
    return u, p, residual


# ---------------------------------------------------------------------------
# P2/P1 Taylor–Hood monolithic Stokes (LBB-stable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TaylorHoodConfig:
    nu: float = 1.0
    B1: float = -2.0  # squirmer gait (proper center-relative form)
    B2: float = 0.0
    center: tuple[float, float] = (0.5, 0.5)
    outer_marker: int = 1
    inner_marker: int = 2


def _p2_quadrature():
    """3-midpoint rule — exact for degree-2 integrands on a triangle."""
    pts = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
    w = np.full(3, 1.0 / 3.0)
    return pts, w


def _p2_quadrature_deg4():
    """Dunavant 6-point rule — exact to degree 4 (P2·P2 mass integrands)."""
    a1, a2 = 0.445948490915965, 0.091576213509771
    w1, w2 = 0.223381589678011, 0.109951743655322
    pts = np.array(
        [
            [1 - 2 * a1, a1, a1], [a1, 1 - 2 * a1, a1], [a1, a1, 1 - 2 * a1],
            [1 - 2 * a2, a2, a2], [a2, 1 - 2 * a2, a2], [a2, a2, 1 - 2 * a2],
        ]
    )
    w = np.array([w1, w1, w1, w2, w2, w2])
    return pts, w


_P2_PAIRS = [(1, 2), (2, 0), (0, 1)]  # midpoint k is opposite corner k


def _p2_values_at(L: np.ndarray) -> np.ndarray:
    """P2 shape values at barycentric point L → (6,)."""
    v = np.empty(6)
    for i in range(3):
        v[i] = L[i] * (2.0 * L[i] - 1.0)
    for k, (a, b) in enumerate(_P2_PAIRS):
        v[3 + k] = 4.0 * L[a] * L[b]
    return v


def _p2_grads_at_batch(L: np.ndarray, gl: np.ndarray) -> np.ndarray:
    """∇φ_a at barycentric point L for ALL elements: gl (T,3,2) → (T,6,2).

    Triangle's P2 node order: corners 1-3, then midpoints opposite each
    corner."""
    g = np.empty((gl.shape[0], 6, 2))
    for i in range(3):
        g[:, i] = (4.0 * L[i] - 1.0) * gl[:, i]
    for k, (a, b) in enumerate(_P2_PAIRS):
        g[:, 3 + k] = 4.0 * (L[a] * gl[:, b] + L[b] * gl[:, a])
    return g


def _th_element_matrices(mesh: Mesh):
    """Vectorized Taylor–Hood element matrices (replaces the per-element
    Python loop):

      ke (T,6,6)  ∫ ∇φᵢ·∇φⱼ   (3-midpoint rule, exact for degree 2)
      me (T,6,6)  ∫ φᵢ φⱼ      (Dunavant 6-point, exact for degree 4)
      bex/bey (T,3,6)  −∫ ψᵢ ∂φⱼ/∂x|y   (P1 test × P2 gradient)

    plus the pressure-node numbering (corners, p_of_node)."""
    assert mesh.tris_p2 is not None, "Taylor–Hood needs a 6-node (P2) mesh"
    tris6 = mesh.tris_p2
    n2 = mesh.coords.shape[0]
    corners = np.unique(tris6[:, :3])
    p_of_node = -np.ones(n2, dtype=np.int64)
    p_of_node[corners] = np.arange(len(corners))

    gl = mesh.grads  # (T,3,2) barycentric gradients
    area = mesh.area  # (T,)
    T = tris6.shape[0]
    ke = np.zeros((T, 6, 6))
    bex = np.zeros((T, 3, 6))
    bey = np.zeros((T, 3, 6))
    pts, wq = _p2_quadrature()
    for q in range(len(wq)):
        g6 = _p2_grads_at_batch(pts[q], gl)  # (T,6,2)
        wa = (wq[q] * area)[:, None, None]
        ke += wa * np.einsum("tid,tjd->tij", g6, g6)
        psi = pts[q]  # (3,) P1 values at the quadrature point
        bex -= wa * psi[None, :, None] * g6[:, None, :, 0]
        bey -= wa * psi[None, :, None] * g6[:, None, :, 1]
    me = np.zeros((T, 6, 6))
    pts4, wq4 = _p2_quadrature_deg4()
    for q in range(len(wq4)):
        phi = _p2_values_at(pts4[q])  # (6,)
        me += (wq4[q] * area)[:, None, None] * np.outer(phi, phi)[None]
    return ke, me, bex, bey, corners, p_of_node


def _scatter_block(A, rows, cols, elem):
    """A[rows_i, cols_j] += elem[t, i, j] for all t (dense scatter-add)."""
    ri = np.repeat(rows, cols.shape[1], axis=1).reshape(-1)
    ci = np.tile(cols, (1, rows.shape[1])).reshape(-1)
    np.add.at(A, (ri, ci), elem.reshape(-1))


def _th_bc_dofs(mesh: Mesh, config, n2: int):
    """(dirichlet velocity dofs, their values) for the squirmer TH system."""
    from tpufem import bc as bc_mod

    outer = np.nonzero(mesh.markers == config.outer_marker)[0]
    inner = np.nonzero(mesh.markers == config.inner_marker)[0]
    vals = np.zeros((len(inner), 2))
    if len(inner):
        vals = bc_mod.squirmer_values(
            mesh.coords, inner, config.center, config.B1, config.B2
        )
    dofs = np.concatenate([outer, outer + n2, inner, inner + n2])
    values = np.concatenate(
        [np.zeros(2 * len(outer)), vals[:, 0], vals[:, 1]]
    )
    return dofs.astype(np.int64), values


def assemble_taylor_hood(mesh: Mesh, config: TaylorHoodConfig = TaylorHoodConfig()):
    """(A, b, p_nodes) of the P2-velocity / P1-pressure saddle system.

    The reference bought a P2 mesh (mesh2.2) for its monolithic solver but
    read it with the P1 reader, orphaning the midside nodes and leaving an
    unstable P1/P1 pair (see assemble_monolithic).  This is the solver
    that mesh was for: LBB-stable, uniquely solvable after pinning one
    pressure dof.  DOF layout [uₓ (N2); u_y (N2); p (N1 corner nodes)].
    Assembly is fully vectorized (batched quadrature + scatter-add).
    """
    ke, _, bex, bey, corners, p_of_node = _th_element_matrices(mesh)
    tris6 = mesh.tris_p2
    n2 = mesh.coords.shape[0]
    n1 = len(corners)
    total = 2 * n2 + n1

    A = np.zeros((total, total))
    ux = tris6.astype(np.int64)
    uy = ux + n2
    pd = 2 * n2 + p_of_node[tris6[:, :3]]
    _scatter_block(A, ux, ux, config.nu * ke)
    _scatter_block(A, uy, uy, config.nu * ke)
    _scatter_block(A, pd, ux, bex)
    _scatter_block(A, pd, uy, bey)
    _scatter_block(A, ux, pd, np.swapaxes(bex, 1, 2))
    _scatter_block(A, uy, pd, np.swapaxes(bey, 1, 2))

    b = np.zeros(total)
    dofs, values = _th_bc_dofs(mesh, config, n2)
    A[dofs, :] = 0.0
    A[dofs, dofs] = 1.0
    b[dofs] = values
    pin = 2 * n2
    A[pin, :] = 0.0
    A[pin, pin] = 1.0
    b[pin] = 0.0
    return A, b, corners


def solve_taylor_hood(mesh: Mesh, config: TaylorHoodConfig = TaylorHoodConfig()):
    """→ (u (N2,2), p (N1,), residual).  Unique solve (dense LU on host)."""
    A, b, corners = assemble_taylor_hood(mesh, config)
    solver = make_dense_solver(jnp.asarray(A), "lu")
    sol = solver.solve(jnp.asarray(b))
    n2 = mesh.coords.shape[0]
    u = jnp.stack([sol[:n2], sol[n2 : 2 * n2]], axis=1)
    p = sol[2 * n2 :]
    residual = jnp.linalg.norm(jnp.asarray(A) @ sol - jnp.asarray(b))
    return u, p, residual


# ---------------------------------------------------------------------------
# Transient Taylor–Hood (θ-scheme) — the LBB-stable time-dependent squirmer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TransientTHConfig(TaylorHoodConfig):
    dt: float = 0.01
    steps: int = 200
    theta: float = 1.0  # 1 = backward Euler, 0.5 = Crank–Nicolson
    precision: str = "f64"


@dataclasses.dataclass(frozen=True)
class TransientTHProblem:
    """θ-scheme stepper on the coupled P2/P1 saddle system:

        [M/Δt + θνK   Bᵀ] [uⁿ⁺¹]   [M/Δt uⁿ − (1−θ)νK uⁿ]
        [B            0 ] [pⁿ⁺¹] = [0]

    with Dirichlet row surgery on velocity + pinned pressure.  The system
    matrix is constant, so it is factored ONCE on the host and each step
    is a single (2N₂+N₁)² matvec plus a fused RHS matvec — unlike the
    reference, whose time-dependent runs only ever use the unstable P1/P1
    projection (its committed P2 mesh is misread by the P1 loader,
    ``scripts/navier_stokes.py:363-365``).  Velocity divergence is weakly
    zero against the full P1 test space — beating the P1/P1 path's known
    accuracy ceiling (reference README.md:19: "non-zero divergence and
    checkerboarding effects limited accuracy").
    """

    mesh: Mesh
    e_inv: jnp.ndarray  # (total, total) inverse of the θ-system
    r_op: jnp.ndarray  # (2N2, 2N2) RHS operator M/Δt − (1−θ)νK
    bc_dofs: np.ndarray
    bc_values: jnp.ndarray
    corners: np.ndarray
    config: TransientTHConfig

    @classmethod
    def build(cls, mesh: Mesh, config: TransientTHConfig = TransientTHConfig()):
        from tpufem.utils.host import host_context

        with host_context():
            ke, me, bex, bey, corners, p_of_node = _th_element_matrices(mesh)
            tris6 = mesh.tris_p2
            n2 = mesh.coords.shape[0]
            n1 = len(corners)
            total = 2 * n2 + n1
            dt, th, nu = config.dt, config.theta, config.nu

            E = np.zeros((total, total))
            R = np.zeros((2 * n2, 2 * n2))
            ux = tris6.astype(np.int64)
            uy = ux + n2
            pd = 2 * n2 + p_of_node[tris6[:, :3]]
            lhs_e = me / dt + th * nu * ke
            rhs_e = me / dt - (1.0 - th) * nu * ke
            _scatter_block(E, ux, ux, lhs_e)
            _scatter_block(E, uy, uy, lhs_e)
            _scatter_block(E, pd, ux, bex)
            _scatter_block(E, pd, uy, bey)
            _scatter_block(E, ux, pd, np.swapaxes(bex, 1, 2))
            _scatter_block(E, uy, pd, np.swapaxes(bey, 1, 2))
            _scatter_block(R, ux, ux, rhs_e)
            _scatter_block(R, uy, uy, rhs_e)

            dofs, values = _th_bc_dofs(mesh, config, n2)
            E[dofs, :] = 0.0
            E[dofs, dofs] = 1.0
            R[dofs, :] = 0.0  # BC rows carry the BC value directly
            pin = 2 * n2
            E[pin, :] = 0.0
            E[pin, pin] = 1.0

            dtype = jnp.float32 if config.precision == "f32" else jnp.float64
            return cls(
                mesh=mesh,
                e_inv=jnp.asarray(np.linalg.inv(E), dtype=dtype),
                r_op=jnp.asarray(R, dtype=dtype),
                bc_dofs=dofs,
                bc_values=jnp.asarray(values, dtype=dtype),
                corners=corners,
                config=config,
            )


def th_step(problem: TransientTHProblem, u_flat: jnp.ndarray):
    """One θ-step: u_flat (2N2,) → (u_flat', p (N1,), metrics)."""
    n2 = problem.mesh.coords.shape[0]
    n1 = len(problem.corners)
    hi = jax.lax.Precision.HIGHEST  # no TF32 rounding of f32 products
    rhs_v = jnp.matmul(problem.r_op, u_flat, precision=hi)
    rhs_v = rhs_v.at[jnp.asarray(problem.bc_dofs)].set(problem.bc_values)
    rhs = jnp.concatenate([rhs_v, jnp.zeros(n1, dtype=u_flat.dtype)])
    sol = jnp.matmul(problem.e_inv, rhs, precision=hi)
    u_new = sol[: 2 * n2]
    p = sol[2 * n2 :]
    u2 = jnp.stack([u_new[:n2], u_new[n2:]], axis=1)
    div = calculus.divergence(problem.mesh, u2)
    metrics = {
        "max_u": jnp.max(jnp.abs(u_new)),
        "div_max": jnp.max(jnp.abs(div)),
    }
    return u_new, p, metrics


_TH_RUN_CACHE: dict = {}


def run_transient_th(problem: TransientTHProblem, steps: int | None = None):
    """Scan the TH stepper → (u (N2,2), p (N1,), metrics)."""
    cfg = problem.config
    n_steps = steps if steps is not None else cfg.steps
    n2 = problem.mesh.coords.shape[0]
    dtype = problem.e_inv.dtype
    u0 = jnp.zeros(2 * n2, dtype=dtype)

    key = (id(problem), n_steps)
    hit = _TH_RUN_CACHE.get(key)
    if hit is not None and hit[0] is problem:
        scan_all = hit[1]
    else:

        @jax.jit
        def scan_all(u0):
            def body(u, _):
                u_new, p, m = th_step(problem, u)
                return u_new, (p, m)

            u, (ps, ms) = jax.lax.scan(body, u0, None, length=n_steps)
            return u, ps[-1], ms

        _TH_RUN_CACHE[key] = (problem, scan_all)
    u_flat, p, metrics = scan_all(u0)
    u = jnp.stack([u_flat[:n2], u_flat[n2:]], axis=1)
    return u, p, metrics


# ---------------------------------------------------------------------------
# Operator-split Navier–Stokes (implicit advection)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NSConfig:
    dt: float = 1e-4  # operator_spitting_ns.py:479
    steps: int = 1000
    nu: float = 1.0
    rho: float = 1.0
    body_force: tuple[float, float] = (0.1, 0.0)  # channel driving force
    # (a constant 2-vector, or an (N, 2) nodal field for spatially
    # varying forcing — e.g. the rotational force of the TH cross-check,
    # benchmarks/ns_th_xcheck_r5.py; a CONSTANT force in this closed box
    # is exactly pressure-balanced, p = f·x, so the true velocity is 0)
    mass_consistent: bool = False  # scale the velocity system by the
    # lumped inverse mass: (I + Δt·M_L⁻¹C(u) + νΔt·M_L⁻¹K) u* = uⁿ + Δt·f
    # — the DIMENSIONALLY CONSISTENT weak form.  The reference's NS
    # solves (I + Δt·C + νΔt·K) u* = uⁿ + Δt·F with the RAW assembled
    # operators against nodal values (operator_spitting_ns.py:562), i.e.
    # it is missing the M⁻¹: since 2-D stiffness entries are O(1) while
    # M_L ~ h², its effective viscosity/advection scale like h² and
    # VANISH under refinement — the NS-vs-Taylor–Hood cross-check
    # (benchmarks/ns_th_xcheck_r5.py) measures the velocity deviation
    # GROWING 0.55→0.73 with h at ν=1 on a smooth forced vortex.
    # Default False = reference parity; True converges to the trusted
    # TH transient (cross-checked).  Matrix-free path only.
    double_projection: bool = False  # second pressure projection per
    # step.  The reference's NS does ONE projection per step
    # (operator_spitting_ns.py:591-598) while its flagship Stokes does
    # TWO (code/StokesColor.py:566-573) — the single-projection NS
    # leaves ~7× the normalized divergence (measured div_rel 0.15 vs
    # 0.02 at comparable sizes).  Default False = reference parity;
    # True adds the Stokes-style second projection (one more pressure
    # solve + div/grad per step)
    inner_marker: int = 2
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    precision: str = "f64"
    # Pressure operator scaling.  The committed script solves K p = −div/Δt
    # with the *unlumped* stiffness (operator_spitting_ns.py:528-533) — a
    # ~1/M_L ≈ 10³ overcorrection that blows up within ~10 steps on the
    # bundled meshes (the reference's later iterations introduced the
    # mass-lumped A_p = K/M_L as the fix, IT_FUCKING_FLOWS.py:694-702).
    # "mass_lumped" (default) is the working scheme; "raw" reproduces the
    # committed script exactly.
    pressure_scaling: str = "mass_lumped"
    # solver="dense": the parity path (per-step dense LU — the reference's
    # jnp.linalg.solve, capped at ~4k nodes).  solver="cg": the large-mesh
    # path — the advection operator is never materialized (matrix-free
    # C(u)·x via calculus.convection_apply each application), the
    # nonsymmetric velocity system runs Jacobi-BiCGStab, and the pinned
    # pressure Poisson runs (two-level-)PCG with warm starts.  O(nnz)
    # memory: the NS projection scales to the same mesh sizes as the
    # Stokes CG path.
    solver: str = "dense"
    cg_iters_visc: int = 80  # BiCGStab cap for (I + ΔtC + νΔtK)
    cg_iters_pressure: int = 160
    cg_tol: float = 1e-8  # relative residual early exit (0 → fixed count)
    cg_precond: str = "twolevel"  # pressure PCG: "jacobi" | "twolevel"
    cg_coarse_nodes: int = 2048

@dataclasses.dataclass(frozen=True)
class NSProblem:
    mesh: Mesh
    wall_mask: np.ndarray  # all outer walls + inner body (u = 0)
    config: NSConfig
    # dense (parity) path
    k_signed: jnp.ndarray | None = None  # signed-det stiffness
    pressure_solver: Any = None  # K pinned at node 0, constant → factored once
    # matrix-free (solver="cg") path
    K_csr: Any = None  # signed-det stiffness (stencil where supported)
    inv_diag_visc: jnp.ndarray | None = None  # Jacobi for the u* BiCGStab
    inv_ml: jnp.ndarray | None = None  # 1/M_L (mass_consistent=True)
    conv_refill: Any = None  # per-step C(u) stencil refill (None → the
    # gather/segment-sum convection_apply every BiCGStab iteration)

    @classmethod
    def build(cls, mesh: Mesh, config: NSConfig = NSConfig()) -> "NSProblem":
        from tpufem.utils.host import host_context

        if config.solver == "cg":
            # setup math on host (same policy as StokesProblem.build):
            # hundreds of small eager element-tensor ops, each a device
            # compile + launch otherwise
            with host_context():
                return cls._build_matfree(mesh, config)
        with host_context():
            k = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh, signed=True))
            a_p = np.asarray(k).copy()
            if config.pressure_scaling == "mass_lumped":
                m_l = np.asarray(assembly.lumped_mass(mesh))
                a_p = a_p / (m_l[:, None] + 1e-12)
            a_p[0, :] = 0.0  # row-only pin (operator_spitting_ns.py:531-533)
            a_p[0, 0] = 1.0
            dtype = jnp.float32 if config.precision == "f32" else jnp.float64
            coords = mesh.coords
            on_outer = (
                (np.abs(coords[:, 0]) < config.tol)
                | (np.abs(coords[:, 0] - config.L) < config.tol)
                | (np.abs(coords[:, 1]) < config.tol)
                | (np.abs(coords[:, 1] - config.H) < config.tol)
            )
            wall_mask = on_outer | (mesh.markers == config.inner_marker)
            from tpufem.solve.dense import DenseInverse

            pressure_solver = (
                make_dense_solver(jnp.asarray(a_p), "lu")
                if config.precision == "f64"
                else DenseInverse(inv=jnp.asarray(np.linalg.inv(a_p), dtype=dtype))
            )
            return cls(
                mesh=mesh,
                k_signed=jnp.asarray(np.asarray(k), dtype=dtype),
                pressure_solver=pressure_solver,
                wall_mask=wall_mask,
                config=config,
            )

    @classmethod
    def _build_matfree(cls, mesh: Mesh, config: NSConfig) -> "NSProblem":
        """solver="cg": O(nnz) operators + iterative solves.

        Deviations from the dense parity path, both CG-required and
        documented: the pressure Poisson uses the UNSIGNED-det stiffness
        (identical on CCW-oriented meshes — the signed form the script
        assembles is only indefinite when CW triangles exist, which the
        reference itself flags as "the cause of the instability",
        scripts/stokes_report.py:881-895), pinned at node 0 by symmetric
        masking instead of row surgery (same solution: p[0] = 0)."""
        from tpufem.ops.sparse import CSROperator  # noqa: F401
        from tpufem.ops.stencil import StencilOperator
        from tpufem.solve.matfree import PressureCG

        dtype = jnp.float32 if config.precision == "f32" else jnp.float64
        K_signed = assembly.assemble_csr(
            mesh, assembly.element_stiffness(mesh, signed=True)
        )
        K_p = assembly.assemble_csr(
            mesh, assembly.element_stiffness(mesh, signed=False)
        )

        def _mat(csr):
            """Stencil-offset SpMV where the numbering supports it (the
            fast accelerator form — CSR gather is the measured per-step
            drag at scale); CSR otherwise.  Same policy as the Stokes
            matfree build (stokes.py materialize)."""
            st = StencilOperator.build(csr, dtype=dtype)
            if st.coverage >= 0.9:
                return st
            return csr.with_data(csr.data.astype(dtype))

        # per-step stencil refill of C(u): one segment-sum per step
        # instead of one per BiCGStab iteration (ops/stencil.py)
        from tpufem.ops.stencil import StencilRefill

        conv_refill = StencilRefill.build(mesh, dtype=dtype)
        if conv_refill.template.coverage < 0.9:
            conv_refill = None
        if config.pressure_scaling == "mass_lumped":
            m_l = np.asarray(assembly.lumped_mass(mesh))
        else:  # "raw": K p = b directly (operator_spitting_ns.py:528-533)
            m_l = np.ones(mesh.n_nodes)
        coords = mesh.coords
        on_outer = (
            (np.abs(coords[:, 0]) < config.tol)
            | (np.abs(coords[:, 0] - config.L) < config.tol)
            | (np.abs(coords[:, 1]) < config.tol)
            | (np.abs(coords[:, 1] - config.H) < config.tol)
        )
        wall_mask = on_outer | (mesh.markers == config.inner_marker)
        # inert nodes (pad_hole dummies: no valid incident triangle) pinned
        # to u = 0 — their rows are ~identity, so without this the body
        # force integrates them up linearly step over step
        deg = np.zeros(mesh.n_nodes)
        np.add.at(
            deg, np.asarray(mesh.tris).reshape(-1),
            np.repeat(np.asarray(mesh.valid, dtype=np.float64), 3),
        )
        wall_mask = wall_mask | (deg == 0)

        empty = np.zeros(0, dtype=np.int64)
        active = jnp.ones(mesh.n_nodes, dtype=dtype)
        lmax, tl = 0.0, None
        diag_p = K_p.diag()
        K_p_op = _mat(K_p)
        if config.cg_precond == "twolevel":
            from tpufem.solve.cg import estimate_lmax
            from tpufem.solve.twolevel import build_twolevel

            inv_diag_p = jnp.where(
                diag_p > 0, 1.0 / jnp.where(diag_p > 0, diag_p, 1.0), 1.0
            )
            lmax = estimate_lmax(K_p_op.matvec, inv_diag_p, mesh.n_nodes)
            tl = build_twolevel(
                K_p, np.asarray(coords), K_p_op.matvec, inv_diag_p,
                target_coarse=config.cg_coarse_nodes, dtype=dtype, lmax=lmax,
            )
        pressure_solver = PressureCG(
            K_merged=K_p_op,
            m_lumped=jnp.asarray(m_l, dtype=dtype),
            masters=empty,
            slaves=empty,
            active_mask=active,
            iters=config.cg_iters_pressure,
            precond=config.cg_precond,
            lmax=lmax,
            twolevel=tl,
            tol=config.cg_tol,
            pin=0,
        )
        inv_ml = None
        if config.mass_consistent:
            ml_full = np.asarray(assembly.lumped_mass(mesh))
            inv_ml = jnp.asarray(
                np.where(ml_full > 0, 1.0 / np.where(ml_full > 0, ml_full, 1.0), 1.0),
                dtype=dtype,
            )
            inv_diag_visc = 1.0 / (
                1.0 + config.nu * config.dt * inv_ml * jnp.abs(K_signed.diag())
            )
        else:
            inv_diag_visc = 1.0 / (
                1.0 + config.nu * config.dt * jnp.abs(K_signed.diag())
            )

        return cls(
            mesh=mesh,
            wall_mask=wall_mask,
            config=config,
            K_csr=_mat(K_signed),
            conv_refill=conv_refill,
            pressure_solver=pressure_solver,
            inv_diag_visc=jnp.asarray(inv_diag_visc, dtype=dtype),
            inv_ml=inv_ml,
        )


def _ns_step_matfree(problem: NSProblem, u: jnp.ndarray, p0: jnp.ndarray):
    """One operator-split NS step, matrix-free (solver="cg").

    Same math as :func:`ns_step` (operator_spitting_ns.py:557-604) with
    the three dense solves replaced by iterative ones:

    * u*: (I + Δt·C(u) + ν·Δt·K) is NONSYMMETRIC (convection) — solved
      per component with Jacobi-BiCGStab, warm-started from uⁿ; C(u)·x
      is applied matrix-free every iteration (opsplit scaling), so the
      per-step operator rebuild the reference pays
      (operator_spitting_ns.py:559) costs nothing here.
    * pressure: pinned (two-level-)PCG warm-started from pⁿ⁻¹.
    """
    from tpufem.solve.cg import bicgstab_fixed

    cfg = problem.config
    mesh = problem.mesh
    dt = cfg.dt
    dtype = u.dtype

    if problem.conv_refill is not None:
        C_op = problem.conv_refill.refill_flat(
            assembly.element_convection_flat(mesh, u, variant="opsplit")
        )
        conv = C_op.matvec
    else:
        conv = lambda x: calculus.convection_apply(
            mesh, u, x, variant="opsplit"
        )

    if cfg.mass_consistent:
        iml = problem.inv_ml.astype(dtype)

        def a_mv(x):
            return x + dt * iml * conv(x) + cfg.nu * dt * (
                iml * problem.K_csr.matvec(x)
            )
    else:
        def a_mv(x):
            return x + dt * conv(x) + cfg.nu * dt * problem.K_csr.matvec(x)

    precond = lambda r: problem.inv_diag_visc.astype(dtype) * r
    f = jnp.asarray(cfg.body_force, dtype=dtype)
    cols = []
    for c in range(2):
        fc = f[:, c] if f.ndim == 2 else f[c]
        xc, _ = bicgstab_fixed(
            a_mv, u[:, c] + dt * fc, x0=u[:, c],
            iters=cfg.cg_iters_visc, precond=precond,
        )
        cols.append(xc)
    u_star = jnp.stack(cols, axis=1)

    div = calculus.divergence(mesh, u_star).astype(dtype)
    b_p = -(cfg.rho / dt) * div
    p = problem.pressure_solver.solve(b_p, x0=p0)
    u_new = u_star - dt * calculus.gradient(mesh, p).astype(dtype)
    if cfg.double_projection:
        div2 = calculus.divergence(mesh, u_new).astype(dtype)
        p2 = problem.pressure_solver.solve(-(cfg.rho / dt) * div2, x0=p)
        u_new = u_new - dt * calculus.gradient(mesh, p2).astype(dtype)
    u_new = jnp.where(jnp.asarray(problem.wall_mask)[:, None], 0.0, u_new)
    metrics = {
        "max_u": jnp.max(jnp.abs(u_new)),
        "max_p": jnp.max(jnp.abs(p)),
        "div_star_max": jnp.max(jnp.abs(div)),
    }
    return u_new, p, metrics


def ns_step(problem: NSProblem, u: jnp.ndarray):
    """One operator-split NS step (operator_spitting_ns.py:557-604)."""
    cfg = problem.config
    mesh = problem.mesh
    dt = cfg.dt
    n = mesh.n_nodes
    dtype = u.dtype

    c_adv = assembly.assemble_dense(
        mesh, assembly.element_convection(mesh, u, variant="opsplit")
    )
    a_new = jnp.eye(n, dtype=dtype) + dt * c_adv + cfg.nu * dt * problem.k_signed
    rhs = u + dt * jnp.asarray(cfg.body_force, dtype=dtype)
    u_star = jnp.linalg.solve(a_new, rhs)  # both components in one call

    div = calculus.divergence(mesh, u_star).astype(dtype)
    b_p = -(cfg.rho / dt) * div
    b_p = b_p.at[0].set(0.0)
    p = problem.pressure_solver.solve(b_p)
    u_new = u_star - dt * calculus.gradient(mesh, p).astype(dtype)
    u_new = jnp.where(jnp.asarray(problem.wall_mask)[:, None], 0.0, u_new)
    metrics = {
        "max_u": jnp.max(jnp.abs(u_new)),
        "max_p": jnp.max(jnp.abs(p)),
        "div_star_max": jnp.max(jnp.abs(div)),
    }
    return u_new, metrics


_RUN_CACHE: dict[tuple[int, int], Any] = {}


def run(problem: NSProblem, steps: int | None = None,
        host_loop: bool = False, chunk: int = 1, state=None,
        return_state: bool = False):
    """Scan the NS stepper; returns (u, metrics).

    ``state=(u, p)`` continues from a previous run's fields instead of
    rest and ``return_state=True`` appends the ``(u, p)`` carry to the
    return (host_loop path only) — used by the bench's steady-state
    (warm-continued) throughput column.

    ``host_loop=True`` drives one jitted step from a Python loop instead
    of one scanned program (final-step metrics only, matching the
    ``th_sparse.run`` convention): one compiled program serves any step
    count, and ``state=`` continuation needs no recompile.  ``chunk > 1``
    (host_loop only) scans that many steps per dispatch — ~chunk× less
    per-dispatch overhead.  ``n_steps`` must be divisible by it.
    """
    cfg = problem.config
    n_steps = steps if steps is not None else cfg.steps
    dtype = jnp.float32 if cfg.precision == "f32" else jnp.float64
    u0 = jnp.zeros((problem.mesh.n_nodes, 2), dtype=dtype)

    if host_loop:
        key = (id(problem), -1, chunk)
        hit = _RUN_CACHE.get(key)
        if hit is not None and hit[0] is problem:
            step = hit[1]
        elif cfg.solver == "cg":
            def chunk_body(u, p):
                if chunk > 1:
                    def body(carry, _):
                        un, pn, mets = _ns_step_matfree(problem, *carry)
                        return (un, pn), mets

                    (u, p), mets = jax.lax.scan(
                        body, (u, p), None, length=chunk
                    )
                    return u, p, jax.tree_util.tree_map(
                        lambda x: x[-1], mets
                    )
                return _ns_step_matfree(problem, u, p)

            step = jax.jit(chunk_body)
            _RUN_CACHE[key] = (problem, step)
        else:
            step = jax.jit(
                lambda u, p: ns_step(problem, u) + (p,)
            )  # (u, metrics, p) — dense path carries no pressure
            _RUN_CACHE[key] = (problem, step)
        if state is not None:
            u, p = state
        else:
            u = u0
            p = jnp.zeros(problem.mesh.n_nodes, dtype=dtype)
        if cfg.solver == "cg":
            assert n_steps % chunk == 0, (n_steps, chunk)
            for _ in range(n_steps // chunk):
                u, p, mets = step(u, p)
        else:
            for _ in range(n_steps):
                u, mets, p = step(u, p)
        if return_state:
            return u, mets, (u, p)
        return u, mets

    key = (id(problem), n_steps)
    hit = _RUN_CACHE.get(key)
    if hit is not None and hit[0] is problem:
        scan_all = hit[1]
    elif cfg.solver == "cg":
        # carry (u, p): the previous pressure warm-starts the PCG — near
        # steady state the early-exit solve finishes in a few iterations
        p0 = jnp.zeros(problem.mesh.n_nodes, dtype=dtype)

        @jax.jit
        def scan_all(u0):
            def body(carry, _):
                u, p = carry
                u_new, p_new, metrics = _ns_step_matfree(problem, u, p)
                return (u_new, p_new), metrics

            (u, _), metrics = jax.lax.scan(
                body, (u0, p0), None, length=n_steps
            )
            return u, metrics

        _RUN_CACHE[key] = (problem, scan_all)
    else:

        @jax.jit
        def scan_all(u0):
            return jax.lax.scan(lambda u, _: ns_step(problem, u), u0, None, length=n_steps)

        _RUN_CACHE[key] = (problem, scan_all)
    return scan_all(u0)
