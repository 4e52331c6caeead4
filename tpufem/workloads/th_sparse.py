"""Sparse (matrix-free) Taylor–Hood Stokes: the LBB-stable path at scale.

:class:`~tpufem.workloads.navier_stokes.TransientTHProblem`
factors the dense (2N₂+N₁)² saddle matrix on the host — fine for the
reference's 1004-dof parity mesh, toy-bound beyond.  This module solves the same θ-scheme P2/P1 system with
**CSR operators + Uzawa-CG on the pressure Schur complement**, O(nnz)
memory and work:

    [A   Bᵀ][u]   [r]        A = M₂/Δt + θ ν K₂   (per component, masked)
    [B   0 ][p] = [g]        B = −∫ ψ ∂φ — the P1×P2 divergence blocks

* outer: preconditioned CG on  S p = B A⁻¹ r − g,  S = B A⁻¹ Bᵀ, with
  the **Cahouet–Chabard** preconditioner  S̃⁻¹ = ν M_p⁻¹ + (Δt)⁻¹ K_p⁻¹
  (lumped P1 pressure mass + a few Jacobi-PCG sweeps on the P1 pressure
  Laplacian) — the classic spectrally-equivalent choice for transient
  Stokes, giving near mesh- and dt-independent outer counts;
* inner: Jacobi-PCG on the SPD masked velocity operator (mass-dominated
  for Δt ≪ 1 → a handful of iterations);
* Dirichlet velocity BCs by lifting: u = ũ + u_bc with ũ ≡ 0 on the
  boundary, the BC load precomputed once (constant squirmer values);
* the constant pressure nullspace (enclosed flow) by deflation.

Everything is jnp under ``lax.scan`` — runs identically on CPU and GPU.
Beats the reference's accuracy ceiling (its P1/P1 projection, see
``docs/PARITY.md §7``) at sizes its dense solves could never reach.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.mesh.core import Mesh
from tpufem.ops import assembly
from tpufem.solve.cg import cg_fixed
from tpufem.workloads.navier_stokes import _th_bc_dofs, _th_element_matrices


def _mv(op, x: jnp.ndarray) -> jnp.ndarray:
    """CSR matvec batched over trailing columns ((N,) or (N, k))."""
    if x.ndim == 1:
        return op.matvec(x)
    return jax.vmap(op.matvec, in_axes=1, out_axes=1)(x)


@dataclasses.dataclass
class SparseTHConfig:
    dt: float = 0.01
    steps: int = 200
    theta: float = 1.0  # 1 = backward Euler, 0.5 = Crank–Nicolson
    nu: float = 1.0
    B1: float = -2.0
    B2: float = 0.0
    body_force: tuple[float, float] = (0.0, 0.0)  # constant volume force
    # (consistent-mass load M₂·f per component) — lets the transient TH
    # stepper reproduce the NS channel configuration (all-wall no-slip,
    # B1=B2=0, f=(0.1,0)) as the trusted discretization for the NS
    # cross-check (at the NS rows' dt=1e-4 impulsive
    # horizons |u|~3e-5, so the advection term ~u²/h ~ 1e-7·f is
    # negligible and transient TH Stokes is the right oracle)
    center: tuple[float, float] = (0.5, 0.5)
    outer_marker: int = 1
    inner_marker: int = 2
    precision: str = "f64"
    iters_inner: int = 30  # velocity CG per Schur matvec
    iters_outer: int = 25  # Schur CG per step (warm-started)
    iters_plap: int = 8  # pressure-Laplacian sweeps per CC application
    precond_inner: str = "jacobi"  # | "twolevel": aggregation coarse-grid
    # correction on the velocity operator M₂/Δt + θνK₂ — its Jacobi-CG
    # iteration count grows ∝ √(Δt·ν/h²) with refinement, the two-level
    # count stays ~O(10) (each application costs 2 extra operator
    # matvecs, so it wins once Jacobi needs ≳3× the iterations)
    coarse_nodes: int = 1024  # twolevel target coarse-space size


@dataclasses.dataclass(frozen=True)
class SparseTHProblem:
    mesh: Mesh  # P2 mesh (tris_p2 set)
    K2: Any  # (N2, N2) P2 stiffness CSR
    M2: Any  # (N2, N2) P2 consistent mass CSR
    Bx: Any  # (N1, N2) pressure-velocity coupling (x)
    By: Any
    BxT: Any  # transposes (explicit CSR — column access is row access)
    ByT: Any
    Kp: Any  # (N1, N1) P1 pressure Laplacian (corner triangulation)
    mp_lumped: jnp.ndarray  # (N1,) lumped P1 pressure mass
    vel_mask: jnp.ndarray  # (N2,) 1.0 at interior velocity dofs
    u_bc: jnp.ndarray  # (N2, 2) Dirichlet values (0 elsewhere)
    corners: np.ndarray  # (N1,) pressure dof → P2 node id
    pmesh: Mesh  # corner (P1) triangulation — pressure space + diagnostics
    config: SparseTHConfig
    tl_vel: Any = None  # solve.twolevel.TwoLevel on M₂/Δt + θνK₂
    # (precond_inner="twolevel")

    @property
    def n2(self) -> int:
        return self.mesh.coords.shape[0]

    @property
    def n1(self) -> int:
        return len(self.corners)

    @classmethod
    def build(cls, mesh: Mesh, config: SparseTHConfig = SparseTHConfig()):
        from tpufem.utils.host import host_context

        assert mesh.tris_p2 is not None, "sparse TH needs a P2 mesh (p2_refine)"
        with host_context():
            ke, me, bex, bey, corners, p_of_node = _th_element_matrices(mesh)
            tris6 = np.asarray(mesh.tris_p2, dtype=np.int64)
            n2 = mesh.coords.shape[0]
            n1 = len(corners)
            dtype = jnp.float32 if config.precision == "f32" else jnp.float64

            pconn = p_of_node[tris6[:, :3]]  # (T, 3) pressure dofs
            K2 = assembly.assemble_csr_conn(tris6, tris6, ke, (n2, n2))
            M2 = assembly.assemble_csr_conn(tris6, tris6, me, (n2, n2))
            Bx = assembly.assemble_csr_conn(pconn, tris6, bex, (n1, n2))
            By = assembly.assemble_csr_conn(pconn, tris6, bey, (n1, n2))
            BxT = assembly.assemble_csr_conn(
                tris6, pconn, np.swapaxes(bex, 1, 2), (n2, n1)
            )
            ByT = assembly.assemble_csr_conn(
                tris6, pconn, np.swapaxes(bey, 1, 2), (n2, n1)
            )

            # P1 pressure Laplacian + lumped mass on the corner triangulation
            from tpufem.mesh.core import mesh_from_arrays

            corner_tris = p_of_node[np.asarray(mesh.tris, dtype=np.int64)]
            pmesh = mesh_from_arrays(
                mesh.coords[corners], corner_tris.astype(np.int32),
                np.asarray(mesh.markers)[corners],
            )
            Kp = assembly.assemble_csr(
                pmesh, assembly.element_stiffness(pmesh)
            )
            mp = np.asarray(assembly.lumped_mass(pmesh))

            dofs, values = _th_bc_dofs(mesh, config, n2)
            mask = np.ones(n2)
            ubc = np.zeros((n2, 2))
            mask[dofs % n2] = 0.0
            ubc[dofs % n2, dofs // n2] = values

            def cast(op):
                return op.with_data(op.data.astype(dtype))

            tl_vel = None
            if config.precond_inner == "twolevel":
                from tpufem.solve.twolevel import build_twolevel

                # assemble_csr_conn on identical connectivity yields an
                # identical sparsity pattern, so the velocity operator's
                # CSR is a data-level combination
                assert np.array_equal(M2.indices, K2.indices), (
                    "M2/K2 pattern mismatch — cannot combine for twolevel"
                )
                a_vel = K2.with_data(
                    np.asarray(M2.data) / config.dt
                    + (config.theta * config.nu) * np.asarray(K2.data)
                )
                diag_v = np.asarray(a_vel.diag())
                inv_diag = jnp.asarray(
                    np.where(mask > 0, 1.0 / diag_v, 1.0), dtype=dtype
                )
                mask_j = jnp.asarray(mask, dtype=dtype)
                masked_mv = lambda x: (
                    mask_j * a_vel.matvec(mask_j * x) + (1.0 - mask_j) * x
                )
                tl_vel = build_twolevel(
                    a_vel, np.asarray(mesh.coords), masked_mv, inv_diag,
                    target_coarse=config.coarse_nodes, dtype=dtype,
                )

            return cls(
                mesh=mesh,
                K2=cast(K2), M2=cast(M2),
                Bx=cast(Bx), By=cast(By), BxT=cast(BxT), ByT=cast(ByT),
                Kp=cast(Kp),
                mp_lumped=jnp.asarray(mp, dtype=dtype),
                vel_mask=jnp.asarray(mask, dtype=dtype),
                u_bc=jnp.asarray(ubc, dtype=dtype),
                corners=corners,
                pmesh=pmesh,
                config=config,
                tl_vel=tl_vel,
            )

    # -- operators ---------------------------------------------------------

    def vel_op(self, x: jnp.ndarray) -> jnp.ndarray:
        """A x = m∘((M₂/Δt + θνK₂)(m∘x)) + (1−m)∘x, batched (N2, k)."""
        cfg = self.config
        m = self.vel_mask if x.ndim == 1 else self.vel_mask[:, None]
        xm = m * x
        ax = _mv(self.M2, xm) / cfg.dt + (cfg.theta * cfg.nu) * _mv(self.K2, xm)
        return m * ax + (1.0 - m) * x

    def vel_op_unmasked(self, x: jnp.ndarray) -> jnp.ndarray:
        cfg = self.config
        return _mv(self.M2, x) / cfg.dt + (cfg.theta * cfg.nu) * _mv(self.K2, x)

    def b_apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """(N2, 2) velocity → (N1,) weak divergence B u."""
        return self.Bx.matvec(u[:, 0]) + self.By.matvec(u[:, 1])

    def bt_apply(self, q: jnp.ndarray) -> jnp.ndarray:
        """(N1,) pressure → (N2, 2) gradient-coupling Bᵀ q."""
        return jnp.stack([self.BxT.matvec(q), self.ByT.matvec(q)], axis=1)

    def solve_vel(self, b: jnp.ndarray, x0=None) -> jnp.ndarray:
        """Inner PCG (Jacobi or two-level) on the masked velocity
        operator, (N2, k)."""
        cfg = self.config
        diag = (
            self.M2.diag() / cfg.dt + (cfg.theta * cfg.nu) * self.K2.diag()
        )
        inv = jnp.where(self.vel_mask > 0, 1.0 / diag, 1.0)
        from tpufem.solve.matfree import _solve_columns

        if self.tl_vel is not None:
            from tpufem.solve.twolevel import twolevel_preconditioner

            # column-broadcast shapes: the closure runs on (N2, k)
            precond = twolevel_preconditioner(
                self.vel_op, inv[:, None], self.tl_vel,
                active_mask=self.vel_mask[:, None],
            )
        else:
            precond = lambda r: (inv * r.T).T
        return _solve_columns(
            self.vel_op, b, x0=x0, iters=cfg.iters_inner, precond=precond
        )

    def cc_precond(self, r: jnp.ndarray) -> jnp.ndarray:
        """Cahouet–Chabard: S̃⁻¹ r = ν M_p⁻¹ r + Δt⁻¹ K_p⁻¹ r (deflated)."""
        cfg = self.config
        kdiag = self.Kp.diag()
        kinv = jnp.where(kdiag > 0, 1.0 / jnp.where(kdiag > 0, kdiag, 1.0), 1.0)
        ones = jnp.ones_like(r)
        proj = lambda v: v - jnp.mean(v)
        z, _ = cg_fixed(
            lambda x: self.Kp.matvec(x), proj(r), iters=cfg.iters_plap,
            precond=lambda q: kinv * q, deflate=True,
            deflate_weights=ones,
        )
        return cfg.nu * (r / self.mp_lumped) + z / cfg.dt


def th_sparse_step(problem: SparseTHProblem, u: jnp.ndarray, p0: jnp.ndarray):
    """One θ-step → (u_new (N2,2), p (N1,), metrics).

    ``u`` is the FULL velocity (BC values included); ``p0`` warm-starts
    the Schur CG."""
    cfg = problem.config
    m = problem.vel_mask[:, None]
    # rhs of the velocity equation (full, then lifted)
    rhs_full = _mv(problem.M2, u) / cfg.dt - (
        (1.0 - cfg.theta) * cfg.nu
    ) * _mv(problem.K2, u)
    if np.any(np.asarray(cfg.body_force)):
        f = jnp.broadcast_to(
            jnp.asarray(cfg.body_force, dtype=u.dtype), u.shape
        )
        rhs_full = rhs_full + _mv(problem.M2, f)
    lift = problem.vel_op_unmasked(problem.u_bc)
    r_v = m * (rhs_full - lift)
    g = -problem.b_apply(problem.u_bc)

    def solveA(b):
        return problem.solve_vel(b)

    # Schur CG:  S p = B A⁻¹ r_v − g
    rhs_p = problem.b_apply(solveA(r_v)) - g

    def s_apply(q):
        return problem.b_apply(solveA(m * problem.bt_apply(q)))

    p, _ = cg_fixed(
        s_apply, rhs_p, x0=p0, iters=cfg.iters_outer,
        precond=problem.cc_precond, deflate=True,
        deflate_weights=jnp.ones_like(rhs_p),
    )
    u_t = solveA(r_v - m * problem.bt_apply(p))
    u_new = u_t + problem.u_bc
    div_w = problem.b_apply(u_new)  # weak divergence against P1 tests
    # ALSO the lumped nodal divergence of the corner velocities — the
    # metric the P1/P1 projection path reports (final_div_max), so the
    # two paths' divergence levels are directly comparable
    from tpufem.ops import calculus

    div_nodal = calculus.divergence(
        problem.pmesh, u_new[jnp.asarray(problem.corners)]
    )
    metrics = {
        "max_u": jnp.max(jnp.abs(u_new)),
        "div_weak_max": jnp.max(jnp.abs(div_w)),
        "div_weak_l2": jnp.sqrt(jnp.sum(div_w * div_w)),
        "final_div_max": jnp.max(jnp.abs(div_nodal)),
    }
    return u_new, p, metrics


_RUN_CACHE: dict = {}


def run(problem: SparseTHProblem, steps: int | None = None,
        host_loop: bool = False, state=None, return_state: bool = False):
    """Scan the stepper → (u (N2,2), p (N1,), stacked metrics).

    ``host_loop=True`` drives one jitted step from a Python loop instead
    of a single scanned program (final-step metrics only): one compiled
    step serves any step count and ``state=`` continuation."""
    cfg = problem.config
    n_steps = steps if steps is not None else cfg.steps
    dtype = problem.mp_lumped.dtype
    u0 = problem.u_bc.astype(dtype)
    p0 = jnp.zeros(problem.n1, dtype=dtype)

    if host_loop:
        key = (id(problem), "host")
        hit = _RUN_CACHE.get(key)
        if hit is not None and hit[0] is problem:
            step = hit[1]
        else:
            step = jax.jit(lambda u, p: th_sparse_step(problem, u, p))
            _RUN_CACHE[key] = (problem, step)
        u, p = state if state is not None else (u0, p0)
        for _ in range(n_steps):
            u, p, mets = step(u, p)
        if return_state:
            return u, p, mets, (u, p)
        return u, p, mets

    key = (id(problem), n_steps)
    hit = _RUN_CACHE.get(key)
    if hit is not None and hit[0] is problem:
        scan_all = hit[1]
    else:

        @jax.jit
        def scan_all(u0, p0):
            def body(carry, _):
                u, p = carry
                u, p, mets = th_sparse_step(problem, u, p)
                return (u, p), mets

            (u, p), mets = jax.lax.scan(
                body, (u0, p0), None, length=n_steps
            )
            return u, p, mets

        _RUN_CACHE[key] = (problem, scan_all)
    return scan_all(u0, p0)


def steady_solve(
    problem: SparseTHProblem,
    iters_inner: int = 400,
    iters_outer: int = 80,
):
    """STEADY Stokes Taylor–Hood by Uzawa-CG → (u (N2,2), p (N1,)).

    The dense :func:`navier_stokes.solve_taylor_hood` factors the full
    (2N₂+N₁)² saddle matrix — ~15k dofs is its practical ceiling.  This
    solves the same system matrix-free:

        ν K₂ u + Bᵀ p = lift(u_bc),   B u = −B u_bc

    * inner: two-level-PCG on the masked ν K₂ (pure stiffness — Jacobi
      alone needs O(1/h) iterations, the aggregation coarse grid keeps
      the count bounded);
    * outer: CG on S = B (νK₂)⁻¹ Bᵀ with the steady Cahouet–Chabard
      preconditioner S̃⁻¹ = ν M_p⁻¹ (the Δt→∞ limit of the transient
      one: for steady Stokes the Schur complement is spectrally
      equivalent to the pressure mass matrix), constant-mode deflated.

    Matches the dense solve to CG tolerance (tests/test_th_sparse.py).
    """
    from tpufem.solve.matfree import _solve_columns
    from tpufem.solve.twolevel import build_twolevel, twolevel_preconditioner
    from tpufem.utils.host import host_context

    cfg = problem.config
    nu = cfg.nu
    mask = problem.vel_mask
    m = mask[:, None]
    K2 = problem.K2

    def a_mv(x):
        mm = mask if x.ndim == 1 else m
        return mm * (nu * _mv(K2, mm * x)) + (1.0 - mm) * x

    diag = nu * K2.diag()
    inv = jnp.where(mask > 0, 1.0 / diag, 1.0)
    with host_context():
        a_s = K2.with_data(nu * np.asarray(K2.data))
        tl = build_twolevel(
            a_s, np.asarray(problem.mesh.coords), a_mv, inv,
            target_coarse=cfg.coarse_nodes,
        )
    precond = twolevel_preconditioner(
        a_mv, inv[:, None], tl, active_mask=m
    )

    def solveA(b):
        return _solve_columns(a_mv, b, iters=iters_inner, precond=precond)

    lift = nu * _mv(K2, problem.u_bc)
    r_v = -m * lift
    g = -problem.b_apply(problem.u_bc)
    rhs_p = problem.b_apply(solveA(r_v)) - g

    def s_apply(q):
        return problem.b_apply(solveA(m * problem.bt_apply(q)))

    p, _ = cg_fixed(
        s_apply, rhs_p, iters=iters_outer,
        precond=lambda r: nu * (r / problem.mp_lumped),
        deflate=True, deflate_weights=jnp.ones_like(rhs_p),
    )
    u = solveA(r_v - m * problem.bt_apply(p)) + problem.u_bc
    return u, p
