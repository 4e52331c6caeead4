"""Operator-split Stokes solver with squirmer BCs and transport.

The flagship workload — parity targets are ``code/StokesColor.py`` (dye
mixing), ``code/StokesFood.py`` (tracer food capture) and the
rotating-cylinder variant of ``scripts/stokes_clean_for_report.py``.

Per-step structure (cites = reference lines reproduced):

  1. implicit viscous solve  (I + Δt·ν·K) u* = uⁿ + Δt·F   (StokesColor:543-545)
  2. periodic copy + Dirichlet/squirmer overwrite on u*     (:546-547)
  3. lumped divergence → pressure solve A_p p = −div/Δt,
     A_p = K / M_L (+ periodic penalty)                     (:549-555, 477-479)
  4. u = u* − Δt·∇p, re-apply BCs                           (:557-564)
  5. second projection applied to interior nodes only       (:566-573)
  6. metrics: max|div u*|, max|div u| final                  (:575, 586)
  7. optional transport: semi-Lagrangian dye + mixing index (:579-586)
     or tracer advection + capture stats (StokesFood:481-505)

Design: all matrices are assembled and factored **once** on the host;
each step is a handful of (N,N)@(N,) matvecs / triangular solves plus
fused gather→segment-sum pipelines, and the whole run is a single jitted
``lax.scan`` — the reference instead performs 4 un-cached O(N³) dense
solves and ≥5 Python element loops per step.  Every f32 product on the
step path asks for ``HIGHEST`` precision (no TF32 on the GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np  # noqa: F401  (used throughout)

from tpufem import bc, transport
from tpufem.mesh.core import Mesh
from tpufem.ops import assembly, calculus
from tpufem.solve import make_dense_solver

_HI = jax.lax.Precision.HIGHEST  # f32 products without TF32 rounding


def _mv(A, x):
    """Dense matvec at full f32 precision."""
    return jnp.matmul(A, x, precision=_HI)


@dataclasses.dataclass
class StokesConfig:
    # physics & stepping (StokesColor.py:32-44 defaults)
    dt: float = 0.05
    nu: float = 0.1
    steps: int = 6000
    body_force: tuple[float, float] = (0.0, 0.0)
    # squirmer (B2<0 pusher, >0 puller, 0 neutral)
    bc_kind: str = "squirmer"  # or "rotating"
    B1: float = -2.0
    B2: float = 0.0
    omega: float = 5.0  # rotating-cylinder rate (clean_for_report:489)
    ramp_steps: int = 0  # linear BC ramp (clean_for_report:492-495)
    center: tuple[float, float] = (0.5, 0.5)
    # domain / markers
    inner_marker: int = 2
    outer_value: tuple[float, float] = (0.0, 0.0)  # wall velocity — the
    # early channel-flow iterations drive with OUTER=[1,0] (scripts/NS.py)
    all_walls: bool = False  # enclosed box: every marked node Dirichlet,
    # no periodicity (scripts/stokes_flow.py family)
    L: float = 1.0
    H: float = 1.0
    tol: float = 1e-6
    # numerics
    solver: str = "lu"  # "lu" (parity) | "inverse" (the dense regime's
    # fast path: precomputed inverses applied as matvecs) | "cg"
    # (matrix-free PCG — O(nnz) memory, the large-mesh path)
    cg_iters_visc: int = 60
    cg_iters_pressure: int = 300
    cg_iters_dye: int = 40  # BiCGStab iterations for matrix-free
    # Eulerian dye (the system is mass-dominated — converges fast)
    cg_storage: str = "auto"  # "csr" (gather/segment-sum) | "banded"
    # (RCM-reordered diagonal storage — gather-free, but reads the
    # O(bw·N) band envelope) | "stencil" (top-offset diagonals + COO
    # remainder — O(nnz) reads on grid-numbered pad_hole meshes)
    # | "auto" (tpufem.platform: stencil-if-covered/banded on the GPU,
    # csr on CPU)
    cg_warm_start: bool = True  # warm-start pressure CG from the previous
    # step's pressure (big iteration savings near steady state)
    cg_tol_pressure: float = 0.0  # > 0: early-exit while-loop pressure CG
    # (relative tolerance; cg_iters_pressure becomes the cap) — with warm
    # starts the steady-state solves finish in a few iterations
    cg_tol_visc: float = 0.0  # > 0: early-exit batched viscous CG
    # (relative per-column tolerance; cg_iters_visc becomes the cap) —
    # warm-started from the previous step's u*, steady-state solves exit
    # after a handful of iterations
    cg_precond: str = "jacobi"  # | "chebyshev" (degree-k polynomial smoother:
    # fewer OUTER iterations — useful when per-iteration collective latency
    # dominates (distributed CG); measured per-matvec efficiency on the
    # bundled/generated meshes favors plain Jacobi, hence the default)
    # | "twolevel" (aggregation coarse-grid correction + damped Jacobi —
    # near mesh-independent pressure iteration counts; the large-mesh
    # default, see solve/twolevel.py)
    cg_cheby_degree: int = 4
    cg_coarse_nodes: int = 2048  # twolevel: target coarse-space size
    cg_coarse_dtype: str = "same"  # | "bf16": store the dense coarse
    # inverse in bfloat16 — halves the bytes of the coarse matvec inside
    # each preconditioner application; safe because it's a
    # preconditioner (the one deliberately reduced-precision product)
    precision: str = "f64"  # "f64" (parity) | "f32" | "bf16" (device dtype;
    # all factorizations happen on host in f64 regardless)
    pressure_mode: str = "penalty"  # "penalty" (reference ±1e10, f64-only)
    # | "merge" (exact DOF-merged periodic operator — required for f32/bf16
    #   and iterative solves, SURVEY.md §7.3)
    dense_ops: bool = True  # evaluate div/grad as precomputed (N,N)
    # matvecs instead of gather/segment-sum (the dense regime)
    fused: bool = False  # compose the ENTIRE per-step velocity update
    # (viscous solve → BCs → double projection) into one (2N,2N) matrix on
    # the host; each step is then a single matvec.  Exact linear-algebra
    # composition of the same affine map — requires pressure_mode="merge",
    # no BC ramp.  The fastest dense-regime path.
    double_projection: bool = True  # the second interior-only projection
    # step variant:
    #   "color"  — code/StokesColor.py / StokesFood.py: BCs re-applied as
    #              field overwrites after each stage, double projection
    #   "report" — scripts/stokes_clean_for_report.py:488-550: BC values
    #              written into the viscous RHS ("corrected method",
    #              validated by the reference's Test H), pinned + de-meaned
    #              pressure, optional high-frequency pressure smoothing,
    #              single projection
    variant: str = "color"
    pressure_smoothing: float = 0.0  # α of the (I+αK) smoothing solve
    # (clean_for_report:516-529); 0 = off
    dirichlet_lift: bool = False  # lift the eliminated Dirichlet columns
    # of the viscous system into the RHS (the consistent strong-BC
    # treatment).  The reference zeroes rows AND columns without moving
    # the coupling to the RHS (code/StokesColor.py:472-475), which
    # removes the viscous traction of the moving boundary from the
    # momentum equation — measured root cause of its damped squirmer
    # flow and self-admitted accuracy ceiling (reference README.md:19;
    # docs/PARITY.md §7).  Default False: bit-parity with the reference.
    # True: the projection steady state converges to the LBB-stable
    # Taylor–Hood solution under refinement (tpufem/convergence.py).
    # transport
    transport: str = "none"  # "none" | "dye" | "tracers" | "eulerian_dye"
    # | "dye_griddata"
    D: float = 1e-3  # dye diffusivity (used by the Eulerian option)
    dye_threshold: float = 0.5  # initial dye: c=1 where x < threshold
    tracer_density: int = 25
    capture_radius: float = 0.28  # StokesFood.py:50-52
    tracer_method: str = "euler"
    locator: str = "grid"  # "grid" (scalable O(P·C)) | "topk" (reference
    # k-nearest-centroid semantics, O(P·T) — fine below ~10k triangles)
    locator_k: int = 10
    locator_grid: int = 0  # 0 = auto (~2√T cells per side)


_DTYPES = {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}


@dataclasses.dataclass(frozen=True)
class StokesProblem:
    mesh: Mesh
    boundary: bc.ChannelBoundary
    visc_solver: Any
    pressure_solver: Any
    inner_values: np.ndarray  # (k,2) squirmer / rotation surface velocities
    m_lumped: jnp.ndarray
    locator: Any
    tracer_init: np.ndarray | None
    config: StokesConfig
    div_x: jnp.ndarray | None = None  # (N,N) dense div/grad operators
    div_y: jnp.ndarray | None = None
    fused_M: jnp.ndarray | None = None  # (2N,2N) whole-step matrix
    fused_b: jnp.ndarray | None = None  # (2N,) whole-step offset
    fused_Dstar: jnp.ndarray | None = None  # (N,2N) u → div(u*) map
    fused_dstar0: jnp.ndarray | None = None  # (N,)
    smooth_solver: Any = None  # (I+αK) pinned pressure-smoothing solve
    pressure_pin: int = -1  # pinned pressure node ("report" variant)
    eul_M: jnp.ndarray | None = None  # consistent mass (Eulerian dye)
    eul_K: jnp.ndarray | None = None  # stiffness (Eulerian/griddata dye)
    eul_Mg: jnp.ndarray | None = None  # periodic merge map (f32 dye path)
    mf_dx: Any = None  # sparse div/grad operators (matfree large-mesh
    mf_dy: Any = None  # path; same storage as the CG operators)
    visc_lift: jnp.ndarray | None = None  # (N,2) −Δt·ν·K[:, D]·u_D lift
    # of the eliminated Dirichlet columns (config.dirichlet_lift)
    _locator_cache: Any = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def dtype(self):
        return _DTYPES[self.config.precision]

    def get_locator(self):
        """The point locator, built on first use.  transport="none"
        problems skip the build entirely (the GridLocator autotune is a
        large share of the host build at 10⁵–10⁶ nodes) unless a
        consumer (e.g. the convergence prober) actually asks for one."""
        if self.locator is not None:
            return self.locator
        loc = self._locator_cache.get("loc")
        if loc is None:
            loc = _make_locator(self.mesh, self.config)
            self._locator_cache["loc"] = loc
        return loc

    def div(self, u: jnp.ndarray) -> jnp.ndarray:
        if self.div_x is not None:
            return _mv(self.div_x, u[:, 0]) + _mv(self.div_y, u[:, 1])
        if self.mf_dx is not None:
            return self.mf_dx.matvec(u[:, 0]) + self.mf_dy.matvec(u[:, 1])
        return calculus.divergence(self.mesh, u)

    def grad(self, p: jnp.ndarray) -> jnp.ndarray:
        if self.div_x is not None:
            return jnp.stack([_mv(self.div_x, p), _mv(self.div_y, p)], axis=1)
        if self.mf_dx is not None:
            return jnp.stack(
                [self.mf_dx.matvec(p), self.mf_dy.matvec(p)], axis=1
            )
        return calculus.gradient(self.mesh, p)

    @classmethod
    def build(cls, mesh: Mesh, config: StokesConfig = StokesConfig()) -> "StokesProblem":
        from tpufem.utils.host import host_context

        # setup math runs on host (hundreds of small eager ops, each a
        # device compile + launch otherwise); only final operators go
        # on-device
        with host_context():
            return cls._build(mesh, config)

    @classmethod
    def _build_matfree(cls, mesh, config, boundary, m_lumped, dtype):
        assert config.transport in ("none", "dye", "tracers", "eulerian_dye"), (
            "dye_griddata needs the dense regime (its explicit diffusion "
            "uses the dense stiffness); use solver='lu'/'inverse'"
        )
        assert not config.fused, "fused and cg are mutually exclusive"
        visc, pressure, mf_dx, mf_dy, mf_extras = _build_matfree_problem_fields(
            mesh, config, boundary, m_lumped, dtype
        )
        tracer_init = None
        if config.transport == "tracers":
            tracer_init = transport.init_tracer_grid(
                config.tracer_density, L=config.L, H=config.H,
                exclude_center=config.center, exclude_radius=0.25,
            )
        inner_values = _inner_values(mesh, boundary, config)
        visc_lift = None
        if config.dirichlet_lift:
            # same lift as the dense path, via the materialized K operator
            ubc = _bc_field(mesh, boundary, inner_values, config)
            m = visc.interior_mask
            cols = [
                -config.dt * config.nu
                * m * visc.K.matvec(jnp.asarray(ubc[:, d], dtype=dtype))
                for d in range(2)
            ]
            visc_lift = jnp.stack(cols, axis=1)
        return cls(
            mesh=mesh,
            boundary=boundary,
            visc_solver=visc,
            pressure_solver=pressure,
            inner_values=inner_values,
            m_lumped=jnp.asarray(np.asarray(m_lumped), dtype=dtype),
            locator=(None if config.transport == "none"
                     else _make_locator(mesh, config)),
            tracer_init=tracer_init,
            config=config,
            mf_dx=mf_dx,
            mf_dy=mf_dy,
            visc_lift=visc_lift,
            smooth_solver=mf_extras.get("smooth_solver"),
            pressure_pin=mf_extras.get("pressure_pin", -1),
        )

    @classmethod
    def _build(cls, mesh: Mesh, config: StokesConfig) -> "StokesProblem":
        from tpufem.solve.dense import DenseInverse
        from tpufem.solve.pressure import merged_pressure_apply_matrix

        valid_transports = ("none", "dye", "tracers", "eulerian_dye", "dye_griddata")
        if config.transport not in valid_transports:
            raise ValueError(
                f"unknown transport {config.transport!r}; expected one of {valid_transports}"
            )
        if config.precision != "f64" and config.solver != "cg":
            assert config.pressure_mode == "merge", (
                "the ±1e10 penalty pressure operator is numerically unusable "
                "below f64 — use pressure_mode='merge' (exact periodic)"
            )
        dtype = _DTYPES[config.precision]
        boundary = bc.ChannelBoundary.build(
            mesh, inner_marker=config.inner_marker, L=config.L, H=config.H,
            tol=config.tol, all_walls=config.all_walls,
        )
        m_lumped = assembly.lumped_mass(mesh)
        n = mesh.n_nodes

        if config.solver == "cg":
            # matrix-free large-mesh path: O(nnz) sparse operators + CG.
            # No dense matrices are ever materialized.
            return cls._build_matfree(mesh, config, boundary, m_lumped, dtype)

        K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh))

        # viscous system: (I + Δt·ν·K), symmetric Dirichlet surgery
        A_visc = jnp.eye(n, dtype=K.dtype) + config.dt * config.nu * K
        A_visc = bc.dirichlet_rows_cols(A_visc, boundary.dirichlet)

        # pressure system (reference form: (K / M_L) p = b + periodic)
        pressure_pin = -1
        smooth_solver = None
        if config.variant == "report":
            assert (
                config.pressure_mode == "penalty"
                and config.precision == "f64"
                and not config.fused
            ), "the 'report' variant implements the reference's pinned f64 path"
            # first interior node pins the pressure gauge
            # (clean_for_report.py:404,427-429)
            pressure_pin = int(np.nonzero(mesh.markers == 0)[0][0])

        if config.pressure_mode == "merge":
            A_eff = merged_pressure_apply_matrix(
                mesh, m_lumped, boundary.masters, boundary.slaves
            )
            pressure_solver = DenseInverse(inv=jnp.asarray(A_eff, dtype=dtype))
        else:
            A_p = K / (m_lumped[:, None] + 1e-12)
            if len(boundary.masters):
                A_p = bc.periodic_penalty(A_p, boundary.masters, boundary.slaves)
            if pressure_pin >= 0:
                A_p = bc.dirichlet_rows_cols(A_p, np.asarray([pressure_pin]))
            pressure_solver = make_dense_solver(A_p, config.solver)

        if config.pressure_smoothing > 0:
            S = jnp.eye(n, dtype=K.dtype) + config.pressure_smoothing * K
            if pressure_pin >= 0:
                S = bc.dirichlet_rows_cols(S, np.asarray([pressure_pin]))
            smooth_solver = make_dense_solver(S, config.solver)

        eul_M = eul_K = eul_Mg = None
        if config.transport in ("eulerian_dye", "dye_griddata"):
            eul_K = jnp.asarray(np.asarray(K), dtype=dtype)
            if config.transport == "eulerian_dye":
                eul_M = jnp.asarray(
                    np.asarray(assembly.assemble_dense(mesh, assembly.element_mass(mesh))),
                    dtype=dtype,
                )
                if config.precision != "f64":
                    from tpufem.solve.pressure import merge_map

                    eul_Mg = jnp.asarray(
                        merge_map(mesh.n_nodes, boundary.masters, boundary.slaves),
                        dtype=dtype,
                    )

        if config.precision == "f64":
            visc_solver = make_dense_solver(A_visc, config.solver)
        else:
            visc_solver = DenseInverse(
                inv=jnp.asarray(np.linalg.inv(np.asarray(A_visc)), dtype=dtype)
            )

        div_x = div_y = None
        dx = dy = None
        if config.dense_ops:
            dx, dy = calculus.divergence_matrices(mesh)
            div_x = jnp.asarray(dx, dtype=dtype)
            div_y = jnp.asarray(dy, dtype=dtype)

        fused_M = fused_b = fused_Dstar = fused_dstar0 = None
        if config.fused:
            assert config.pressure_mode == "merge" and config.ramp_steps == 0, (
                "fused step requires pressure_mode='merge' and no BC ramp"
            )
            assert config.dense_ops and dx is not None

        inner_values = _inner_values(mesh, boundary, config)
        visc_lift = None
        if config.dirichlet_lift:
            visc_lift = jnp.asarray(
                _viscous_lift_dense(
                    np.asarray(K), mesh, boundary, inner_values, config
                ),
                dtype=dtype,
            )

        if config.fused:
            fused_M, fused_b, fused_Dstar, fused_dstar0 = _compose_fused_step(
                mesh, boundary, inner_values, np.asarray(A_visc),
                np.asarray(pressure_solver.inv, dtype=np.float64),
                dx, dy, config,
                lift=(None if visc_lift is None else np.asarray(visc_lift, np.float64)),
            )
            fused_M = jnp.asarray(fused_M, dtype=dtype)
            fused_b = jnp.asarray(fused_b, dtype=dtype)
            fused_Dstar = jnp.asarray(fused_Dstar, dtype=dtype)
            fused_dstar0 = jnp.asarray(fused_dstar0, dtype=dtype)

        locator = (
            None if config.transport == "none"
            else _make_locator(mesh, config)
        )
        tracer_init = None
        if config.transport == "tracers":
            tracer_init = transport.init_tracer_grid(
                config.tracer_density,
                L=config.L,
                H=config.H,
                exclude_center=config.center,
                exclude_radius=0.25,
            )
        return cls(
            mesh=mesh,
            boundary=boundary,
            visc_solver=visc_solver,
            pressure_solver=pressure_solver,
            inner_values=inner_values,
            m_lumped=jnp.asarray(m_lumped, dtype=dtype),
            locator=locator,
            tracer_init=tracer_init,
            config=config,
            div_x=div_x,
            div_y=div_y,
            fused_M=fused_M,
            fused_b=fused_b,
            fused_Dstar=fused_Dstar,
            fused_dstar0=fused_dstar0,
            smooth_solver=smooth_solver,
            pressure_pin=pressure_pin,
            eul_M=eul_M,
            eul_K=eul_K,
            eul_Mg=eul_Mg,
            visc_lift=visc_lift,
        )


def _bc_field(mesh, boundary, inner_values, config) -> np.ndarray:
    """(N,2) zeros with the Dirichlet values written in."""
    ubc = np.zeros((mesh.n_nodes, 2))
    ubc[np.asarray(boundary.walls, dtype=np.int64)] = config.outer_value
    ubc[np.asarray(boundary.inner, dtype=np.int64)] = np.asarray(inner_values)
    return ubc


def _viscous_lift_dense(K_np, mesh, boundary, inner_values, config):
    """−Δt·ν·K[:, D]·u_D restricted to interior rows (consistent lifting
    of the columns dirichlet_rows_cols eliminates)."""
    ubc = _bc_field(mesh, boundary, inner_values, config)
    lift = -config.dt * config.nu * (np.asarray(K_np, dtype=np.float64) @ ubc)
    lift[np.asarray(boundary.dirichlet, dtype=np.int64)] = 0.0
    return lift


def _inner_values(mesh, boundary, config) -> np.ndarray:
    if config.bc_kind == "squirmer":
        return bc.squirmer_values(
            mesh.coords, boundary.inner, config.center, config.B1, config.B2
        )
    if config.bc_kind == "rotating":
        return bc.rotating_cylinder_values(
            mesh.coords, boundary.inner, config.center, config.omega
        )
    raise ValueError(f"unknown bc_kind: {config.bc_kind}")


def _make_locator(mesh, config):
    if config.locator == "topk":
        return transport.TopKLocator(mesh, k=config.locator_k)
    if config.locator_grid:
        return transport.GridLocator.build(mesh, g=config.locator_grid)
    # The hot locate gather reads (P, 10·C_max) rows, so the padded
    # candidate width C_max directly sets the per-step tracer bytes.
    # C_max vs g is lumpy (one crowded cell sets it); probe a few
    # resolutions around 2√T and keep the narrowest table (ties → the
    # coarser grid, which keeps the table itself smaller).  Build is
    # vectorized NumPy — probing costs milliseconds at setup.
    base = np.sqrt(mesh.n_tris)
    best = None
    for scale in (2.0, 2.3, 2.7, 3.1):
        g = int(np.clip(scale * base, 8, 192))
        loc = transport.GridLocator.build(mesh, g=g)
        if best is None or loc.cells.shape[1] < best.cells.shape[1]:
            best = loc
    return best


def _build_matfree_problem_fields(mesh, config, boundary, m_lumped, dtype):
    """ViscousCG + PressureCG solvers over static sparse operators, in the
    storage :func:`tpufem.platform.stokes_storage` picks."""
    import dataclasses as dc

    from tpufem import platform
    from tpufem.ops.banded import BandedOperator
    from tpufem.ops.stencil import StencilOperator
    from tpufem.solve.matfree import PressureCG, ViscousCG
    from tpufem.solve.pressure import owner_map as pressure_owner_map

    storage = platform.stokes_storage(config.cg_storage)

    def materialize(csr_op):
        if storage == "stencil":
            return StencilOperator.build(csr_op, dtype=dtype)
        if storage == "accel":
            # prefer the O(nnz) stencil decomposition when the node
            # numbering supports it (pad_hole generated meshes); fall back
            # to the O(bw·N) banded sweep otherwise
            st = StencilOperator.build(csr_op, dtype=dtype)
            if st.coverage >= 0.9:
                return st
        if storage in ("banded", "accel"):
            return BandedOperator.build(csr_op, dtype=dtype)
        return csr_op.with_data(csr_op.data.astype(dtype))

    ke = assembly.element_stiffness(mesh)
    K_csr = assembly.assemble_csr(mesh, ke)
    interior_mask = np.ones(mesh.n_nodes)
    interior_mask[boundary.dirichlet] = 0.0

    # "report" variant (scripts/stokes_clean_for_report.py:404-529) on the
    # matrix-free path: pinned-gauge pressure CG (PressureCG.pin — the CG
    # form of the row+col pin surgery), optional (I+αK) smoothing solve as
    # a pin-masked CG (reusing ViscousCG's masked-operator shape), both
    # solver-agnostic in _report_projection_step.
    pressure_pin = -1
    if config.variant == "report":
        pressure_pin = int(np.nonzero(mesh.markers == 0)[0][0])

    visc = ViscousCG(
        K=materialize(K_csr),
        interior_mask=jnp.asarray(interior_mask, dtype=dtype),
        dt_nu=config.dt * config.nu,
        iters=config.cg_iters_visc,
        tol=config.cg_tol_visc,
    )

    owner = pressure_owner_map(mesh.n_nodes, boundary.masters, boundary.slaves)
    # relabel slave node ids to masters in the connectivity, re-assemble
    relabeled = owner[mesh.tris].astype(np.int32)
    mesh_merged = dc.replace(mesh, tris=relabeled)
    Km_csr = assembly.assemble_csr(mesh_merged, ke)
    # active = own master dof AND carried by at least one element (excludes
    # pad_hole dummy nodes, whose operator rows are identically zero)
    active_mask = (
        (owner == np.arange(mesh.n_nodes)) & (np.asarray(m_lumped) > 0)
    ).astype(np.float64)
    km = materialize(Km_csr)
    lmax = 0.0
    tl = None
    if config.cg_precond in ("chebyshev", "twolevel"):
        from tpufem.solve.cg import estimate_lmax

        diag = km.diag()
        inv_diag = jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0), 1.0)
        lmax = estimate_lmax(km.matvec, inv_diag, mesh.n_nodes)
        if config.cg_precond == "twolevel":
            from tpufem.solve.twolevel import build_twolevel

            tl = build_twolevel(
                Km_csr,
                np.asarray(mesh.coords),
                km.matvec,
                inv_diag,
                target_coarse=config.cg_coarse_nodes,
                dtype=dtype,
                coarse_dtype=(
                    jnp.bfloat16 if config.cg_coarse_dtype == "bf16" else None
                ),
                lmax=lmax,
            )
    pressure = PressureCG(
        K_merged=km,
        m_lumped=jnp.asarray(np.asarray(m_lumped), dtype=dtype),
        masters=boundary.masters,
        slaves=boundary.slaves,
        active_mask=jnp.asarray(active_mask, dtype=dtype),
        iters=config.cg_iters_pressure,
        precond=config.cg_precond,
        cheby_degree=config.cg_cheby_degree,
        lmax=lmax,
        twolevel=tl,
        tol=config.cg_tol_pressure,
        pin=pressure_pin,
    )
    extras = {}
    if pressure_pin >= 0:
        extras["pressure_pin"] = pressure_pin
        if config.pressure_smoothing > 0:
            # (I + αK) pin-masked SPD solve — exactly ViscousCG's masked
            # operator shape with dt·ν → α and mask = all-but-pin
            pin_mask = np.ones(mesh.n_nodes)
            pin_mask[pressure_pin] = 0.0
            extras["smooth_solver"] = ViscousCG(
                K=visc.K,
                interior_mask=jnp.asarray(pin_mask, dtype=dtype),
                dt_nu=config.pressure_smoothing,
                iters=config.cg_iters_visc,
                tol=config.cg_tol_pressure,
            )
    dx_csr, dy_csr = calculus.divergence_csr_operators(mesh)
    return visc, pressure, materialize(dx_csr), materialize(dy_csr), extras


def _compose_fused_step(
    mesh, boundary, inner_values, A_visc, A_eff, dx, dy, config, lift=None
):
    """Compose the whole affine velocity update into (M, b, Dstar, dstar0).

    Stacked layout u_flat = [uₓ; u_y] (2N).  Every stage of the reference's
    step (StokesColor.py:537-573) is affine in u:

      u*  = E₂ V₂ (u + Δt f) + q          viscous solve + BC overwrite
      u₁  = E₂ (I + G A_eff D) u* + q     1st projection + BC overwrite
      u₂  = (I + S₂ G A_eff D) u₁         2nd projection (interior only)

    with V the viscous inverse, E the BC row-surgery (periodic copy, wall
    zero, inner overwrite — offset q carries the squirmer values), D/G the
    lumped div/grad operators, A_eff the merged-pressure solve matrix and
    S₂ the interior selector.  The composed M = T₂ E₂ T₁ E₂V₂ is exact
    linear algebra — the per-step result is bit-comparable to the unfused
    merge-mode path up to f.p. associativity.
    """
    n = mesh.n_nodes
    dt = config.dt
    V = np.linalg.inv(A_visc.astype(np.float64))

    # BC row surgery E and offset q (sequential, replicating makePerBCU /
    # makeDirBCU order — StokesColor.py:546-547)
    E = np.eye(n)
    for m_, s_ in zip(boundary.masters, boundary.slaves):
        E[s_, :] = E[m_, :]
    E[boundary.walls, :] = 0.0
    E[boundary.inner, :] = 0.0
    qx = np.zeros(n)
    qy = np.zeros(n)
    qx[boundary.walls] = config.outer_value[0]
    qy[boundary.walls] = config.outer_value[1]
    qx[boundary.inner] = inner_values[:, 0]
    qy[boundary.inner] = inner_values[:, 1]

    def blockdiag(A):
        z = np.zeros_like(A)
        return np.block([[A, z], [z, A]])

    V2 = blockdiag(V)
    E2 = blockdiag(E)
    q = np.concatenate([qx, qy])
    D = np.concatenate([dx, dy], axis=1)  # (N, 2N)
    G = np.concatenate([dx, dy], axis=0)  # (2N, N) — same coefficients
    GAD = G @ (A_eff @ D)  # (2N, 2N)

    f = np.concatenate(
        [np.full(n, config.body_force[0]), np.full(n, config.body_force[1])]
    )
    rhs0 = dt * f
    if lift is not None:
        rhs0 = rhs0 + np.concatenate([lift[:, 0], lift[:, 1]])
    M1 = E2 @ V2
    c1 = M1 @ rhs0 + q  # u* = M1 u + c1
    T1 = np.eye(2 * n) + GAD
    # u1 = E2 T1 u* + q
    M2 = E2 @ T1
    if config.double_projection:
        s_mask = np.zeros(n)
        s_mask[boundary.interior] = 1.0
        S2 = np.concatenate([s_mask, s_mask])[:, None]
        T2 = np.eye(2 * n) + S2 * GAD
    else:
        T2 = np.eye(2 * n)
    M = T2 @ (M2 @ M1)
    b = T2 @ (M2 @ c1 + q)
    Dstar = D @ M1  # div(u*) = Dstar u + dstar0
    dstar0 = D @ c1
    return M, b, Dstar, dstar0


def apply_field_bcs(problem: StokesProblem, u: jnp.ndarray, scale=1.0) -> jnp.ndarray:
    """Periodic copy then walls=0 + inner surface velocity
    (makePerBCU/makeDirBCU order, StokesColor.py:546-547)."""
    b = problem.boundary
    if len(b.masters):
        u = bc.apply_periodic_field(u, b.masters, b.slaves)
    u = u.at[jnp.asarray(b.walls)].set(
        jnp.asarray(problem.config.outer_value, dtype=u.dtype)
    )
    vals = jnp.asarray(problem.inner_values, dtype=u.dtype) * scale
    return u.at[jnp.asarray(b.inner)].set(vals)


_DYE_TRANSPORTS = ("dye", "eulerian_dye", "dye_griddata")


def initial_state(problem: StokesProblem) -> dict:
    cfg = problem.config
    n = problem.mesh.n_nodes
    dtype = problem.dtype
    u = apply_field_bcs(problem, jnp.zeros((n, 2), dtype=dtype))
    state = {"u": u, "step": jnp.asarray(0, dtype=jnp.int32)}
    from tpufem.solve.matfree import PressureCG

    if cfg.cg_warm_start and isinstance(problem.pressure_solver, PressureCG):
        # CG pressure solves warm-start from the previous step's solutions
        state["p_warm"] = jnp.zeros(n, dtype=dtype)
        state["p2_warm"] = jnp.zeros(n, dtype=dtype)
        if cfg.cg_tol_visc > 0:
            # viscous CG warm-starts from the previous step's u*
            state["ustar_warm"] = u
    if cfg.transport in _DYE_TRANSPORTS:
        # half-domain dye (StokesColor.py:493-495)
        c = jnp.where(jnp.asarray(problem.mesh.coords[:, 0]) < cfg.dye_threshold, 1.0, 0.0)
        state["c"] = c.astype(dtype)
    elif cfg.transport == "tracers":
        state["tracers"] = jnp.asarray(problem.tracer_init, dtype=dtype)
        state["tracer_status"] = jnp.zeros(problem.tracer_init.shape[0], dtype=jnp.int32)
    return state


def dye_baseline(problem: StokesProblem, state: dict):
    """Initial mixing variance var₀ (StokesColor.py:496-497)."""
    interior = jnp.asarray(problem.mesh.markers == 0)
    _, _, var0 = transport.mixing_index(state["c"], problem.m_lumped, mask=interior)
    return var0


def _report_projection_step(
    problem: StokesProblem, u: jnp.ndarray, bc_scale, warm=None
):
    """The 'report' step (scripts/stokes_clean_for_report.py:480-550):
    BC values written into the viscous RHS, stabilized pinned pressure
    solve with optional (I+αK) smoothing, single projection, final-field
    BC re-application in walls → periodic → inner order.

    ``warm`` (CG path): previous-step solutions warm-starting the viscous
    ("u_star"), raw-pressure ("p") and smoothed-pressure ("p2") solves."""
    cfg = problem.config
    b = problem.boundary
    dt = cfg.dt
    f = jnp.asarray(cfg.body_force, dtype=u.dtype)
    vals = jnp.asarray(problem.inner_values, dtype=u.dtype) * bc_scale
    walls = jnp.asarray(b.walls)
    inner = jnp.asarray(b.inner)

    outer = jnp.asarray(cfg.outer_value, dtype=u.dtype)
    rhs = u + dt * f
    if problem.visc_lift is not None:
        rhs = rhs + bc_scale * problem.visc_lift
    rhs = rhs.at[walls].set(outer)
    rhs = rhs.at[inner].set(vals)
    if warm is not None and "u_star" in warm:
        u_star = problem.visc_solver.solve(rhs, x0=warm["u_star"])
    else:
        u_star = problem.visc_solver.solve(rhs)
    u_star_raw = u_star
    if len(b.masters):
        u_star = bc.apply_periodic_field(u_star, b.masters, b.slaves)

    div_star = problem.div(u_star)
    b_p = -div_star / dt
    b_p = b_p - jnp.mean(b_p)
    b_p = b_p.at[problem.pressure_pin].set(0.0)
    if warm is not None:
        p = problem.pressure_solver.solve(b_p, x0=warm["p"])
    else:
        p = problem.pressure_solver.solve(b_p)
    p_raw = p
    if problem.smooth_solver is not None:
        p = p.at[problem.pressure_pin].set(0.0)
        if warm is not None:
            p = problem.smooth_solver.solve(p, x0=warm["p2"])
        else:
            p = problem.smooth_solver.solve(p)
        p = p - jnp.mean(p)

    u_new = u_star - dt * problem.grad(p)
    final_div = problem.div(u_new)  # measured before the BC re-application
    u_new = u_new.at[walls].set(outer)
    if len(b.masters):
        u_new = bc.apply_periodic_field(u_new, b.masters, b.slaves)
    u_new = u_new.at[inner].set(vals)
    metrics = {
        "div_star_max": jnp.max(jnp.abs(div_star)),
        "final_div_max": jnp.max(jnp.abs(final_div)),
        "max_u": jnp.max(jnp.abs(u_new)),
    }
    warm_out = None
    if warm is not None:
        warm_out = {"p": p_raw, "p2": p}
        if "u_star" in warm:
            warm_out["u_star"] = u_star_raw
    return u_new, p, metrics, warm_out


def projection_step(problem: StokesProblem, u: jnp.ndarray, bc_scale=1.0, warm=None):
    """The double-projection Stokes update → (u, p, metrics, warm_out).

    ``warm`` is a dict of previous-step solutions: keys ``"p"``/``"p2"``
    warm-start the CG pressure solves, ``"u_star"`` the batched viscous
    CG (no-op for dense solvers).  A legacy ``(p, p2)`` tuple is also
    accepted."""
    cfg = problem.config
    mesh = problem.mesh
    dt = cfg.dt
    if warm is not None and not isinstance(warm, dict):
        warm = {"p": warm[0], "p2": warm[1]}

    if cfg.variant == "report":
        return _report_projection_step(problem, u, bc_scale, warm)

    if problem.fused_M is not None:
        n = mesh.n_nodes
        u_flat = jnp.concatenate([u[:, 0], u[:, 1]])
        div_star = _mv(problem.fused_Dstar, u_flat) + problem.fused_dstar0
        new_flat = _mv(problem.fused_M, u_flat) + problem.fused_b
        u_new = jnp.stack([new_flat[:n], new_flat[n:]], axis=1)
        final_div = problem.div(u_new)
        metrics = {
            "div_star_max": jnp.max(jnp.abs(div_star)),
            "final_div_max": jnp.max(jnp.abs(final_div)),
            "max_u": jnp.max(jnp.abs(u_new)),
        }
        return u_new, None, metrics, None

    f = jnp.asarray(cfg.body_force, dtype=u.dtype)

    # 1. tentative velocity — one batched solve for both components
    rhs = u + dt * f  # (N,2)
    if problem.visc_lift is not None:
        rhs = rhs + bc_scale * problem.visc_lift
    if warm is not None and "u_star" in warm:
        u_star = problem.visc_solver.solve(rhs, x0=warm["u_star"])
    else:
        u_star = problem.visc_solver.solve(rhs)
    u_star_raw = u_star  # pre-BC solve output: next step's viscous x0
    u_star = apply_field_bcs(problem, u_star, bc_scale)

    # 2. pressure correction
    div_star = problem.div(u_star)
    if warm is not None:
        p = problem.pressure_solver.solve(-div_star / dt, x0=warm["p"])
    else:
        p = problem.pressure_solver.solve(-div_star / dt)

    # 3. velocity update
    u_new = u_star - dt * problem.grad(p)
    u_new = apply_field_bcs(problem, u_new, bc_scale)

    # 4. second projection, interior only (StokesColor.py:566-573)
    p2 = None
    if cfg.double_projection:
        div_u = problem.div(u_new)
        if warm is not None:
            p2 = problem.pressure_solver.solve(-div_u / dt, x0=warm["p2"])
        else:
            p2 = problem.pressure_solver.solve(-div_u / dt)
        g2 = problem.grad(p2)
        imask = getattr(problem.visc_solver, "interior_mask", None)
        if imask is not None and imask.shape[0] == u_new.shape[0]:
            # masked form of the interior-only update: the index
            # scatter-add below is an O(N) gather + O(N) scatter per
            # step, vs a fully fused elementwise multiply-add.
            # interior_mask is exactly the 0/1 indicator of
            # boundary.interior (stokes build: 1 − dirichlet), so the
            # update is element-wise identical.  The dense/f64 parity
            # path (no mask on its solver) keeps the legacy scatter.
            u_new = u_new - dt * g2 * imask[:, None]
        else:
            interior = jnp.asarray(problem.boundary.interior)
            u_new = u_new.at[interior].add(-dt * g2[interior])

    final_div = problem.div(u_new)
    metrics = {
        "div_star_max": jnp.max(jnp.abs(div_star)),
        "final_div_max": jnp.max(jnp.abs(final_div)),
        "max_u": jnp.max(jnp.abs(u_new)),
    }
    warm_out = None
    if warm is not None:
        warm_out = {"p": p, "p2": p2 if p2 is not None else p}
        if "u_star" in warm:
            warm_out["u_star"] = u_star_raw
    return u_new, p, metrics, warm_out


def eulerian_dye_step(problem: StokesProblem, c: jnp.ndarray, u: jnp.ndarray):
    """Implicit Eulerian advection–diffusion of dye
    (scripts/visualize_stokes_flow.py:1344-1366):

      A_c = M + Δt (C(u) + D K) + diag(Δt M_L (∇·u))   [slave diag copied]
      A_c c' = M c,  then clip to [0,1] and copy master → slave.

    The matrix depends on u, so it is re-assembled and solved *on device*
    every step (dense LU via ``jnp.linalg.solve``, f32 or f64).
    Periodicity: ±1e10 penalty in
    f64 (reference), exact DOF-merge in f32 (penalty is f32-hostile).
    """
    cfg = problem.config
    b = problem.boundary
    dt = cfg.dt
    if problem.eul_M is None:
        # matrix-free large-mesh regime (solver="cg")
        return _eulerian_dye_step_matfree(problem, c, u)
    C = assembly.assemble_dense(mesh=problem.mesh, elem=assembly.element_convection(problem.mesh, u))
    divu = problem.div(u)
    g = dt * (problem.m_lumped * divu)
    if len(b.masters):
        g = g.at[jnp.asarray(b.slaves)].set(g[jnp.asarray(b.masters)])
    A_c = problem.eul_M + dt * (C + cfg.D * problem.eul_K) + jnp.diag(g)
    rhs = _mv(problem.eul_M, c)
    if problem.eul_Mg is None:
        if len(b.masters):
            A_c = bc.periodic_penalty(A_c, b.masters, b.slaves)
        c_new = jnp.linalg.solve(A_c, rhs)
    else:
        mg = problem.eul_Mg
        c_new = _mv(mg, jnp.linalg.solve(
            _mv(mg.T, _mv(A_c, mg)), _mv(mg.T, rhs)
        ))
    c_new = jnp.clip(c_new, 0.0, 1.0)
    if len(b.masters):
        c_new = bc.apply_periodic_field(c_new, b.masters, b.slaves)
    return c_new


def _eulerian_dye_step_matfree(problem: StokesProblem, c: jnp.ndarray, u: jnp.ndarray):
    """Eulerian implicit dye for the matrix-free regime: the per-step
    nonsymmetric system (M + Δt(C(u) + D K) + diag) is solved with
    Jacobi-preconditioned BiCGStab over matrix-free applies (O(T) per
    iteration) in the merged-periodic space — no dense matrix ever exists.
    Same scheme as the dense :func:`eulerian_dye_step` (weak-merged
    periodicity instead of ±1e10 penalty)."""
    from tpufem.solve.cg import bicgstab_fixed

    cfg = problem.config
    b = problem.boundary
    mesh = problem.mesh
    dt = cfg.dt
    has_per = len(b.masters) > 0
    m = jnp.asarray(b.masters)
    s = jnp.asarray(b.slaves)
    active = problem.pressure_solver.active_mask.astype(c.dtype)
    K = problem.visc_solver.K  # the stiffness operator

    divu = problem.div(u)
    g = dt * (problem.m_lumped * divu)
    if has_per:
        g = g.at[s].set(g[m])

    def spread(x):
        return x.at[s].set(x[m]) if has_per else x

    def fold(z):
        if has_per:
            z = z.at[m].add(z[s])
            z = z * active
        return z

    def A(x):
        xf = spread(x)
        z = (
            calculus.mass_apply(mesh, xf)
            + dt * (calculus.convection_apply(mesh, u, xf) + cfg.D * K.matvec(xf))
            + g * xf
        )
        return fold(z)

    rhs = fold(calculus.mass_apply(mesh, c))
    md = problem.m_lumped
    if has_per:
        md = md.at[m].add(md[s])
    inv_diag = jnp.where(active > 0, 1.0 / (md + g), 1.0)
    x0 = c * active if has_per else c
    c_new, _ = bicgstab_fixed(
        A, rhs, x0=x0, iters=cfg.cg_iters_dye, precond=lambda r: inv_diag * r
    )
    c_new = spread(c_new)
    c_new = jnp.clip(c_new, 0.0, 1.0)
    if has_per:
        c_new = bc.apply_periodic_field(c_new, b.masters, b.slaves)
    return c_new


def griddata_dye_step(problem: StokesProblem, c: jnp.ndarray, u: jnp.ndarray):
    """Semi-Lagrangian dye via departure-point interpolation + explicit
    diffusion (scripts/good_visualization2.py:685-717): linear interp at
    x − uΔt with 0 outside the mesh, then c += Δt·D·(K c), clipped.

    Deviation noted: the reference's ``scipy.interpolate.griddata``
    triangulates the convex hull of the node cloud (interpolating *across*
    the cylinder hole); we interpolate on the actual mesh, which is the
    intended behavior.
    """
    cfg = problem.config
    coords = jnp.asarray(problem.mesh.coords, dtype=c.dtype)
    dep = coords - cfg.dt * u
    vals, _ = transport.interpolate(problem.mesh, c, dep, problem.locator)
    if cfg.D > 0:
        vals = jnp.clip(vals + cfg.dt * cfg.D * _mv(problem.eul_K, vals), 0.0, 1.0)
    return vals


def make_step(problem: StokesProblem, var0=None):
    """Pure scan body: state → (state, metrics)."""
    cfg = problem.config
    mesh = problem.mesh
    interior_mask = jnp.asarray(problem.mesh.markers == 0)

    def step(state, _):
        if cfg.ramp_steps > 0:
            # reference ramp is (step+1)/ramp in the report script
            # (clean_for_report.py:492-495)
            num = state["step"] + (1 if cfg.variant == "report" else 0)
            ramp = jnp.minimum(
                num.astype(problem.m_lumped.dtype) / cfg.ramp_steps, 1.0
            )
        else:
            ramp = 1.0
        warm = None
        if "p_warm" in state:
            warm = {"p": state["p_warm"], "p2": state["p2_warm"]}
            if "ustar_warm" in state:
                warm["u_star"] = state["ustar_warm"]
        u, p, metrics, warm_out = projection_step(
            problem, state["u"], bc_scale=ramp, warm=warm
        )
        new_state = {"u": u, "step": state["step"] + 1}
        if warm_out is not None:
            new_state["p_warm"] = warm_out["p"]
            new_state["p2_warm"] = warm_out["p2"]
            if "u_star" in warm_out:
                new_state["ustar_warm"] = warm_out["u_star"]

        if cfg.transport in _DYE_TRANSPORTS:
            if cfg.transport == "dye":
                c = transport.advect_semilagrange(
                    mesh, problem.locator, state["c"], u, cfg.dt, L=cfg.L, H=cfg.H
                )
            elif cfg.transport == "eulerian_dye":
                c = eulerian_dye_step(problem, state["c"], u)
            else:
                c = griddata_dye_step(problem, state["c"], u)
            I, mu, var = transport.mixing_index(c, problem.m_lumped, mask=interior_mask)
            new_state["c"] = c
            metrics["mixing_var"] = var
            if var0 is not None:
                metrics["mixing_progress"] = 1.0 - var / (var0 + 1e-16)
        elif cfg.transport == "tracers":
            pts = transport.tracer_step(
                mesh, problem.locator, state["tracers"], u, cfg.dt,
                L=cfg.L, method=cfg.tracer_method,
            )
            status = transport.capture_update(
                pts, state["tracer_status"], cfg.center, cfg.capture_radius
            )
            new_state["tracers"] = pts
            new_state["tracer_status"] = status
            metrics["eaten"] = jnp.sum(status)
        return new_state, metrics

    return step


_RUN_CACHE: dict[tuple[int, int], Any] = {}


def run(problem: StokesProblem, steps: int | None = None, state: dict | None = None):
    """Run the simulation as one jitted scan; returns (state, metrics).

    The compiled scan is cached per (problem, step count) so repeated runs
    don't re-trace.  For dye runs, ``mixing_progress`` is derived from the
    stacked variance series against the *initial* state's variance.
    """
    cfg = problem.config
    if state is None:
        state = initial_state(problem)
    n_steps = steps if steps is not None else cfg.steps

    # cache value holds the problem itself: id() keys are only unique while
    # the object is alive — a bare id key can collide after GC recycling
    key = (id(problem), n_steps)
    hit = _RUN_CACHE.get(key)
    if hit is not None and hit[0] is problem:
        scan_all = hit[1]
    else:
        step = make_step(problem)

        # the operator arrays are closure constants of the compiled scan:
        # on the H100 this ran 1.2-1.8× faster per step than passing them
        # as jit arguments (headline and 10⁶-node sizes), at a slower
        # one-time compile
        @jax.jit
        def scan_all(state):
            return jax.lax.scan(step, state, None, length=n_steps)

        _RUN_CACHE[key] = (problem, scan_all)

    out_state, metrics = scan_all(state)
    if cfg.transport in _DYE_TRANSPORTS:
        # baseline variance is the *canonical* initial dye pattern's, so
        # chunked/resumed runs report the same progress series as a
        # straight run (the reference's var₀, StokesColor.py:496-497)
        var0 = dye_baseline(problem, initial_state(problem))
        metrics["mixing_progress"] = 1.0 - metrics["mixing_var"] / (var0 + 1e-16)
    return out_state, metrics
