"""Large-mesh scaling benchmark (``python -m tpufem bench --large``).

The headline bench (repo-root ``bench.py``) measures the reference's own
~1k-node dense regime.  This sweep measures the regime the reference
cannot reach at all (its dense O(N³) per-step solves cap it at ~1k nodes
— SURVEY.md §0): meshes from ~1k to 2M nodes, solved matrix-free
(stencil/banded SpMV + two-level-PCG pressure + warm start, f32 device
dtype; ``tpufem.platform`` picks the operator storage).

* ``--mesh STEM``: an IMPORTED Triangle mesh (e.g. the reference's own
  ``mesh_fine.1``) instead of the generated size sweep.
* ``--transport tracers|dye``: the tracer/food workload
  (``code/StokesFood.py:481-505``) or semi-Lagrangian dye at large sizes.
* physics gate: beyond finiteness, every row reports and gates on the
  *normalized* divergence  ‖div u‖_M · h / ‖u‖_M  (the max-norm
  ``final_div_max`` grows with N as a max over resolution-limited nodes
  near the squirmer; the mass-weighted L2 form is mesh-size comparable).
  The reference's own failure detector is divergence eyeballing
  (``code/StokesColor.py:575``).
"""

from __future__ import annotations

import json
import time

import numpy as np

# (label, n_side, n_circle) — pad_hole annulus sizes spanning 1k → 500k
# nodes (node count = n_side² + n_circle incl. ~20% inert hole dummies)
SIZES = [
    ("2k", 40, 48),
    ("6k", 80, 96),
    ("26k", 160, 192),
    ("79k", 280, 320),
    ("160k", 400, 448),
    ("410k", 640, 720),
    ("518k", 720, 800),
    ("803k", 896, 960),
    ("1.05M", 1024, 1088),
    ("1.64M", 1280, 1344),
    ("2M", 1408, 1472),
]

# ≥400k rows are opt-in, excluded from the default sweep (host set-up
# and compilation at these sizes take minutes)
LARGE_OPT_IN = {"410k", "518k", "803k", "1.05M", "1.64M", "2M"}

# Per-path normalized-divergence gates, tracking the measured curves so a
# 2× regression FAILS (a blow-up-only gate of 1.0 would be 50× looser
# than the physics).  Measured plateaus of earlier runs: Stokes/dye/
# tracers 0.0197–0.0272 across 2k–2M; imported mesh_fine.1 0.107 (a
# 1067-node mesh is legitimately coarser); NS channel 0.15–0.197 at 50
# impulsive-start dt=1e-4 steps (ladder-quantified by
# ``tpufem converge --study ns``).
DIV_REL_GATES = {
    "stokes": 0.05,
    "imported": 0.2,
    "ns": 0.3,
}
# velocity boundedness: the squirmer BC speed is max|u_θ| ≤ |B1| + |B2|
# and a Stokes interior cannot exceed its boundary data by much —
# measured max_u is exactly the BC scale (2.0 at B1=−2).  25% headroom.
MAX_U_FACTOR = 1.25


def bench_config(
    precond: str = "twolevel",
    n_nodes: int = 0,
    transport: str = "none",
    storage: str = "auto",
):
    from tpufem.workloads import stokes

    # two-level + warm start + tolerance CG: steady-state pressure solves
    # exit after a few iterations (measured div trajectories identical to
    # the fixed-count runs to 6 digits); the iteration count is the CAP
    if precond == "twolevel":
        iters_p, tol = 60, 1e-5
    else:
        iters_p, tol = 300, 0.0
    # viscous side: warm-started early-exit CG — wins where SpMV bytes
    # dominate (+13% at 26k), loses in the latency-bound small regime
    # where the dynamic while_loop blocks pipelining (−30% at 2k);
    # measured crossover sits below 26k nodes
    tol_visc = 1e-5 if (tol and n_nodes >= 10_000) else 0.0
    return stokes.StokesConfig(
        dt=0.01,
        nu=1.0,
        transport=transport,
        tracer_density=115,  # ~10k tracers (the headline bench count)
        solver="cg",
        cg_storage=storage,  # "auto": tpufem.platform's choice
        precision="f32",
        cg_iters_visc=30,
        cg_iters_pressure=iters_p,
        cg_precond=precond,
        cg_warm_start=True,
        cg_tol_pressure=tol,
        cg_tol_visc=tol_visc,
        # bf16 coarse inverse: halves the bytes of the (nc, nc) coarse
        # matvec (iteration counts unchanged; it's a preconditioner)
        cg_coarse_dtype="bf16",
    )


def compile_cache_dir() -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when set, else ``<repo>/.jax_cache`` (a fixed path — the path is part
    of the cache key, so a moving directory never hits)."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, ".jax_cache")


def enable_compile_cache():
    """Persist compiled executables across processes.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and nothing
    is set here; otherwise the cache goes to ``<repo>/.jax_cache``."""
    import os

    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def physics_report(problem, state, metrics, steps, gate: str = "stokes"):
    """(dict, h) — normalized divergence + gates shared by all rows."""
    import jax.numpy as jnp
    from tpufem.workloads import stokes  # noqa: F401

    div_gate = DIV_REL_GATES[gate]
    u = np.asarray(state["u"], dtype=np.float64)
    assert np.isfinite(u).all(), "large-mesh bench diverged"
    cfg = problem.config
    u_scale = abs(float(cfg.B1)) + abs(float(cfg.B2))
    assert np.abs(u).max() < MAX_U_FACTOR * u_scale, (
        f"velocity {np.abs(u).max():.3f} exceeds "
        f"{MAX_U_FACTOR}×BC scale {u_scale} — boundedness gate"
    )
    div = np.asarray(
        problem.div(jnp.asarray(state["u"])), dtype=np.float64
    )
    ml = np.asarray(problem.m_lumped, dtype=np.float64)
    h = float(np.sqrt(2.0 * np.median(np.asarray(problem.mesh.area))))
    div_l2 = float(np.sqrt((ml * div**2).sum()))
    u_l2 = float(np.sqrt((ml * (u**2).sum(axis=1)).sum()))
    div_rel = div_l2 * h / max(u_l2, 1e-30)
    assert div_rel < div_gate, (
        f"normalized divergence {div_rel:.3f} ≥ {div_gate} ({gate} gate "
        "tracks the measured curve; a pass at 2× today's level is a "
        "regression, not physics)"
    )
    # blow-up guard: the max-norm divergence must PLATEAU (it settles at a
    # resolution-dependent level near the squirmer boundary while a
    # non-converged solve grows without bound)
    fd = np.asarray(metrics["final_div_max"], dtype=np.float64)
    assert fd[-1] < 5.0 * (fd[: max(2, steps // 10)].max() + 1.0), (
        "divergence did not plateau: %r" % fd[:: max(1, steps // 8)]
    )
    row = {
        "div_star_max": float(np.asarray(metrics["div_star_max"])[-1]),
        "final_div_max": float(fd[-1]),
        "div_rel": round(div_rel, 4),
        "max_u": float(np.abs(u).max()),
    }
    if "c" in state:
        # dye gates: concentration stays physical
        # and the flow actually mixes (variance strictly below var₀)
        c = np.asarray(state["c"], dtype=np.float64)
        assert np.isfinite(c).all(), "dye field non-finite"
        assert -0.05 <= c.min() and c.max() <= 1.05, (
            f"dye concentration left [0,1]: [{c.min():.3f}, {c.max():.3f}]"
        )
        prog = np.asarray(metrics["mixing_progress"], dtype=np.float64)
        assert prog[-1] > 0.0, f"mixing index not advancing: {prog[-1]}"
        row["c_range"] = [float(c.min()), float(c.max())]
        row["mixing_progress"] = float(prog[-1])
    return row


def run_problem(problem, steps: int):
    """(steps_per_sec, compile_s, state, metrics) for a built problem."""
    from tpufem.workloads import stokes

    import jax

    # warm-up compile with the same scan length (length is baked into the
    # compiled program)
    t0 = time.perf_counter()
    state, metrics = jax.block_until_ready(stokes.run(problem, steps=steps))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, metrics = jax.block_until_ready(stokes.run(problem, steps=steps))
    elapsed = time.perf_counter() - t0

    # steady-state continuation: the cold run's early steps pay full CG
    # budgets until the warm-start + tolerance early-exit converges
    # so the from-rest number under-reports the long-campaign throughput
    # the reference workloads (1000-6000 steps) actually see
    t0 = time.perf_counter()
    jax.block_until_ready(stokes.run(problem, steps=steps, state=state))
    warm_sps = steps / (time.perf_counter() - t0)
    return steps / elapsed, t_compile, state, metrics, warm_sps


def _row(problem, mesh, config, steps, steps_per_sec, t_build, t_compile,
         state, metrics, precond, warm_steps_per_sec=None, gate="stokes"):
    phys = physics_report(problem, state, metrics, steps, gate=gate)
    # CG iterations per step: batched 2-column viscous CG + two pressure
    # solves (double projection).  With tolerance CG the pressure counts
    # are data-dependent early exits — reported as the fixed-path
    # equivalent (25/solve, the count the fixed configuration needs for
    # the same divergence trajectory).
    p_iters = 25 if config.cg_tol_pressure > 0 else config.cg_iters_pressure
    iters_per_step = config.cg_iters_visc + 2 * p_iters
    K = problem.visc_solver.K
    bandwidth = getattr(K, "bandwidth", None)
    row = {
        "n_nodes": int(problem.mesh.n_nodes),
        "n_tris": int(problem.mesh.n_tris),
        "steps": steps,
        "steps_per_sec": round(steps_per_sec, 2),
        "cg_iters_per_sec": round(steps_per_sec * iters_per_step, 0),
        "precond": precond,
        "transport": config.transport,
        "cg_iters_pressure": config.cg_iters_pressure,
        "storage": type(K).__name__,
        "bandwidth": int(bandwidth) if bandwidth is not None else None,
        "build_s": round(t_build, 1),
        "compile_s": round(t_compile, 1),
    }
    if warm_steps_per_sec is not None:
        row["warm_steps_per_sec"] = round(warm_steps_per_sec, 2)
    row.update(phys)
    if config.transport == "tracers":
        row["n_tracers"] = int(problem.tracer_init.shape[0])
        row["eaten_final"] = int(np.asarray(metrics["eaten"])[-1])
    return row


def build_one(
    n_side: int,
    n_circle: int,
    precond: str = "twolevel",
    transport: str = "none",
    storage: str = "auto",
    pad_hole: bool = True,
    **overrides,
):
    """(mesh, config, problem, build seconds) of one sweep row;
    ``overrides`` replace fields of :func:`bench_config`'s config."""
    import dataclasses

    import tpufem
    from tpufem.workloads import stokes

    t0 = time.perf_counter()
    # pad_hole: grid-preserving numbering → the stencil operator covers
    # it; pad_hole=False takes the banded fallback
    mesh = tpufem.generate_annulus_mesh(
        n_side=n_side, n_circle=n_circle, pad_hole=pad_hole
    )
    config = bench_config(
        precond, n_nodes=int(mesh.n_nodes), transport=transport,
        storage=storage,
    )
    config = dataclasses.replace(config, **overrides)
    problem = stokes.StokesProblem.build(mesh, config)
    return mesh, config, problem, time.perf_counter() - t0


def run_one(
    n_side: int,
    n_circle: int,
    steps: int,
    precond: str = "twolevel",
    transport: str = "none",
    storage: str = "auto",
    pad_hole: bool = True,
):
    import jax

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    mesh, config, problem, t_build = build_one(
        n_side, n_circle, precond, transport, storage, pad_hole
    )
    sps, t_compile, state, metrics, warm_sps = run_problem(problem, steps)
    return _row(problem, mesh, config, steps, sps, t_build, t_compile,
                state, metrics, precond, warm_sps)


def run_imported(
    stem: str,
    steps: int,
    precond: str = "twolevel",
    transport: str = "none",
    storage: str = "auto",
):
    """An imported Triangle mesh (e.g. the reference's ``mesh_fine.1``)
    through the matrix-free path."""
    import jax

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    import tpufem
    from tpufem import config as fem_config
    from tpufem.workloads import stokes

    path = fem_config.reference_mesh_path(stem) or stem
    t0 = time.perf_counter()
    mesh = tpufem.load_mesh(path)
    config = bench_config(
        precond, n_nodes=int(mesh.n_nodes), transport=transport,
        storage=storage,
    )
    problem = stokes.StokesProblem.build(mesh, config)
    t_build = time.perf_counter() - t0
    sps, t_compile, state, metrics, warm_sps = run_problem(problem, steps)
    row = _row(problem, mesh, config, steps, sps, t_build, t_compile,
               state, metrics, precond, warm_sps, gate="imported")
    row["mesh"] = stem
    row["n_nodes_input"] = int(mesh.n_nodes)
    return row


def run_th_sparse(
    n_side: int,
    n_circle: int,
    steps: int,
    precision: str = "f64",
):
    """Timed sparse Taylor–Hood (Uzawa-CG, CSR engine) at scale, with the
    same-mesh P1/P1 projection divergence comparison (the LBB-stable path
    must run with divergence ≪ the P1/P1 path).

    Same enclosed-box squirmer as the ``--study th`` convergence ladder
    (``tpufem/convergence.py``); the comparison P1/P1 run uses the CG
    path with identical dt/ν/steps."""
    import jax

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    import tpufem
    from tpufem.mesh.p2 import p2_refine
    from tpufem.ops import calculus
    from tpufem.workloads import stokes, th_sparse

    t0 = time.perf_counter()
    mesh = tpufem.generate_annulus_mesh(n_side=n_side, n_circle=n_circle)
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    # h-scaled iteration budget: the inner velocity CG's condition number
    # grows like dt·ν/h² (Jacobi-preconditioned, mass+stiffness), so a
    # fixed 60 iterations that converges at n_side≈28 leaves a 2e-4 weak
    # residual at n_side=96 (measured) — iteration-starved, not the
    # scheme's ceiling.  Linear-in-n_side budgets restore it: measured
    # weak divergence 2.6e-5 at 96 with inner=120/outer=40/plap=30 and
    # 1.0e-6 with 180/50/40.
    ii = max(60, int(1.5 * n_side))
    io_ = max(40, n_side // 2)
    ip = max(20, n_side // 3)
    prob = th_sparse.SparseTHProblem.build(
        m2,
        th_sparse.SparseTHConfig(
            dt=0.01, nu=1.0, precision=precision,
            iters_inner=ii, iters_outer=io_, iters_plap=ip,
        ),
    )
    runner = lambda steps, **kw: th_sparse.run(
        prob, steps=steps, host_loop=True, **kw)
    t_build = time.perf_counter() - t0

    # host_loop: one compiled step serves the 1-step warm-up, the timed
    # run and the continuation
    t0 = time.perf_counter()
    jax.block_until_ready(runner(1))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    u, _, mets, th_state = jax.block_until_ready(
        runner(steps, return_state=True))
    elapsed = time.perf_counter() - t0
    u_host = np.asarray(u)
    assert np.isfinite(u_host).all(), "sparse TH bench diverged"

    # steady-state continuation
    t0 = time.perf_counter()
    jax.block_until_ready(runner(steps, state=th_state))
    th_warm_sps = steps / (time.perf_counter() - t0)

    th_weak = float(np.abs(np.asarray(prob.b_apply(u))).max())
    th_div = float(np.asarray(mets["final_div_max"]))

    # P1/P1 projection on the SAME P1 mesh, same enclosed-box squirmer
    p1 = stokes.StokesProblem.build(
        mesh,
        stokes.StokesConfig(
            dt=0.01, nu=1.0, solver="cg", precision="f32",
            transport="none", all_walls=True, cg_precond="twolevel",
            cg_warm_start=True, cg_tol_pressure=1e-5, cg_tol_visc=1e-5,
        ),
    )
    s1, m1 = stokes.run(p1, steps=steps)
    p1_div = float(np.asarray(m1["final_div_max"])[-1])
    p1_weak = float(
        np.abs(
            np.asarray(calculus.consistent_divergence_rhs(mesh, s1["u"]))
        ).max()
    )
    # like-for-like incompressibility measure: the WEAK divergence
    # ∫ψ ∇·u against the P1 test space — the residual each scheme's
    # pressure equation actually controls.  The Uzawa-CG drives it to
    # solver tolerance; the P1/P1 projection leaves an O(h) residual
    # (the reference's accuracy ceiling, README.md:19).  The nodal max
    # (final_div_max) is reported for reference-observable parity but
    # not gated: corner-sampling a P2 field adds O(h) interpolation
    # noise that can exceed the P1/P1 level at short horizons.
    assert th_weak < 0.1 * p1_weak, (
        f"sparse TH weak divergence {th_weak} not ≪ P1/P1 {p1_weak}"
    )
    return {
        "n1": int(prob.n1),
        "n2": int(prob.n2),
        "dofs": int(2 * prob.n2 + prob.n1),
        "device": jax.default_backend(),
        "steps": steps,
        "steps_per_sec": round(steps / elapsed, 2),
        "warm_steps_per_sec": round(th_warm_sps, 2),
        "precision": precision,
        "build_s": round(t_build, 1),
        "compile_s": round(t_compile, 1),
        "max_u": float(np.abs(u_host).max()),
        "th_final_div_max": th_div,
        "th_div_weak_max": th_weak,
        "p1p1_final_div_max": p1_div,
        "p1p1_div_weak_max": p1_weak,
        "div_ratio_weak": round(p1_weak / max(th_weak, 1e-30), 1),
    }


def run_ns(
    n_side: int,
    n_circle: int,
    steps: int,
    precision: str = "f32",
    precond: str = "twolevel",
):
    """Timed matrix-free Navier–Stokes (implicit advection, BiCGStab
    velocity + pinned two-level PCG pressure) at mesh sizes the
    reference's per-step dense rebuild+solve cannot touch
    (scripts/operator_spitting_ns.py:557-604 rebuilds and dense-solves an
    N×N system every step).

    host_loop: one compiled step serves the warm-up, the timed run and
    the steady-state continuation."""
    import jax

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    import tpufem
    from tpufem.ops import assembly, calculus
    from tpufem.workloads import navier_stokes as ns

    t0 = time.perf_counter()
    # pad_hole: ring-in-grid numbering → stencil-offset SpMV for both K
    # and the per-step C(u) refill
    mesh = tpufem.generate_annulus_mesh(
        n_side=n_side, n_circle=n_circle, pad_hole=True
    )
    cfg = ns.NSConfig(
        dt=1e-4,
        nu=1.0,
        solver="cg",
        precision=precision,
        cg_precond=precond,
        # identity-dominated viscous system at dt=1e-4 — a short fixed
        # BiCGStab budget converges (residuals checked by the div gate)
        cg_iters_visc=30,
        cg_iters_pressure=120,
        cg_tol=1e-5 if precision == "f32" else 1e-8,
    )
    prob = ns.NSProblem.build(mesh, cfg)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    jax.block_until_ready(ns.run(prob, steps=1, host_loop=True))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    u, mets, state = jax.block_until_ready(
        ns.run(prob, steps=steps, host_loop=True, return_state=True))
    elapsed = time.perf_counter() - t0
    u_host = np.asarray(u, dtype=np.float64)

    # steady-state continuation: early from-rest steps pay full solver
    # budgets until warm starts converge
    t0 = time.perf_counter()
    jax.block_until_ready(
        ns.run(prob, steps=steps, host_loop=True, state=state))
    warm_sps = steps / (time.perf_counter() - t0)

    assert np.isfinite(u_host).all(), "NS bench diverged (non-finite u)"
    # boundedness: an impulsively-forced viscous channel cannot exceed the
    # inviscid ballistic growth |f|·t — measured max_u is ~6% of it
    u_cap = 10.0 * float(np.abs(cfg.body_force).max()) * steps * cfg.dt
    assert np.abs(u_host).max() < u_cap, (
        f"NS velocity {np.abs(u_host).max():.2e} exceeds 10×|f|·t={u_cap:.2e}"
    )
    import jax.numpy as jnp

    div = np.asarray(
        calculus.divergence(mesh, jnp.asarray(u)), dtype=np.float64
    )
    ml = np.asarray(assembly.lumped_mass(mesh), dtype=np.float64)
    h = float(np.sqrt(2.0 * np.median(np.asarray(mesh.area))))
    div_l2 = float(np.sqrt((ml * div**2).sum()))
    u_l2 = float(np.sqrt((ml * (u_host**2).sum(axis=1)).sum()))
    div_rel = div_l2 * h / max(u_l2, 1e-30)
    assert div_rel < DIV_REL_GATES["ns"], (
        f"NS normalized divergence {div_rel:.3f} ≥ {DIV_REL_GATES['ns']}"
    )
    return {
        "workload": "navier_stokes",
        "n_nodes": int(mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "steps": steps,
        "steps_per_sec": round(steps / elapsed, 2),
        "warm_steps_per_sec": round(warm_sps, 2),
        "precision": precision,
        "precond": precond,
        "storage": type(prob.K_csr).__name__,
        "build_s": round(t_build, 1),
        "compile_s": round(t_compile, 1),
        "max_u": float(np.abs(u_host).max()),
        "div_star_max": float(np.asarray(mets["div_star_max"])),
        "div_rel": round(div_rel, 4),
    }


def run_poisson_large(n_side: int, n_circle: int, precision: str = "f32"):
    """Timed matrix-free Poisson solve (exact row-surgery operator +
    two-level BiCGStab) at sizes the reference's dense
    ``np.linalg.solve`` (code/poisson.py:283-287, O(N³) on ≤1067 nodes)
    cannot touch.  Gated on the solver's own relative residual and on
    the Dirichlet rows coming back at their prescribed values."""
    import jax

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    import tpufem
    from tpufem.workloads import poisson

    t0 = time.perf_counter()
    mesh = tpufem.generate_annulus_mesh(
        n_side=n_side, n_circle=n_circle, pad_hole=True
    )
    cfg = poisson.PoissonConfig(
        solver="cg", precision=precision,
        cg_iters=2000, cg_tol=1e-6 if precision == "f32" else 1e-10,
    )
    run, op, b, boundary = poisson.make_cg_solver(mesh, cfg)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    f, res = run(b)
    f.block_until_ready()
    t_compile_solve = time.perf_counter() - t0
    t0 = time.perf_counter()
    f, res = jax.block_until_ready(run(b))
    solve_s = time.perf_counter() - t0
    f_host = np.asarray(f, dtype=np.float64)

    assert np.isfinite(f_host).all(), "Poisson solve non-finite"
    b_norm = float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
    res_rel = float(res) / max(b_norm, 1e-30)
    assert res_rel < 1e-4, f"Poisson relative residual {res_rel:.2e} ≥ 1e-4"
    # Dirichlet rows are identity rows after surgery: the solution must
    # carry the prescribed wall/inner values to solver tolerance
    inner_set = set(boundary.inner.tolist())
    want = np.array([
        cfg.inner_value if int(nd) in inner_set else cfg.outer_value
        for nd in boundary.dirichlet
    ])
    bc_err = float(np.abs(f_host[boundary.dirichlet] - want).max())
    assert bc_err < 1e-3, f"Poisson Dirichlet values off by {bc_err:.2e}"
    return {
        "workload": "poisson",
        "n_nodes": int(mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "precision": precision,
        "storage": type(op).__name__,
        "build_s": round(t_build, 1),
        "compile_plus_solve_s": round(t_compile_solve, 1),
        "solve_s": round(solve_s, 3),
        "res_rel": res_rel,
        "bc_err_max": bc_err,
        "f_range": [float(f_host.min()), float(f_host.max())],
    }


def run_heat_large(n_side: int, n_circle: int, steps: int = 50,
                   precision: str = "f32"):
    """Timed matrix-free implicit-Euler heat run (warm-started BiCGStab
    on A = I + dt·K_mod, reference quirks preserved) at sizes the
    reference's per-run dense solve loop (code/heatEq.py:320-333, 600 ×
    O(N³)) cannot touch.  Gated on boundedness: the wall/inner Dirichlet
    drive keeps u in [0, 1] up to solver tolerance."""
    import jax

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    import tpufem
    from tpufem.workloads import heat

    t0 = time.perf_counter()
    mesh = tpufem.generate_annulus_mesh(
        n_side=n_side, n_circle=n_circle, pad_hole=True
    )
    cfg = heat.HeatConfig(
        solver="cg", precision=precision, steps=steps,
        cg_iters=60, cg_tol=1e-6 if precision == "f32" else 1e-10,
    )
    # build once (heat.run caches the scan per problem identity)
    problem = heat.HeatProblem.build(mesh, cfg)
    t_build = time.perf_counter() - t0

    u0 = heat.initial_state(problem, mesh.n_nodes)
    step = heat.make_step(problem)

    @jax.jit
    def scan_all(u0):
        return jax.lax.scan(step, u0, None, length=steps)

    t0 = time.perf_counter()
    u, maxu = scan_all(u0)
    u.block_until_ready()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    u, maxu = jax.block_until_ready(scan_all(u0))
    elapsed = time.perf_counter() - t0
    u_host = np.asarray(u, dtype=np.float64)

    assert np.isfinite(u_host).all(), "heat run non-finite"
    assert -1e-2 <= u_host.min() and u_host.max() <= 1.0 + 1e-2, (
        f"heat field left [0,1]: [{u_host.min():.3e}, {u_host.max():.3e}]"
    )
    return {
        "workload": "heat",
        "n_nodes": int(mesh.n_nodes),
        "n_tris": int(mesh.n_tris),
        "steps": steps,
        "steps_per_sec": round(steps / elapsed, 2),
        "precision": precision,
        "storage": type(problem.solver.op).__name__,
        "build_s": round(t_build, 1),
        "compile_s": round(t_compile, 1),
        "u_range": [float(u_host.min()), float(u_host.max())],
        "max_u_final": float(np.asarray(maxu)[-1]),
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(prog="tpufem bench --large")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--sizes", default=None,
                        help="comma-separated labels from %s" % [s[0] for s in SIZES])
    parser.add_argument("--precond", default="twolevel",
                        choices=["twolevel", "jacobi"])
    parser.add_argument("--transport", default="none",
                        choices=["none", "tracers", "dye"])
    parser.add_argument("--storage", default="auto",
                        help="cg_storage: auto | stencil | banded | csr")
    parser.add_argument("--no-pad-hole", action="store_true",
                        help="compacted (non-grid) numbering")
    parser.add_argument("--mesh", default=None,
                        help="imported mesh stem (e.g. mesh_fine.1) instead "
                             "of the generated size sweep")
    parser.add_argument("--th", action="store_true",
                        help="sparse Taylor–Hood (Uzawa-CG) timed run + "
                             "same-mesh P1/P1 divergence comparison")
    parser.add_argument("--ns", action="store_true",
                        help="matrix-free Navier–Stokes (implicit "
                             "advection) scaling rows instead of Stokes")
    parser.add_argument("--poisson", action="store_true",
                        help="matrix-free steady Poisson solve rows")
    parser.add_argument("--heat", action="store_true",
                        help="matrix-free implicit-Euler heat rows")
    parser.add_argument("--n-side", type=int, default=96,
                        help="--th mesh resolution (P2 dofs ≈ 4·n_side²)")
    parser.add_argument("--precision", default=None,
                        help="--th/--ns/--poisson/--heat precision override "
                             "(f32 | f64); --th defaults to f64 (the parity "
                             "precision), the others to f32")
    parser.add_argument("--out", default=None, help="write JSONL here too")
    args = parser.parse_args(argv)

    rows = []
    if args.th:
        r = run_th_sparse(args.n_side, args.n_side, args.steps,
                          precision=args.precision or "f64")
        r["label"] = f"th-{args.n_side}"
        print(json.dumps(r), flush=True)
        rows.append(r)
    elif args.ns:
        wanted = set(args.sizes.split(",")) if args.sizes else {"26k", "79k"}
        for label, n_side, n_circle in SIZES:
            if label not in wanted:
                continue
            r = run_ns(n_side, n_circle, args.steps, precond=args.precond,
                       precision=args.precision or "f32")
            r["label"] = f"ns-{label}"
            print(json.dumps(r), flush=True)
            rows.append(r)
    elif args.poisson or args.heat:
        wanted = set(args.sizes.split(",")) if args.sizes else (
            {"1.05M"} if args.poisson else {"160k"}
        )
        for label, n_side, n_circle in SIZES:
            if label not in wanted:
                continue
            if args.poisson:
                r = run_poisson_large(n_side, n_circle,
                                      precision=args.precision or "f32")
                r["label"] = f"poisson-{label}"
            else:
                r = run_heat_large(n_side, n_circle, args.steps,
                                   precision=args.precision or "f32")
                r["label"] = f"heat-{label}"
            print(json.dumps(r), flush=True)
            rows.append(r)
    elif args.mesh:
        r = run_imported(args.mesh, args.steps, precond=args.precond,
                         transport=args.transport, storage=args.storage)
        r["label"] = args.mesh
        print(json.dumps(r), flush=True)
        rows.append(r)
    else:
        wanted = set(args.sizes.split(",")) if args.sizes else None
        for label, n_side, n_circle in SIZES:
            if wanted is not None and label not in wanted:
                continue
            if wanted is None and label in LARGE_OPT_IN:
                continue  # the ≥400k rows are opt-in
            r = run_one(n_side, n_circle, args.steps, precond=args.precond,
                        transport=args.transport, storage=args.storage,
                        pad_hole=not args.no_pad_hole)
            r["label"] = label
            print(json.dumps(r), flush=True)
            rows.append(r)

    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")

    if args.th or args.ns or args.poisson or args.heat:
        return rows
    print("\n| nodes | steps/s | CG iters/s | div_rel | storage | compile (s) |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['n_nodes']} | {r['steps_per_sec']} | "
            f"{int(r['cg_iters_per_sec'])} | {r['div_rel']} | "
            f"{r['storage']} | {r['compile_s']} |"
        )
    return rows


if __name__ == "__main__":
    main()
