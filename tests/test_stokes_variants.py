"""Report variant, Eulerian dye, griddata dye tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from baselines import numpy_ref
from tpufem import bc
from tpufem.ops import assembly
from tpufem.workloads import stokes


def test_report_variant_runs_and_ramps(mesh1):
    """clean_for_report pipeline: rotating cylinder, ramped BCs, pinned +
    smoothed pressure."""
    cfg = stokes.StokesConfig(
        variant="report",
        bc_kind="rotating",
        omega=5.0,
        ramp_steps=10,
        dt=1e-4,
        nu=0.1,
        pressure_smoothing=0.01,
        double_projection=False,
    )
    problem = stokes.StokesProblem.build(mesh1, cfg)
    assert problem.pressure_pin >= 0
    assert problem.smooth_solver is not None
    state, metrics = stokes.run(problem, steps=12)
    u = np.asarray(state["u"])
    assert np.isfinite(u).all()
    # post-ramp: inner boundary speed = ω r
    mags = np.linalg.norm(u[problem.boundary.inner], axis=1)
    np.testing.assert_allclose(mags, 5.0 * 0.25, rtol=1e-6)
    # walls are no-slip
    np.testing.assert_allclose(u[problem.boundary.walls], 0.0, atol=1e-12)


def test_convection_opsplit_scaling(mesh1):
    """Op-split convection = 2× the StokesColor scaling on a CCW mesh."""
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    c1 = assembly.assemble_dense(mesh1, assembly.element_convection(mesh1, u))
    c2 = assembly.assemble_dense(
        mesh1, assembly.element_convection(mesh1, u, variant="opsplit")
    )
    ref = numpy_ref.build_convection(mesh1.coords, mesh1.tris, np.asarray(u), "opsplit")
    np.testing.assert_allclose(np.asarray(c2), ref, atol=1e-10)
    if (mesh1.det > 0).all():
        np.testing.assert_allclose(np.asarray(c2), 2 * np.asarray(c1), atol=1e-10)


def test_eulerian_dye_matches_oracle(mesh1):
    cfg = stokes.StokesConfig(transport="eulerian_dye", D=1e-3)
    problem = stokes.StokesProblem.build(mesh1, cfg)
    state = stokes.initial_state(problem)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((mesh1.n_nodes, 2)) * 0.1
    c = np.asarray(state["c"])

    c_tpufem = np.asarray(
        stokes.eulerian_dye_step(problem, jnp.asarray(c), jnp.asarray(u))
    )
    b = problem.boundary
    pairs = list(zip(b.masters.tolist(), b.slaves.tolist()))
    m_l = numpy_ref.lumped_mass(mesh1.coords, mesh1.tris)
    M = numpy_ref.build_consistent_mass(mesh1.coords, mesh1.tris)
    K = numpy_ref.build_stiffness(mesh1.coords, mesh1.tris)
    c_ref = numpy_ref.eulerian_dye_step(
        mesh1.coords, mesh1.tris, mesh1.markers, pairs, m_l, M, K, c, u,
        cfg.dt, cfg.D,
    )
    np.testing.assert_allclose(c_tpufem, c_ref, atol=1e-7)


def test_eulerian_dye_run_mixes(mesh1):
    cfg = stokes.StokesConfig(transport="eulerian_dye", steps=20)
    problem = stokes.StokesProblem.build(mesh1, cfg)
    state, metrics = stokes.run(problem)
    c = np.asarray(state["c"])
    assert c.min() >= 0.0 and c.max() <= 1.0
    assert float(metrics["mixing_progress"][-1]) > 0.0


def test_eulerian_dye_f32_merge_path(mesh1):
    gold = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(transport="eulerian_dye")
    )
    fast = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            transport="eulerian_dye", precision="f32", pressure_mode="merge",
            solver="inverse",
        ),
    )
    sg, _ = stokes.run(gold, steps=10)
    sf, _ = stokes.run(fast, steps=10)
    err = np.linalg.norm(np.asarray(sf["c"]) - np.asarray(sg["c"])) / np.linalg.norm(
        np.asarray(sg["c"])
    )
    assert err < 5e-3, err


def test_griddata_dye_run(mesh1):
    cfg = stokes.StokesConfig(transport="dye_griddata", steps=20)
    problem = stokes.StokesProblem.build(mesh1, cfg)
    state, metrics = stokes.run(problem)
    c = np.asarray(state["c"])
    assert np.isfinite(c).all()
    assert c.min() >= 0.0 and c.max() <= 1.0
    assert float(metrics["mixing_progress"][-1]) > 0.0


def test_report_variant_cg_matches_dense(mesh5):
    """variant='report' on the matrix-free CG path (pinned
    PressureCG + pin-masked smoothing CG) vs the dense penalty-f64 path.
    The residual ~3e-4 difference is the documented mass-weighting gap
    between the penalty and DOF-merged periodic forms (matfree.py
    docstring) — identical for the standard variant."""
    base = dict(
        variant="report", bc_kind="rotating", dt=1e-5, omega=5.0,
        ramp_steps=200, nu=0.1, transport="none", pressure_smoothing=0.01,
    )
    p1 = stokes.StokesProblem.build(
        mesh5, stokes.StokesConfig(solver="lu", precision="f64", **base)
    )
    s1, m1 = stokes.run(p1, steps=30)
    p2 = stokes.StokesProblem.build(
        mesh5,
        stokes.StokesConfig(
            solver="cg", cg_storage="csr", precision="f64",
            cg_precond="jacobi", cg_iters_visc=80, cg_iters_pressure=400,
            **base,
        ),
    )
    assert p2.pressure_pin == p1.pressure_pin >= 0
    assert p2.smooth_solver is not None
    s2, m2 = stokes.run(p2, steps=30)
    np.testing.assert_allclose(
        np.asarray(s1["u"]), np.asarray(s2["u"]), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(m1["final_div_max"]),
        np.asarray(m2["final_div_max"]),
        rtol=2e-2,
    )


def test_report_variant_cg_no_smoothing_warm_start(mesh5):
    """Report + CG with warm starts and tolerance CG (the large-mesh
    configuration) stays consistent with the fixed-iteration run."""
    base = dict(
        variant="report", bc_kind="rotating", dt=1e-5, omega=5.0,
        ramp_steps=0, nu=0.1, transport="none",
    )
    p1 = stokes.StokesProblem.build(
        mesh5,
        stokes.StokesConfig(
            solver="cg", cg_storage="csr", precision="f64",
            cg_precond="jacobi", cg_iters_visc=80, cg_iters_pressure=400,
            cg_warm_start=False, **base,
        ),
    )
    s1, _ = stokes.run(p1, steps=10)
    p2 = stokes.StokesProblem.build(
        mesh5,
        stokes.StokesConfig(
            solver="cg", cg_storage="csr", precision="f64",
            cg_precond="jacobi", cg_iters_visc=80, cg_iters_pressure=400,
            cg_warm_start=True, cg_tol_pressure=1e-10, cg_tol_visc=1e-10,
            **base,
        ),
    )
    s2, _ = stokes.run(p2, steps=10)
    np.testing.assert_allclose(
        np.asarray(s1["u"]), np.asarray(s2["u"]), atol=1e-6
    )


def test_dirichlet_lift_recovers_viscous_traction(mesh1):
    """docs/PARITY.md §7: without the lift the squirmer's tangential slip
    exerts no viscous traction (the reference drops the eliminated
    Dirichlet columns, StokesColor.py:472-475) and the interior flow is
    systematically weak; the lifted discretization produces a stronger,
    TH-consistent flow.  Parity default (False) must stay bit-unchanged."""
    base = dict(dt=0.01, nu=1.0, transport="none", all_walls=True)
    p0 = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(solver="lu", precision="f64", **base)
    )
    s0, _ = stokes.run(p0, steps=150)
    p1 = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            solver="lu", precision="f64", dirichlet_lift=True, **base
        ),
    )
    assert p1.visc_lift is not None
    s1, _ = stokes.run(p1, steps=150)
    interior = p1.boundary.interior
    n0 = np.linalg.norm(np.asarray(s0["u"])[interior])
    n1 = np.linalg.norm(np.asarray(s1["u"])[interior])
    assert n1 > 1.3 * n0, (n0, n1)  # measured ~1.6× on the bundled meshes


def test_dirichlet_lift_matches_across_solvers(mesh1):
    """lift on the CG path == lift on the dense path.

    The lift vectors must agree exactly; the trajectories agree to the
    paths' inherent ~5e-3 merged-row-weighting gap (the dense merge
    operator merges M_L-scaled rows — the penalty limit — while
    PressureCG merges unscaled rows; solve/pressure.py vs matfree.py)."""
    base = dict(
        dt=0.01, nu=1.0, transport="none", dirichlet_lift=True,
    )
    p1 = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            solver="lu", precision="f64", pressure_mode="merge", **base
        ),
    )
    s1, _ = stokes.run(p1, steps=5)
    p2 = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            solver="cg", cg_storage="csr", precision="f64",
            cg_precond="jacobi", cg_iters_visc=120, cg_iters_pressure=500,
            cg_warm_start=False, **base,
        ),
    )
    np.testing.assert_array_equal(
        np.asarray(p1.visc_lift), np.asarray(p2.visc_lift)
    )
    s2, _ = stokes.run(p2, steps=5)
    np.testing.assert_allclose(
        np.asarray(s1["u"]), np.asarray(s2["u"]), atol=8e-3
    )
