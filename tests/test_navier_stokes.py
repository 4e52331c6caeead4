"""Monolithic saddle-point Stokes and operator-split NS tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from baselines import numpy_ref
from tpufem.ops import calculus
from tpufem.workloads import navier_stokes as ns


def test_monolithic_assembly_matches_oracle(mesh1):
    """The 3N×3N assembly is structurally identical to the reference's.
    (The P1/P1 system itself is LBB-rank-deficient — see MonolithicConfig —
    so parity is checked at the assembly level plus min-norm solutions.)"""
    A, b = ns.assemble_monolithic(mesh1)
    A_ref, b_ref = numpy_ref.monolithic_stokes_system(
        mesh1.coords, mesh1.tris, mesh1.markers
    )
    np.testing.assert_allclose(A, A_ref, atol=1e-10)
    np.testing.assert_allclose(b, b_ref, atol=1e-12)


def test_monolithic_solution_is_finite_and_divergence_free(mesh1):
    u, p, residual = ns.solve_monolithic(mesh1)
    assert np.isfinite(np.asarray(u)).all() and np.isfinite(np.asarray(p)).all()
    assert float(residual) < 1e-6  # the compatible part is solved exactly


def test_monolithic_bcs(mesh1):
    u, p, _ = ns.solve_monolithic(mesh1)
    u = np.asarray(u)
    cfg = ns.MonolithicConfig()
    outer = mesh1.markers == cfg.outer_marker
    np.testing.assert_allclose(u[outer], 0.0, atol=1e-12)
    assert abs(float(p[0])) < 1e-12  # pinned
    # inner boundary: |u| = U0 (unit tangential, origin-normalized quirk)
    inner = mesh1.markers == cfg.inner_marker
    np.testing.assert_allclose(np.linalg.norm(u[inner], axis=1), cfg.U0, rtol=1e-9)


def test_monolithic_divergence_small(mesh1):
    """The coupled solve enforces the discrete incompressibility directly —
    interior divergence should be far below the BC velocity scale."""
    u, _, _ = ns.solve_monolithic(mesh1)
    div = np.asarray(calculus.divergence(mesh1, u))
    interior = mesh1.markers == 0
    assert np.abs(div[interior]).mean() < 0.5


def test_taylor_hood_stable_and_exact():
    """P2/P1 Taylor–Hood on mesh2.2 — the LBB-stable coupled solve the
    reference's P2 mesh was for.  Unlike the P1/P1 system (rank-deficient,
    see MonolithicConfig), this one solves exactly."""
    from tpufem import config as tcfg
    import tpufem

    stem = tcfg.reference_mesh_path("mesh2.2")
    if stem is None:
        pytest.skip("mesh2.2 not available")
    mesh = tpufem.load_mesh(stem)
    u, p, res = ns.solve_taylor_hood(mesh)
    assert float(res) < 1e-10  # nonsingular: LU solves it exactly
    u = np.asarray(u)
    assert np.isfinite(u).all() and np.isfinite(np.asarray(p)).all()
    # squirmer BC exact on the inner boundary (including midside nodes)
    from tpufem import bc as bc_mod

    inner = np.nonzero(mesh.markers == 2)[0]
    vals = bc_mod.squirmer_values(mesh.coords, inner)
    np.testing.assert_allclose(u[inner], vals, atol=1e-12)
    # no-slip outer
    np.testing.assert_allclose(u[mesh.markers == 1], 0.0, atol=1e-12)
    # weak incompressibility enforced: P1-projected divergence is small
    from tpufem.ops import calculus

    div = np.asarray(calculus.divergence(mesh, jnp.asarray(u)))
    interior = mesh.markers == 0
    assert np.abs(div[interior]).mean() < 0.1


def test_transient_taylor_hood_converges_and_beats_p1p1():
    """θ-scheme transient TH squirmer: reaches the steady
    TH solution to machine precision, and its interior divergence beats the
    P1/P1 projection path on the same geometry by ≳3× — surpassing the
    reference's own accuracy ceiling (README.md:19)."""
    from tpufem import config as tcfg
    import tpufem
    from tpufem.workloads import stokes

    stem = tcfg.reference_mesh_path("mesh2.2")
    if stem is None:
        pytest.skip("mesh2.2 not available")
    mesh = tpufem.load_mesh(stem)
    u_s, _, _ = ns.solve_taylor_hood(mesh)
    prob = ns.TransientTHProblem.build(
        mesh, ns.TransientTHConfig(dt=0.05, steps=400)
    )
    u_t, p_t, metrics = ns.run_transient_th(prob)
    u_t, u_s = np.asarray(u_t), np.asarray(u_s)
    assert np.isfinite(u_t).all()
    err = np.linalg.norm(u_t - u_s) / np.linalg.norm(u_s)
    assert err < 1e-10, err  # transient → steady (constant BCs)

    # same squirmer on the P1/P1 projection path (mesh2.1 = the same
    # domain's P1 triangulation)
    stem1 = tcfg.reference_mesh_path("mesh2.1")
    if stem1 is None:
        pytest.skip("mesh2.1 not available")
    mesh1 = tpufem.load_mesh(stem1)
    p1 = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(dt=0.05, nu=1.0, pressure_mode="merge",
                            transport="none"),
    )
    state, _ = stokes.run(p1, steps=400)
    div_p1 = np.abs(np.asarray(calculus.divergence(mesh1, state["u"])))
    div_th = np.abs(np.asarray(calculus.divergence(mesh, jnp.asarray(u_t))))
    m_p1 = div_p1[mesh1.markers == 0].mean()
    m_th = div_th[mesh.markers == 0].mean()
    assert m_th * 3 < m_p1, (m_th, m_p1)  # measured ~7×: 0.040 vs 0.275


def test_ns_projection_channel_flow(mesh1):
    """Driven channel (body force 0.1 in x): flow develops in +x, stays
    finite, no-slip on all walls (operator_spitting_ns.py config)."""
    problem = ns.NSProblem.build(mesh1, ns.NSConfig(dt=1e-4, steps=50))
    u, metrics = ns.run(problem)
    u = np.asarray(u)
    assert np.isfinite(u).all()
    interior = mesh1.markers == 0
    assert u[interior, 0].mean() > 0.0  # net +x flow
    np.testing.assert_allclose(u[problem.wall_mask], 0.0, atol=1e-12)
    assert np.isfinite(np.asarray(metrics["max_p"])).all()


def test_ns_long_run_is_stable(mesh21):
    """The mass-lumped pressure scaling keeps the NS projection stable for
    the full reference run length (the committed raw-K scaling does not —
    see NSConfig.pressure_scaling)."""
    problem = ns.NSProblem.build(mesh21, ns.NSConfig())
    u, metrics = ns.run(problem, steps=500)
    mu = np.asarray(metrics["max_u"])
    assert np.isfinite(mu).all()
    assert mu[-1] < 1.0  # bounded channel flow


def test_ns_raw_pressure_scaling_reproduces_reference_instability(mesh21):
    """The committed script's unlumped pressure operator blows up within
    tens of steps — preserved as a documented reference quirk."""
    problem = ns.NSProblem.build(
        mesh21, ns.NSConfig(pressure_scaling="raw")
    )
    u, metrics = ns.run(problem, steps=100)
    mu = np.asarray(metrics["max_u"])
    assert (~np.isfinite(mu)).any() or mu.max() > 1e6


def test_stokes_unknown_transport_rejected(mesh1):
    from tpufem.workloads import stokes

    with pytest.raises(ValueError, match="unknown transport"):
        stokes.StokesProblem.build(mesh1, stokes.StokesConfig(transport="nonsense"))


def test_ns_matfree_matches_dense(mesh1):
    """solver="cg" (matrix-free convection + BiCGStab u* + pinned PCG
    pressure) tracks the dense parity path on the bundled mesh."""
    dense = ns.NSProblem.build(mesh1, ns.NSConfig(dt=1e-4))
    mf = ns.NSProblem.build(
        mesh1, ns.NSConfig(dt=1e-4, solver="cg", cg_tol=1e-12,
                           cg_iters_visc=150, cg_iters_pressure=400)
    )
    ud, _ = ns.run(dense, steps=25)
    um, metrics = ns.run(mf, steps=25)
    np.testing.assert_allclose(np.asarray(um), np.asarray(ud), atol=2e-8)
    assert np.isfinite(np.asarray(metrics["max_p"])).all()


def test_ns_matfree_convection_apply_matches_materialized(mesh1):
    """The opsplit-scaling matrix-free C(u)·x equals the materialized
    element_convection operator product."""
    from tpufem.ops import assembly

    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    x = jnp.asarray(rng.standard_normal(mesh1.n_nodes))
    C = assembly.assemble_dense(
        mesh1, assembly.element_convection(mesh1, u, variant="opsplit")
    )
    np.testing.assert_allclose(
        np.asarray(calculus.convection_apply(mesh1, u, x, variant="opsplit")),
        np.asarray(C @ x),
        atol=1e-12,
    )


def test_ns_matfree_long_run_is_stable(mesh21):
    problem = ns.NSProblem.build(mesh21, ns.NSConfig(solver="cg"))
    u, metrics = ns.run(problem, steps=300)
    mu = np.asarray(metrics["max_u"])
    assert np.isfinite(mu).all()
    assert mu[-1] < 1.0  # bounded channel flow


def test_ns_host_loop_matches_scan(mesh21):
    """run(host_loop=True) reproduces the scanned trajectory on both the
    matfree and the dense path (one dispatch per step instead of one
    scanned program)."""
    mf = ns.NSProblem.build(
        mesh21, ns.NSConfig(dt=1e-4, solver="cg", cg_tol=1e-12,
                            cg_iters_visc=150, cg_iters_pressure=400)
    )
    u_scan, _ = ns.run(mf, steps=8)
    u_host, mets = ns.run(mf, steps=8, host_loop=True)
    np.testing.assert_allclose(np.asarray(u_host), np.asarray(u_scan),
                               atol=1e-12)
    assert np.isfinite(float(mets["max_p"]))

    dense = ns.NSProblem.build(mesh21, ns.NSConfig(dt=1e-4))
    u_scan, _ = ns.run(dense, steps=5)
    u_host, _ = ns.run(dense, steps=5, host_loop=True)
    np.testing.assert_allclose(np.asarray(u_host), np.asarray(u_scan),
                               atol=1e-12)


def test_ns_f32_runs(mesh1):
    problem = ns.NSProblem.build(mesh1, ns.NSConfig(dt=1e-4, precision="f32"))
    u, metrics = ns.run(problem, steps=20)
    assert u.dtype == jnp.float32
    assert np.isfinite(np.asarray(u)).all()
