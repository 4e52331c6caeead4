"""Matrix-free CG path: correctness vs dense, large-mesh scaling smoke."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpufem
from tpufem.ops import assembly
from tpufem.workloads import stokes


def test_cg_viscous_solver_matches_dense(mesh1):
    dense = stokes.StokesProblem.build(mesh1, stokes.StokesConfig(pressure_mode="merge"))
    cgp = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(solver="cg", cg_iters_visc=100)
    )
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    x_dense = dense.visc_solver.solve(b)
    x_cg = cgp.visc_solver.solve(b)
    np.testing.assert_allclose(np.asarray(x_cg), np.asarray(x_dense), atol=1e-8)


def test_cg_pressure_solver_matches_dense_gradient(mesh1):
    """Pressure solutions agree modulo constants (compare gradients)."""
    from tpufem.ops import calculus

    dense = stokes.StokesProblem.build(mesh1, stokes.StokesConfig(pressure_mode="merge"))
    cgp = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(solver="cg", cg_iters_pressure=800)
    )
    from tpufem.ops import assembly

    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    b = -calculus.divergence(mesh1, u) / 0.05
    # compatible rhs (zero net mass-weighted divergence): the two paths
    # only provably agree on the solvable component
    ml = assembly.lumped_mass(mesh1)
    b = b - jnp.sum(ml * b) / jnp.sum(ml)
    g_dense = np.asarray(calculus.gradient(mesh1, dense.pressure_solver.solve(b)))
    g_cg = np.asarray(calculus.gradient(mesh1, cgp.pressure_solver.solve(b)))
    err = np.linalg.norm(g_cg - g_dense) / np.linalg.norm(g_dense)
    # merged boundary-pair equations carry different (weak) mass weighting
    # than the penalty-limit rows — agreement is at the physical level
    assert err < 0.05, err


def test_cg_stokes_run_tracks_dense(mesh1):
    dense = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(transport="dye", pressure_mode="merge")
    )
    cgp = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            transport="dye", solver="cg", cg_iters_visc=80, cg_iters_pressure=600
        ),
    )
    sd, md = stokes.run(dense, steps=10)
    sc, mc = stokes.run(cgp, steps=10)
    err = np.linalg.norm(np.asarray(sc["u"]) - np.asarray(sd["u"])) / np.linalg.norm(
        np.asarray(sd["u"])
    )
    assert err < 0.02, err
    assert abs(float(mc["mixing_var"][-1]) - float(md["mixing_var"][-1])) < 1e-3


def test_banded_operator_matches_csr(mesh1):
    from tpufem.ops import assembly
    from tpufem.ops.banded import BandedOperator

    K = assembly.assemble_csr(mesh1, assembly.element_stiffness(mesh1))
    band = BandedOperator.build(K, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(mesh1.n_nodes))
    np.testing.assert_allclose(
        np.asarray(band.matvec(x)), np.asarray(K.matvec(x)), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(band.diag()), np.asarray(K.diag()), atol=1e-12
    )
    assert band.bandwidth < mesh1.n_nodes // 2  # RCM actually compresses


def test_cg_banded_storage_matches_csr(mesh1):
    csr = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(solver="cg", cg_storage="csr")
    )
    band = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(solver="cg", cg_storage="banded")
    )
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    np.testing.assert_allclose(
        np.asarray(band.visc_solver.solve(b)),
        np.asarray(csr.visc_solver.solve(b)),
        atol=1e-9,
    )
    bp = jnp.asarray(rng.standard_normal(mesh1.n_nodes))
    np.testing.assert_allclose(
        np.asarray(band.pressure_solver.solve(bp)),
        np.asarray(csr.pressure_solver.solve(bp)),
        atol=1e-7,
    )


def test_matrix_free_mass_and_convection_apply(mesh1):
    from tpufem.ops import assembly, calculus

    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.standard_normal(mesh1.n_nodes))
    u = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    M = assembly.assemble_dense(mesh1, assembly.element_mass(mesh1))
    C = assembly.assemble_dense(mesh1, assembly.element_convection(mesh1, u))
    np.testing.assert_allclose(
        np.asarray(calculus.mass_apply(mesh1, c)), np.asarray(M @ c), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(calculus.convection_apply(mesh1, u, c)), np.asarray(C @ c),
        atol=1e-12,
    )


def test_cg_eulerian_dye_tracks_dense(mesh1):
    """Matrix-free BiCGStab Eulerian dye ≈ the dense merged-path dye."""
    dense = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            transport="eulerian_dye", precision="f32", pressure_mode="merge",
            solver="inverse",
        ),
    )
    mf = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            transport="eulerian_dye", solver="cg", precision="f32",
            cg_iters_visc=80, cg_iters_pressure=400, cg_iters_dye=60,
        ),
    )
    sd, md = stokes.run(dense, steps=10)
    sm, mm = stokes.run(mf, steps=10)
    cd, cm = np.asarray(sd["c"]), np.asarray(sm["c"])
    assert np.isfinite(cm).all()
    assert cm.min() >= 0.0 and cm.max() <= 1.0
    err = np.linalg.norm(cm - cd) / np.linalg.norm(cd)
    assert err < 0.02, err


def test_chebyshev_preconditioner_converges(mesh1):
    """Chebyshev-PCG reaches the same pressure solution as Jacobi-PCG
    (an SPD polynomial preconditioner — option for latency-bound
    distributed runs)."""
    from tpufem.ops import calculus

    jac = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(solver="cg", cg_iters_pressure=600)
    ).pressure_solver
    che = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            solver="cg", cg_iters_pressure=150, cg_precond="chebyshev"
        ),
    ).pressure_solver
    assert che.lmax > 0
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    b = -calculus.divergence(mesh1, u) / 0.05
    act = np.asarray(jac.active_mask) > 0
    p1 = np.asarray(jac.solve(b))
    p2 = np.asarray(che.solve(b))
    d1 = p1[act] - p1[act].mean()
    d2 = p2[act] - p2[act].mean()
    np.testing.assert_allclose(d2, d1, atol=1e-6)


def test_stencil_operator_exact_on_arbitrary_mesh(mesh1):
    """The stencil decomposition (top offsets + COO remainder) is EXACT on
    any mesh/ordering — coverage only affects speed."""
    from tpufem.ops.stencil import StencilOperator

    K = assembly.assemble_csr(mesh1, assembly.element_stiffness(mesh1))
    st = StencilOperator.build(K, dtype=jnp.float64)
    assert 0.0 < st.coverage < 1.0  # reference numbering: big remainder
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(mesh1.n_nodes))
    np.testing.assert_allclose(
        np.asarray(st.matvec(x)), np.asarray(K.matvec(x)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(st.diag()), np.asarray(K.diag()), atol=1e-12
    )


def test_stencil_coverage_on_pad_hole_mesh():
    """pad_hole generation preserves grid numbering: ≥95% of nnz land on
    static stencil offsets (the O(nnz) gather-free SpMV)."""
    from tpufem.ops.stencil import StencilOperator

    mesh = tpufem.generate_annulus_mesh(n_side=60, n_circle=64, pad_hole=True)
    assert (mesh.markers == -1).sum() > 0  # dummies exist
    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh))
    st = StencilOperator.build(K, dtype=jnp.float64)
    assert st.coverage >= 0.95, st.coverage
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal(mesh.n_nodes))
    np.testing.assert_allclose(
        np.asarray(st.matvec(x)), np.asarray(K.matvec(x)), atol=1e-12
    )


def test_stencil_min_fill_trims_sparse_offsets():
    """min_fill demotes near-empty diagonals (each costs a full O(N) FMA
    pass for a handful of entries) to the COO remainder: pad_hole meshes
    keep exactly the 9 grid offsets, and exactness is preserved."""
    from tpufem.ops.stencil import StencilOperator

    mesh = tpufem.generate_annulus_mesh(n_side=60, n_circle=64, pad_hole=True)
    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh))
    st = StencilOperator.build(K, dtype=jnp.float64)
    untrimmed = StencilOperator.build(K, dtype=jnp.float64, min_fill=0.0)
    assert len(st.offsets) == 9, st.offsets
    assert len(untrimmed.offsets) == 16
    assert max(abs(o) for o in st.offsets) <= 61  # grid reach only
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal(mesh.n_nodes))
    np.testing.assert_allclose(
        np.asarray(st.matvec(x)), np.asarray(K.matvec(x)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(st.diag()), np.asarray(K.diag()), atol=1e-12
    )


def test_stencil_stokes_run_matches_csr_on_pad_hole_mesh():
    """Full CG Stokes steps with cg_storage='stencil' on a pad_hole mesh
    (inert dummy nodes) match the CSR-storage run."""
    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48, pad_hole=True)
    base = dict(solver="cg", dt=0.01, nu=1.0, transport="none",
                cg_iters_visc=40, cg_iters_pressure=120,
                cg_precond="twolevel")
    pc = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(cg_storage="csr", **base)
    )
    ps = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(cg_storage="stencil", **base)
    )
    sc, _ = stokes.run(pc, steps=5)
    ss, ms = stokes.run(ps, steps=5)
    uc, us = np.asarray(sc["u"]), np.asarray(ss["u"])
    assert np.isfinite(us).all()
    np.testing.assert_allclose(us, uc, atol=1e-9)
    # dummy nodes stay inert
    dummies = np.asarray(mesh.markers == -1)
    assert np.abs(us[dummies]).max() == 0.0


def test_twolevel_preconditioner_matches_jacobi_with_fewer_iters(mesh1):
    """Two-level (aggregation coarse grid + damped Jacobi) PCG reaches the
    Jacobi-PCG pressure solution in a fraction of the iterations — the
    mesh-independent large-mesh path."""
    from tpufem.ops import calculus
    from tpufem.solve.cg import cg
    from tpufem.solve.twolevel import twolevel_preconditioner

    jac = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(solver="cg", cg_iters_pressure=600)
    ).pressure_solver
    two = stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            solver="cg", cg_iters_pressure=60, cg_precond="twolevel",
            cg_coarse_nodes=64,
        ),
    ).pressure_solver
    assert two.twolevel is not None and two.twolevel.n_coarse <= 96

    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    b = -calculus.divergence(mesh1, u) / 0.05
    act = np.asarray(jac.active_mask) > 0
    p1 = np.asarray(jac.solve(b))
    p2 = np.asarray(two.solve(b))
    np.testing.assert_allclose(
        p2[act] - p2[act].mean(), p1[act] - p1[act].mean(), atol=1e-6
    )

    # iteration counts to a fixed tolerance: two-level must cut them ≥3×
    diag = jac.K_merged.diag()
    inv_diag = jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0), 1.0)
    rhs = (jac.m_lumped * b) * jac.active_mask
    _, (it_j, _) = cg(
        jac.matvec, rhs, tol=1e-8, maxiter=3000,
        precond=lambda r: inv_diag * r,
        deflate=True, deflate_weights=jac.active_mask,
    )
    M = twolevel_preconditioner(
        two.matvec, inv_diag, two.twolevel, active_mask=two.active_mask
    )
    _, (it_2, _) = cg(
        two.matvec, rhs, tol=1e-8, maxiter=3000, precond=M,
        deflate=True, deflate_weights=two.active_mask,
    )
    assert int(it_2) * 3 <= int(it_j), (int(it_2), int(it_j))


def test_twolevel_stokes_run_tracks_jacobi():
    """Full Stokes steps with cg_precond='twolevel' track the Jacobi-PCG
    run on a generated mesh (fewer pressure iterations, same flow)."""
    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48)
    base = dict(solver="cg", dt=0.01, nu=1.0, transport="none",
                cg_iters_visc=40)
    pj = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(cg_iters_pressure=400, **base)
    )
    p2 = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(cg_iters_pressure=40,
                                  cg_precond="twolevel", **base)
    )
    sj, _ = stokes.run(pj, steps=5)
    s2, _ = stokes.run(p2, steps=5)
    uj, u2 = np.asarray(sj["u"]), np.asarray(s2["u"])
    assert np.isfinite(u2).all()
    err = np.linalg.norm(u2 - uj) / np.linalg.norm(uj)
    assert err < 1e-5, err


def test_cg_large_generated_mesh():
    """The scaling regime the reference cannot reach: ~6k-node annulus,
    matrix-free f32, no dense matrices materialized."""
    mesh = tpufem.generate_annulus_mesh(n_side=80, n_circle=96)
    assert mesh.n_nodes > 4500
    cfg = stokes.StokesConfig(
        solver="cg", precision="f32", dt=0.01, nu=1.0,
        cg_iters_visc=40, cg_iters_pressure=150, transport="none",
    )
    problem = stokes.StokesProblem.build(mesh, cfg)
    state, metrics = stokes.run(problem, steps=5)
    u = np.asarray(state["u"])
    assert u.dtype == np.float32
    assert np.isfinite(u).all()
    # squirmer drives flow; projection keeps it bounded
    assert 0 < np.abs(u).max() < 50.0
    assert float(metrics["final_div_max"][-1]) < float(metrics["div_star_max"][-1]) * 5


def test_tol_viscous_cg_warm_start_matches_fixed():
    """Warm-started early-exit viscous CG (cg_tol_visc > 0) tracks the
    fixed-iteration run — the steady-state fast path where the batched
    (u_x, u_y) solve exits after a handful of iterations instead of the
    full cap."""
    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48, pad_hole=True)
    base = dict(dt=0.01, nu=1.0, transport="none", solver="cg",
                cg_storage="csr", precision="f32", cg_iters_visc=30,
                cg_iters_pressure=60, cg_precond="twolevel",
                cg_warm_start=True, cg_tol_pressure=1e-5)
    pf = stokes.StokesProblem.build(mesh, stokes.StokesConfig(**base))
    pt = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(**base, cg_tol_visc=1e-6)
    )
    sf, mf = stokes.run(pf, steps=20)
    st, mt = stokes.run(pt, steps=20)
    uf, ut = np.asarray(sf["u"]), np.asarray(st["u"])
    assert "ustar_warm" in st
    assert np.isfinite(ut).all()
    err = np.abs(uf - ut).max() / np.abs(uf).max()
    assert err < 1e-4, err
    np.testing.assert_allclose(
        np.asarray(mt["final_div_max"])[-1],
        np.asarray(mf["final_div_max"])[-1],
        rtol=1e-3,
    )


def test_twolevel_bf16_coarse_matches_f32(mesh1):
    """cg_coarse_dtype='bf16' (half the coarse-matvec HBM bytes) reaches
    the same pressure solution — elementwise rounding keeps the coarse
    inverse symmetric and the perturbation is far below the smoother's
    approximation level (measured: identical iteration counts at 26k)."""
    from tpufem.ops import calculus

    base = dict(solver="cg", cg_iters_pressure=60, cg_precond="twolevel",
                cg_coarse_nodes=64)
    f32 = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(**base)
    ).pressure_solver
    b16 = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(**base, cg_coarse_dtype="bf16")
    ).pressure_solver
    assert b16.twolevel.ac_inv.dtype == jnp.bfloat16

    rng = np.random.default_rng(6)
    u = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    b = -stokes.calculus.divergence(mesh1, u) / 0.05
    act = np.asarray(f32.active_mask) > 0
    p1 = np.asarray(f32.solve(b))
    p2 = np.asarray(b16.solve(b))
    np.testing.assert_allclose(
        p2[act] - p2[act].mean(), p1[act] - p1[act].mean(), atol=1e-6
    )


def test_stencil_refill_matches_dense_convection():
    """StencilRefill: per-step C(u) scattered into stencil planes equals
    the dense-assembled convection operator product."""
    from tpufem.ops import assembly
    from tpufem.ops.stencil import StencilRefill

    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48, pad_hole=True)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((mesh.n_nodes, 2)))
    elem = assembly.element_convection(mesh, u, variant="opsplit")
    C = assembly.assemble_dense(mesh, elem)
    rf = StencilRefill.build(mesh, dtype=jnp.float64)
    assert rf.template.coverage >= 0.99
    Cop = rf.refill(elem)
    x = jnp.asarray(rng.standard_normal(mesh.n_nodes))
    np.testing.assert_allclose(
        np.asarray(Cop.matvec(x)), np.asarray(C @ x), atol=1e-12
    )
    # refilled under jit too (the per-step path runs inside lax.scan)
    y = jax.jit(lambda e, v: rf.refill(e).matvec(v))(elem, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(C @ x), atol=1e-12)
