"""Sparse (Uzawa-CG) transient Taylor–Hood vs the dense reference path."""

import numpy as np
import pytest

import tpufem
from tpufem.mesh.p2 import p2_refine
from tpufem.workloads import navier_stokes as ns
from tpufem.workloads import th_sparse

from tests.conftest import reference_mesh


@pytest.fixture(scope="module")
def mesh22():
    return reference_mesh("mesh2.2")


def test_sparse_th_matches_dense_th(mesh22):
    """20 θ-steps on the reference's own P2 mesh: the Uzawa-CG stepper
    reproduces the dense-factored TransientTHProblem trajectory."""
    dense = ns.TransientTHProblem.build(
        mesh22, ns.TransientTHConfig(dt=0.01, nu=1.0)
    )
    uf, _, _ = ns.run_transient_th(dense, steps=20)
    sp = th_sparse.SparseTHProblem.build(
        mesh22,
        th_sparse.SparseTHConfig(
            dt=0.01, nu=1.0, iters_inner=60, iters_outer=40, iters_plap=20
        ),
    )
    us, _, ms = th_sparse.run(sp, steps=20)
    np.testing.assert_allclose(
        np.asarray(uf), np.asarray(us), atol=1e-6
    )
    # weak divergence solved to near solver tolerance
    assert float(np.asarray(ms["div_weak_max"])[-1]) < 1e-6


def test_sparse_th_on_generated_p2_and_weak_divergence():
    """Generated annulus → p2_refine → sparse TH: the weak divergence in
    the native P1 test space is far below the P1/P1 projection's
    (the LBB-stable accuracy claim, measured ~5× at this size)."""
    from tpufem.ops import calculus
    from tpufem.workloads import stokes

    mesh = tpufem.generate_annulus_mesh(n_side=28, n_circle=32)
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    sp = th_sparse.SparseTHProblem.build(
        m2, th_sparse.SparseTHConfig(dt=0.01, nu=1.0)
    )
    us, _, ms = th_sparse.run(sp, steps=50)
    assert float(np.asarray(ms["max_u"])[-1]) == pytest.approx(2.0, rel=1e-3)
    th_weak = float(np.abs(np.asarray(sp.b_apply(us))).max())

    p1 = stokes.StokesProblem.build(
        mesh,
        stokes.StokesConfig(
            dt=0.01, nu=1.0, solver="lu", precision="f64",
            transport="none", all_walls=True,
        ),
    )
    s1, _ = stokes.run(p1, steps=50)
    p1_weak = float(
        np.abs(np.asarray(calculus.consistent_divergence_rhs(mesh, s1["u"]))).max()
    )
    assert th_weak < 0.5 * p1_weak, (th_weak, p1_weak)


def test_sparse_th_warm_start_consistency(mesh22):
    """More outer iterations change nothing once converged (fixed-point
    sanity for the inexact-Uzawa inner/outer nesting)."""
    a = th_sparse.SparseTHProblem.build(
        mesh22,
        th_sparse.SparseTHConfig(dt=0.01, iters_inner=60, iters_outer=30),
    )
    b = th_sparse.SparseTHProblem.build(
        mesh22,
        th_sparse.SparseTHConfig(dt=0.01, iters_inner=80, iters_outer=50),
    )
    ua, _, _ = th_sparse.run(a, steps=5)
    ub, _, _ = th_sparse.run(b, steps=5)
    np.testing.assert_allclose(np.asarray(ua), np.asarray(ub), atol=1e-6)


def test_th_sparse_scale_bench_row():
    """bench_large.run_th_sparse (the TH scale row)
    returns a physics-gated row: weak divergence ≪ the same-mesh P1/P1
    projection's, finite velocity, timed."""
    from tpufem import bench_large

    row = bench_large.run_th_sparse(20, 24, steps=10)
    assert row["steps_per_sec"] > 0
    assert row["div_ratio_weak"] > 10.0
    assert row["max_u"] == pytest.approx(2.0, rel=1e-2)


def test_th_inner_twolevel_matches_jacobi():
    """precond_inner='twolevel' (aggregation coarse grid on M₂/Δt+θνK₂)
    converges the inner velocity solve to the same solution as Jacobi —
    fewer iterations per digit at scale (measured at n_side=96: 3e-6
    residual in 80 iterations vs Jacobi's 1e-3 in 160)."""
    import dataclasses as dc

    import jax.numpy as jnp

    mesh = tpufem.generate_annulus_mesh(n_side=28, n_circle=32)
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    pt = th_sparse.SparseTHProblem.build(
        m2,
        th_sparse.SparseTHConfig(
            dt=0.01, precond_inner="twolevel", iters_inner=80
        ),
    )
    assert pt.tl_vel is not None
    pj = dc.replace(
        pt, tl_vel=None,
        config=dc.replace(pt.config, iters_inner=300),
    )
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.standard_normal((pt.n2, 2))) * pt.vel_mask[:, None]
    np.testing.assert_allclose(
        np.asarray(pt.solve_vel(b)), np.asarray(pj.solve_vel(b)), atol=1e-8
    )


def test_steady_uzawa_matches_dense_taylor_hood():
    """steady_solve (matrix-free Uzawa on the STEADY Stokes saddle, the
    νM_p⁻¹ steady Cahouet–Chabard preconditioner) reproduces the dense
    solve_taylor_hood solution — the solver that extends the TH
    convergence cross-check beyond the dense (2N₂+N₁)² ceiling."""
    mesh = tpufem.generate_annulus_mesh(n_side=24, n_circle=32)
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    ud, pd, res = ns.solve_taylor_hood(
        m2, ns.TaylorHoodConfig(nu=1.0, B1=-2.0, B2=0.0)
    )
    assert float(res) < 1e-10
    prob = th_sparse.SparseTHProblem.build(m2, th_sparse.SparseTHConfig(nu=1.0))
    us, ps = th_sparse.steady_solve(prob)
    np.testing.assert_allclose(np.asarray(us), np.asarray(ud), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(ps) - np.asarray(ps).mean(),
        np.asarray(pd) - np.asarray(pd).mean(), atol=1e-7,
    )
