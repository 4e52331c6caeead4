"""Performance-path tests: dense-op matvecs, merged pressure, f32 mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpufem.ops import calculus
from tpufem.workloads import stokes


def test_divergence_matrices_match_segment_sum(mesh1):
    dx, dy = calculus.divergence_matrices(mesh1)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((mesh1.n_nodes, 2))
    d_mat = dx @ u[:, 0] + dy @ u[:, 1]
    d_seg = np.asarray(calculus.divergence(mesh1, jnp.asarray(u)))
    np.testing.assert_allclose(d_mat, d_seg, atol=1e-11)
    p = rng.standard_normal(mesh1.n_nodes)
    g_seg = np.asarray(calculus.gradient(mesh1, jnp.asarray(p)))
    np.testing.assert_allclose(dx @ p, g_seg[:, 0], atol=1e-11)
    np.testing.assert_allclose(dy @ p, g_seg[:, 1], atol=1e-11)


def test_merged_pressure_matches_penalty(mesh1):
    """f64 merge-mode run tracks the penalty-mode (reference) run.

    The two paths differ only in how they treat the *incompatible*
    (roundoff-scale) component of the pressure RHS: the reference's
    singular dense solve maps it onto LAPACK-determined near-nullspace
    junk whose gradient is ≈0; the pseudo-inverse projects it out.
    Trajectories agree to ~1e-4 and the physical observables match."""
    pen = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(pressure_mode="penalty", dense_ops=True)
    )
    mer = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(pressure_mode="merge", dense_ops=True)
    )
    s1, m1 = stokes.run(pen, steps=20)
    s2, m2 = stokes.run(mer, steps=20)
    u1, u2 = np.asarray(s1["u"]), np.asarray(s2["u"])
    err = np.linalg.norm(u1 - u2) / np.linalg.norm(u1)
    assert err < 5e-3, err
    np.testing.assert_allclose(
        float(m1["final_div_max"][-1]), float(m2["final_div_max"][-1]), rtol=1e-4
    )


def test_dense_ops_match_segment_path(mesh1):
    a = stokes.StokesProblem.build(mesh1, stokes.StokesConfig(dense_ops=True))
    b = stokes.StokesProblem.build(mesh1, stokes.StokesConfig(dense_ops=False))
    sa, _ = stokes.run(a, steps=10)
    sb, _ = stokes.run(b, steps=10)
    # 1e-7: the two summation orders agree to ~1e-12 on CPU; the bound
    # leaves room for an accelerator's reduction order
    np.testing.assert_allclose(
        np.asarray(sa["u"]), np.asarray(sb["u"]), atol=1e-7
    )


def test_f32_mode_tracks_f64(mesh1):
    """The f32 fast path must track the f64 parity path to single-precision
    accuracy over a 50-step dye run (BASELINE 'performance path validated
    against f64 golden values')."""
    gold = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(transport="dye", pressure_mode="merge")
    )
    fast_cfg = stokes.StokesConfig(
        transport="dye", precision="f32", pressure_mode="merge", solver="inverse"
    )
    fast = stokes.StokesProblem.build(mesh1, fast_cfg)
    sg, mg = stokes.run(gold, steps=50)
    sf, mf = stokes.run(fast, steps=50)
    assert sf["u"].dtype == jnp.float32
    err = np.linalg.norm(np.asarray(sf["u"]) - np.asarray(sg["u"])) / np.linalg.norm(
        np.asarray(sg["u"])
    )
    assert err < 5e-3, err
    # task metric (mixing progress) agrees to ~1%
    pg = float(mg["mixing_progress"][-1])
    pf = float(mf["mixing_progress"][-1])
    assert abs(pg - pf) < 0.01 * max(1.0, abs(pg))


def test_fused_step_matches_unfused(mesh1):
    """The composed whole-step matrix is exact linear algebra: f64 fused
    must match the staged merge-mode path to machine epsilon."""
    base = stokes.StokesProblem.build(mesh1, stokes.StokesConfig(pressure_mode="merge"))
    fused = stokes.StokesProblem.build(
        mesh1, stokes.StokesConfig(pressure_mode="merge", fused=True)
    )
    s1, m1 = stokes.run(base, steps=20)
    s2, m2 = stokes.run(fused, steps=20)
    u1, u2 = np.asarray(s1["u"]), np.asarray(s2["u"])
    assert np.linalg.norm(u1 - u2) / np.linalg.norm(u1) < 1e-12
    np.testing.assert_allclose(
        np.asarray(m1["div_star_max"]), np.asarray(m2["div_star_max"]), rtol=1e-10
    )


def test_fused_f32_food_capture_stats(mesh1):
    """Task-level oracle: the f32 fused food-capture run reproduces the
    f64 capture fraction within a few percent (trajectory-level f32
    divergence is expected in a mixing flow; the statistic is robust)."""
    mk = lambda **kw: stokes.StokesProblem.build(
        mesh1,
        stokes.StokesConfig(
            dt=0.01, nu=1.0, transport="tracers", tracer_density=15,
            pressure_mode="merge", solver="inverse", **kw,
        ),
    )
    gold = mk()
    fast = mk(precision="f32", fused=True)
    _, mg = stokes.run(gold, steps=100)
    _, mf = stokes.run(fast, steps=100)
    n_tr = gold.tracer_init.shape[0]
    frac_g = float(mg["eaten"][-1]) / n_tr
    frac_f = float(mf["eaten"][-1]) / n_tr
    assert abs(frac_g - frac_f) < 0.05, (frac_g, frac_f)


def test_f32_requires_merge(mesh1):
    with pytest.raises(AssertionError):
        stokes.StokesProblem.build(
            mesh1, stokes.StokesConfig(precision="f32", pressure_mode="penalty")
        )
