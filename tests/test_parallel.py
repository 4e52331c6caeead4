"""Multi-chip SPMD tests on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpufem.parallel import ShardedEnsemble, build_device_mesh, make_sharded_step
from tpufem.workloads import stokes
from tpufem import transport


@pytest.fixture(scope="module")
def dmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return build_device_mesh(8, data=2)  # 2 data × 4 space


def test_device_mesh_shape(dmesh):
    assert dict(dmesh.shape) == {"data": 2, "space": 4}


def test_sharded_step_matches_single_device(mesh1, dmesh):
    """One sharded ensemble step ≡ per-simulation single-device steps."""
    b1s = np.array([-2.0, -2.0, -2.0, -2.0])
    b2s = np.array([0.0, 5.0, -5.0, 2.0])
    ens = ShardedEnsemble.build(mesh1, dmesh, b1s, b2s)
    step = make_sharded_step(ens)
    state = ens.initial_state()
    new_state, final_div = step(state)
    new_state2, final_div2 = step(new_state)  # two steps

    for i, (b1, b2) in enumerate(zip(b1s, b2s)):
        cfg = stokes.StokesConfig(B1=b1, B2=b2, transport="dye", solver="inverse")
        prob = stokes.StokesProblem.build(mesh1, cfg)
        st = stokes.initial_state(prob)
        var0 = stokes.dye_baseline(prob, st)
        step_fn = stokes.make_step(prob, var0=var0)
        st, m = step_fn(st, None)
        st, m = step_fn(st, None)
        # tolerance: the ±1e10 penalty in the pressure operator amplifies
        # f64 reduction-order differences (row-block vs full matvec) to
        # ~1e-7 in u; structural mismatches would be O(1)
        np.testing.assert_allclose(
            np.asarray(new_state2["u"][i]), np.asarray(st["u"]), atol=2e-6,
            err_msg=f"sim {i} (B2={b2}) velocity mismatch",
        )
        np.testing.assert_allclose(
            np.asarray(new_state2["c"][i]), np.asarray(st["c"]), atol=2e-6
        )
    assert final_div2.shape == (4,)
    assert np.isfinite(np.asarray(final_div2)).all()


def test_multimesh_ensemble_matches_per_mesh_single_device(dmesh):
    """Per-simulation MESHES (jittered geometry realizations): the sharded
    ensemble step ≡ per-mesh single-device steps.  pad_hole generation
    keeps node counts and boundary index sets identical across seeds, so
    only the interior geometry varies."""
    import tpufem
    from tpufem.parallel import MultiMeshEnsemble, make_multimesh_step

    meshes = [
        tpufem.generate_annulus_mesh(
            n_side=14, n_circle=16, pad_hole=True, jitter=0.15, seed=s
        )
        for s in range(4)
    ]
    assert len({m.n_nodes for m in meshes}) == 1
    assert any(
        not np.array_equal(meshes[0].coords, m.coords) for m in meshes[1:]
    )
    b1s = np.full(4, -2.0)
    b2s = np.array([0.0, 5.0, -5.0, 2.0])
    cfg = stokes.StokesConfig(
        solver="inverse", pressure_mode="merge", transport="none"
    )
    ens = MultiMeshEnsemble.build(meshes, dmesh, b1s, b2s, config=cfg)
    step = make_multimesh_step(ens)
    state = ens.initial_state()
    state, fd = step(state)
    state, fd = step(state)

    for i, (m, b1, b2) in enumerate(zip(meshes, b1s, b2s)):
        prob = stokes.StokesProblem.build(
            m, stokes.StokesConfig(B1=b1, B2=b2, solver="inverse",
                                   pressure_mode="merge", transport="none")
        )
        st = stokes.initial_state(prob)
        step_fn = stokes.make_step(prob)
        st, mm = step_fn(st, None)
        st, mm = step_fn(st, None)
        np.testing.assert_allclose(
            np.asarray(state["u"][i]), np.asarray(st["u"]), atol=1e-8,
            err_msg=f"sim {i} (seed {i}) velocity mismatch",
        )
        np.testing.assert_allclose(
            float(fd[i]), float(mm["final_div_max"]), atol=1e-8
        )
    assert np.isfinite(np.asarray(fd)).all()


@pytest.mark.parametrize("tr", ["dye", "tracers"])
def test_multimesh_transport_matches_per_mesh_single_device(dmesh, tr):
    """Per-sim-mesh ensembles WITH transport: stacked locator tables
    padded to a fleet-wide candidate width reproduce the per-mesh single-device dye/tracer
    updates exactly."""
    import tpufem
    from tpufem.parallel import MultiMeshEnsemble, make_multimesh_step

    meshes = [
        tpufem.generate_annulus_mesh(
            n_side=14, n_circle=16, pad_hole=True, jitter=0.15, seed=s
        )
        for s in range(4)
    ]
    b1s = np.full(4, -2.0)
    b2s = np.array([0.0, 5.0, -5.0, 2.0])
    cfg = stokes.StokesConfig(
        solver="inverse", pressure_mode="merge", transport=tr
    )
    ens = MultiMeshEnsemble.build(meshes, dmesh, b1s, b2s, config=cfg)
    # padding to the fleet C_max must actually engage for the test to
    # mean anything — jittered triangulations have unequal widths
    assert ens.locator.rows.shape[0] == 4
    step = make_multimesh_step(ens)
    state = ens.initial_state()
    state, metric = step(state)
    state, metric = step(state)

    for i, (m, b1, b2) in enumerate(zip(meshes, b1s, b2s)):
        prob = stokes.StokesProblem.build(
            m, stokes.StokesConfig(B1=b1, B2=b2, solver="inverse",
                                   pressure_mode="merge", transport=tr)
        )
        st = stokes.initial_state(prob)
        if tr == "dye":
            step_fn = stokes.make_step(prob, var0=stokes.dye_baseline(prob, st))
        else:
            step_fn = stokes.make_step(prob)
        st, _ = step_fn(st, None)
        st, mm = step_fn(st, None)
        np.testing.assert_allclose(
            np.asarray(state["u"][i]), np.asarray(st["u"]), atol=1e-8,
            err_msg=f"sim {i} velocity mismatch",
        )
        if tr == "dye":
            np.testing.assert_allclose(
                np.asarray(state["c"][i]), np.asarray(st["c"]), atol=1e-8,
                err_msg=f"sim {i} dye mismatch",
            )
        else:
            np.testing.assert_allclose(
                np.asarray(state["tracers"][i]), np.asarray(st["tracers"]),
                atol=1e-8, err_msg=f"sim {i} tracer mismatch",
            )
            np.testing.assert_array_equal(
                np.asarray(state["tracer_status"][i]),
                np.asarray(st["tracer_status"]),
            )
    assert np.isfinite(np.asarray(metric)).all()


def test_grid_locator_with_cmax_padding_is_inert(mesh1):
    """with_cmax-padded locators return identical results (padding slots
    are -1: excluded from the containment test)."""
    loc = transport.GridLocator.build(mesh1, g=12)
    padded = loc.with_cmax(loc.cells.shape[1] + 3)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(0.02, 0.98, size=(200, 2)))
    t0, f0, w0 = loc.find(pts, return_weights=True)
    t1, f1, w1 = padded.find(pts, return_weights=True)
    np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
    np.testing.assert_array_equal(np.asarray(f0), np.asarray(f1))
    np.testing.assert_allclose(np.asarray(w0), np.asarray(w1), rtol=0, atol=0)


def test_sharded_report_ensemble_matches_single(mesh1, dmesh):
    """Sharded 'report'-variant rotating-cylinder ensemble
    ≡ per-omega single-device report steps: RHS-overwrite BCs, pinned +
    de-meaned + smoothed pressure, single projection, BC ramp."""
    omegas = np.array([2.0, 5.0, -3.0, 8.0])
    base = dict(
        variant="report", bc_kind="rotating", solver="inverse",
        pressure_mode="penalty", ramp_steps=10, pressure_smoothing=0.01,
        transport="dye", dt=1e-3, nu=0.1,
    )
    ens = ShardedEnsemble.build(
        mesh1, dmesh, config=stokes.StokesConfig(**base), omegas=omegas
    )
    assert ens.smooth_inv is not None
    step = make_sharded_step(ens)
    state = ens.initial_state()
    state, final_div = step(state)
    state, final_div = step(state)

    for i, om in enumerate(omegas):
        cfg = stokes.StokesConfig(omega=om, **base)
        prob = stokes.StokesProblem.build(mesh1, cfg)
        st = stokes.initial_state(prob)
        step_fn = stokes.make_step(prob, var0=stokes.dye_baseline(prob, st))
        st, m = step_fn(st, None)
        st, m = step_fn(st, None)
        np.testing.assert_allclose(
            np.asarray(state["u"][i]), np.asarray(st["u"]), atol=2e-6,
            err_msg=f"sim {i} (omega={om}) velocity mismatch",
        )
        np.testing.assert_allclose(
            np.asarray(state["c"][i]), np.asarray(st["c"]), atol=2e-6
        )
        np.testing.assert_allclose(
            float(final_div[i]), float(m["final_div_max"]), atol=2e-5,
            err_msg=f"sim {i} final-div mismatch",
        )
    assert int(np.asarray(state["step"])[0]) == 2


def test_sharded_tracer_ensemble_matches_single(mesh1, dmesh):
    """Sharded food-capture ensemble ≡ per-gait single-device runs."""
    b1s = np.full(4, -2.0)
    b2s = np.array([0.0, -5.0, 5.0, 2.0])
    cfg = stokes.StokesConfig(
        dt=0.01, nu=1.0, transport="tracers", tracer_density=12,
        solver="inverse", pressure_mode="merge",
    )
    ens = ShardedEnsemble.build(mesh1, dmesh, b1s, b2s, config=cfg)
    step = make_sharded_step(ens)
    state = ens.initial_state()
    for _ in range(3):
        state, eaten = step(state)

    for i, b2 in enumerate(b2s):
        c1 = stokes.StokesConfig(
            dt=0.01, nu=1.0, B1=-2.0, B2=b2, transport="tracers",
            tracer_density=12, solver="inverse", pressure_mode="merge",
        )
        prob = stokes.StokesProblem.build(mesh1, c1)
        st = stokes.initial_state(prob)
        step_fn = stokes.make_step(prob)
        for _ in range(3):
            st, m = step_fn(st, None)
        np.testing.assert_allclose(
            np.asarray(state["tracers"][i]), np.asarray(st["tracers"]), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(state["tracer_status"][i]), np.asarray(st["tracer_status"])
        )


def test_distributed_cg_matches_single_device(mesh1):
    """8-way space-sharded CG (all_gather SpMV + psum dots) reproduces the
    single-device matrix-free viscous solve."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from jax.sharding import Mesh as DeviceMesh

    from tpufem.ops import assembly
    from tpufem.parallel.dist_cg import make_sharded_viscous_solver
    from tpufem.solve.matfree import ViscousCG

    dmesh1d = DeviceMesh(np.asarray(jax.devices()[:8]), ("space",))
    K = assembly.assemble_csr(mesh1, assembly.element_stiffness(mesh1))
    from tpufem import bc as bc_mod

    boundary = bc_mod.ChannelBoundary.build(mesh1)
    mask = np.ones(mesh1.n_nodes)
    mask[boundary.dirichlet] = 0.0

    single = ViscousCG(
        K=K, interior_mask=jnp.asarray(mask), dt_nu=0.005, iters=80
    )
    dist = make_sharded_viscous_solver(dmesh1d, K, mask, 0.005, iters=80)

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((mesh1.n_nodes, 2)))
    x_single = np.asarray(single.solve(b))
    x_dist = np.asarray(dist(b))
    np.testing.assert_allclose(x_dist, x_single, atol=1e-9)


def test_halo_exchange_cg_matches_single_device():
    """ppermute halo-exchange CG over RCM-banded blocks ≡ single-device
    banded solve (O(bandwidth) communication instead of all_gather)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import tpufem
    from jax.sharding import Mesh as DeviceMesh

    from tpufem import bc as bc_mod
    from tpufem.ops import assembly
    from tpufem.ops.banded import BandedOperator
    from tpufem.parallel.halo import make_halo_viscous_solver
    from tpufem.solve.matfree import ViscousCG

    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48)  # ~1.5k nodes
    dmesh1d = DeviceMesh(np.asarray(jax.devices()[:8]), ("space",))
    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh))
    band = BandedOperator.build(K, dtype=jnp.float64)
    boundary = bc_mod.ChannelBoundary.build(mesh)
    mask = np.ones(mesh.n_nodes)
    mask[boundary.dirichlet] = 0.0

    single = ViscousCG(K=band, interior_mask=jnp.asarray(mask), dt_nu=0.005, iters=80)
    dist = make_halo_viscous_solver(dmesh1d, band, mask, 0.005, iters=80)

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((mesh.n_nodes, 2)))
    np.testing.assert_allclose(
        np.asarray(dist(b)), np.asarray(single.solve(b)), atol=1e-9
    )


def test_halo_pressure_solver_matches_single_device():
    """Halo-exchange merged-pressure CG ≡ single-device PressureCG."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import tpufem
    from jax.sharding import Mesh as DeviceMesh

    from tpufem.parallel.halo import make_halo_pressure_solver
    from tpufem.workloads import stokes as stk

    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48)
    problem = stk.StokesProblem.build(
        mesh,
        stk.StokesConfig(solver="cg", cg_storage="banded", cg_iters_pressure=300),
    )
    ps = problem.pressure_solver
    dmesh1d = DeviceMesh(np.asarray(jax.devices()[:8]), ("space",))
    dist = make_halo_pressure_solver(
        dmesh1d, ps.K_merged, ps.m_lumped, ps.masters, ps.slaves,
        np.asarray(ps.active_mask), iters=300,
    )
    rng = np.random.default_rng(0)
    from tpufem.ops import calculus

    u = jnp.asarray(rng.standard_normal((mesh.n_nodes, 2)))
    b = -calculus.divergence(mesh, u) / 0.01
    p_single = np.asarray(ps.solve(b))
    p_dist = np.asarray(dist(b))
    act = np.asarray(ps.active_mask) > 0
    # compare modulo the constant gauge on active dofs
    d1 = p_single[act] - p_single[act].mean()
    d2 = p_dist[act] - p_dist[act].mean()
    np.testing.assert_allclose(d2, d1, atol=1e-7)


def test_stencil_halo_cg_matches_single_device():
    """Distributed stencil-offset SpMV (ppermute strips of width
    max|offset| + one tiny remainder all_gather) ≡ single-device stencil
    viscous solve — the O(nnz) multi-device SpMV."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import tpufem
    from jax.sharding import Mesh as DeviceMesh

    from tpufem import bc as bc_mod
    from tpufem.ops import assembly
    from tpufem.ops.stencil import StencilOperator
    from tpufem.parallel.halo_stencil import make_stencil_halo_viscous_solver
    from tpufem.solve.matfree import ViscousCG

    mesh = tpufem.generate_annulus_mesh(
        n_side=40, n_circle=48, pad_hole=True
    )
    dmesh1d = DeviceMesh(np.asarray(jax.devices()[:8]), ("space",))
    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh))
    st = StencilOperator.build(K, dtype=jnp.float64)
    assert st.coverage > 0.9  # pad_hole grid numbering → stencil regime
    assert len(st.rest_rows) > 0  # remainder machinery actually engaged
    boundary = bc_mod.ChannelBoundary.build(mesh)
    mask = np.ones(mesh.n_nodes)
    mask[boundary.dirichlet] = 0.0

    single = ViscousCG(K=st, interior_mask=jnp.asarray(mask), dt_nu=0.005,
                       iters=80)
    dist = make_stencil_halo_viscous_solver(dmesh1d, st, mask, 0.005, iters=80)

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((mesh.n_nodes, 2)))
    np.testing.assert_allclose(
        np.asarray(dist(b)), np.asarray(single.solve(b)), atol=1e-9
    )


def test_stencil_halo_pressure_solver_matches_single_device():
    """Distributed stencil merged-pressure CG ≡ single-device PressureCG
    (the DOF-merged periodic couplings land in the cross-block remainder
    — exercises the compacted remainder exchange)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import tpufem
    from jax.sharding import Mesh as DeviceMesh

    from tpufem.parallel.halo_stencil import make_stencil_halo_pressure_solver
    from tpufem.workloads import stokes as stk

    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48, pad_hole=True)
    problem = stk.StokesProblem.build(
        mesh,
        stk.StokesConfig(solver="cg", cg_storage="stencil",
                         cg_iters_pressure=300),
    )
    ps = problem.pressure_solver
    dmesh1d = DeviceMesh(np.asarray(jax.devices()[:8]), ("space",))
    dist = make_stencil_halo_pressure_solver(
        dmesh1d, ps.K_merged, ps.m_lumped, ps.masters, ps.slaves,
        np.asarray(ps.active_mask), iters=300,
    )
    rng = np.random.default_rng(0)
    from tpufem.ops import calculus

    u = jnp.asarray(rng.standard_normal((mesh.n_nodes, 2)))
    b = -calculus.divergence(mesh, u) / 0.01
    p_single = np.asarray(ps.solve(b))
    p_dist = np.asarray(dist(b))
    act = np.asarray(ps.active_mask) > 0
    d1 = p_single[act] - p_single[act].mean()
    d2 = p_dist[act] - p_dist[act].mean()
    np.testing.assert_allclose(d2, d1, atol=1e-7)


def test_sharded_matfree_stokes_step_stencil_matches_single():
    """Full space-sharded matrix-free step over STENCIL storage ≡
    single-device stencil-CG path."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import tpufem
    from jax.sharding import Mesh as DeviceMesh

    from tpufem.parallel.stokes_sharded import make_sharded_matfree_step

    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48, pad_hole=True)
    cfg = stokes.StokesConfig(
        solver="cg", cg_storage="stencil", cg_iters_visc=80,
        cg_iters_pressure=300, cg_warm_start=False, transport="none",
    )
    problem = stokes.StokesProblem.build(mesh, cfg)
    dmesh1d = DeviceMesh(np.asarray(jax.devices()[:8]), ("space",))
    sh_step = make_sharded_matfree_step(dmesh1d, problem)

    state = stokes.initial_state(problem)
    step_fn = stokes.make_step(problem)
    u_sh = state["u"]
    st = state
    for _ in range(3):
        u_sh, m_sh = sh_step(u_sh)
        st, m_single = step_fn(st, None)
    np.testing.assert_allclose(np.asarray(u_sh), np.asarray(st["u"]), atol=1e-7)
    np.testing.assert_allclose(
        float(m_sh["final_div_max"]), float(m_single["final_div_max"]),
        rtol=1e-5,
    )


def test_sharded_matfree_stokes_step_matches_single(mesh1):
    """Full space-sharded matrix-free Stokes step (halo CG solves +
    element-sharded div/grad) ≡ single-device CG path."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import tpufem
    from jax.sharding import Mesh as DeviceMesh

    from tpufem.parallel.stokes_sharded import make_sharded_matfree_step

    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48)
    cfg = stokes.StokesConfig(
        solver="cg", cg_storage="banded", cg_iters_visc=80,
        cg_iters_pressure=300, cg_warm_start=False, transport="none",
    )
    problem = stokes.StokesProblem.build(mesh, cfg)
    dmesh1d = DeviceMesh(np.asarray(jax.devices()[:8]), ("space",))
    sh_step = make_sharded_matfree_step(dmesh1d, problem)

    state = stokes.initial_state(problem)
    step_fn = stokes.make_step(problem)
    u_sh = state["u"]
    st = state
    for _ in range(3):
        u_sh, m_sh = sh_step(u_sh)
        st, m_single = step_fn(st, None)
    np.testing.assert_allclose(
        np.asarray(u_sh), np.asarray(st["u"]), atol=1e-7
    )
    np.testing.assert_allclose(
        float(m_sh["final_div_max"]), float(m_single["final_div_max"]), rtol=1e-5
    )


def test_sharded_state_is_actually_sharded(mesh1, dmesh):
    ens = ShardedEnsemble.build(
        mesh1, dmesh, np.full(4, -2.0), np.array([0.0, 1.0, 2.0, 3.0])
    )
    step = make_sharded_step(ens)
    state, _ = step(ens.initial_state())
    shardings = {k: v.sharding for k, v in state.items()}
    # batch axis sharded over "data"
    assert any("data" in str(s.spec) for s in shardings.values())
