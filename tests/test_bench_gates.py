"""Physics-gate regression tests.

The large-mesh bench gates must track the MEASURED divergence curves —
a silent loosening (e.g. back to a blow-up-only 1.0) would let
fast noise publish as physics.  These tests pin the gate values and
prove the gate actually fires on a corrupted field.
"""

import numpy as np
import pytest

from tpufem import generate_annulus_mesh
from tpufem import bench_large


def test_gate_values_pinned():
    # measured plateaus: Stokes/dye/tracers 0.0197–0.0272 (2k–2M),
    # imported mesh_fine 0.107, NS 0.15–0.197 — each gate must fail a
    # 2× regression of its path's worst committed row
    assert bench_large.DIV_REL_GATES["stokes"] <= 0.05
    assert bench_large.DIV_REL_GATES["imported"] <= 0.2
    assert bench_large.DIV_REL_GATES["ns"] <= 0.3
    assert bench_large.MAX_U_FACTOR <= 1.5


@pytest.fixture(scope="module")
def small_run():
    from tpufem.workloads import stokes

    mesh = generate_annulus_mesh(n_side=20, n_circle=24, pad_hole=True)
    config = stokes.StokesConfig(
        dt=0.01, nu=1.0, solver="cg", precision="f32",
        cg_iters_visc=20, cg_iters_pressure=40, cg_precond="jacobi",
    )
    problem = stokes.StokesProblem.build(mesh, config)
    state, metrics = stokes.run(problem, steps=5)
    return problem, state, metrics


def test_gate_passes_healthy_run(small_run):
    problem, state, metrics = small_run
    phys = bench_large.physics_report(problem, state, metrics, 5)
    assert phys["div_rel"] < bench_large.DIV_REL_GATES["stokes"]


def test_gate_fires_on_noise(small_run):
    import jax.numpy as jnp

    problem, state, metrics = small_run
    rng = np.random.default_rng(0)
    noisy = dict(state)
    noisy["u"] = state["u"] + jnp.asarray(
        0.3 * rng.standard_normal(np.asarray(state["u"]).shape),
        dtype=state["u"].dtype,
    )
    with pytest.raises(AssertionError, match="divergence|boundedness"):
        bench_large.physics_report(problem, noisy, metrics, 5)


def test_gate_fires_on_blowup(small_run):
    problem, state, metrics = small_run
    blown = dict(state)
    blown["u"] = state["u"] * 100.0
    with pytest.raises(AssertionError, match="boundedness|BC scale"):
        bench_large.physics_report(problem, blown, metrics, 5)


def test_poisson_heat_bench_runners_toy():
    """bench --large --poisson/--heat drivers end-to-end at toy size
    (bench-side regressions must be CI-catchable, not hardware-only).  Gates included: residual, Dirichlet values,
    heat boundedness."""
    rp = bench_large.run_poisson_large(40, 48, precision="f64")
    assert rp["res_rel"] < 1e-6 and rp["bc_err_max"] < 1e-6
    rh = bench_large.run_heat_large(40, 48, steps=10, precision="f64")
    assert rh["steps_per_sec"] > 0
    assert 0.99 <= rh["max_u_final"] <= 1.0 + 1e-9


def test_dye_bench_runner_toy_gates_mixing():
    """run_one(transport='dye') reports c_range/mixing_progress and the
    gates would fire on an unmixed field."""
    r = bench_large.run_one(40, 48, 5, transport="dye", storage="stencil")
    assert 0.0 <= r["c_range"][0] and r["c_range"][1] <= 1.0 + 1e-6
    assert r["mixing_progress"] > 0
