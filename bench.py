"""Headline benchmark: 1000-step Stokes + 10k-tracer run, dense regime.

The food-capture configuration (``code/StokesFood.py``: dt=0.01, ν=1.0,
squirmer B1=−2) with ~10k passive tracers advected and capture statistics
updated every step, on the reference's ``mesh_fine.1`` (1067 nodes) when
the reference assets are present, else on the generated mesh of the same
scale (``generate_annulus_mesh(n_side=33, n_circle=48)``).  The metric
names the mesh it ran on.

``vs_baseline`` = (our steps/sec) / (reference steps/sec), where the
reference number is measured live from ``baselines/numpy_ref.py`` — a
faithful re-implementation of the reference's per-step cost profile
(4 un-cached dense ``np.linalg.solve`` calls + 5 Python element loops per
step; the baseline is timed WITHOUT tracer advection, which biases the
ratio in the baseline's favor).

Runs on a GPU only: any other device is refused.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.
"""

from __future__ import annotations

import json
import time

import numpy as np


BENCH_STEPS = 1000
BASELINE_STEPS = 20  # ≥20 steps → low-variance denominator
TRACER_DENSITY = 115  # 115×115 grid minus cylinder ≈ 10k tracers


def _bench_mesh():
    """(mesh, name): mesh_fine.1 if the reference assets exist, else the
    generated mesh of the same scale."""
    import tpufem
    from tpufem import config as cfg

    stem = cfg.reference_mesh_path("mesh_fine.1")
    if stem is not None:
        return tpufem.load_mesh(stem), "mesh_fine.1"
    return (tpufem.generate_annulus_mesh(n_side=33, n_circle=48),
            "generated n_side=33")


def headline_config():
    """The f32 fast path: host-f64-factored operators applied as f32
    matvecs with the exact (merged) periodic pressure operator, the whole
    step composed into one (2N, 2N) matrix."""
    from tpufem.workloads import stokes

    return stokes.StokesConfig(
        dt=0.01,
        nu=1.0,
        transport="tracers",
        tracer_density=TRACER_DENSITY,
        solver="inverse",
        precision="f32",
        pressure_mode="merge",
        fused=True,
    )


def run_tpufem(mesh, steps=BENCH_STEPS):
    import jax

    jax.config.update("jax_enable_x64", True)
    from tpufem.bench_large import enable_compile_cache

    enable_compile_cache()
    from tpufem.workloads import stokes

    problem = stokes.StokesProblem.build(mesh, headline_config())
    n_tracers = problem.tracer_init.shape[0]

    # warm-up with the SAME step count (lax.scan length is baked into the
    # compiled program — a different length would recompile inside the
    # timer)
    jax.block_until_ready(stokes.run(problem, steps=steps))

    t0 = time.perf_counter()
    state, metrics = jax.block_until_ready(stokes.run(problem, steps=steps))
    elapsed = time.perf_counter() - t0
    assert np.isfinite(np.asarray(state["u"])).all(), "bench run diverged"
    return steps / elapsed, n_tracers, metrics


def run_baseline(mesh, steps=BASELINE_STEPS):
    from baselines import numpy_ref

    ref = numpy_ref.StokesRef(
        mesh.coords, mesh.tris, mesh.markers, dt=0.01, nu=1.0
    )
    u = ref.initial_state()
    # one untimed step to warm caches
    u, _ = ref.step(u)
    t0 = time.perf_counter()
    for _ in range(steps):
        u, _ = ref.step(u)
    elapsed = time.perf_counter() - t0
    return steps / elapsed


def require_gpu():
    """The device the bench measures; refuses anything but a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; found platform {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def main():
    dev = require_gpu()
    mesh, mesh_name = _bench_mesh()
    ours, n_tracers, metrics = run_tpufem(mesh)
    baseline = run_baseline(mesh)
    print(
        json.dumps(
            {
                "metric": (
                    f"Stokes+tracer steps/sec ({mesh_name}, {mesh.n_nodes} "
                    f"nodes, {BENCH_STEPS} steps, {n_tracers} tracers, "
                    "f32 fused path)"
                ),
                "value": ours,
                "unit": "steps/sec",
                "vs_baseline": ours / baseline,
                "device": {"platform": dev.platform, "kind": dev.device_kind},
            }
        )
    )


if __name__ == "__main__":
    main()
