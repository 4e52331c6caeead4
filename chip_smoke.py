"""Smoke run of tpufem's main paths on a GPU, at real sizes.

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # the four-GPU paths and their references

Phases (one process for the card; each phase is a function that takes its
sizes, so the CPU tests run them at tiny sizes):

1. device — JAX's devices, and the card's name and power limit from
   ``nvidia-smi``;
2. headline dense regime — the StokesFood configuration (f32 fused step,
   ~10k tracers, 1000 steps) on the mesh_fine-scale generated mesh, its
   physics gates, and the same 1000 steps in f64;
3. large matrix-free regime — 1,048,576 nodes, stencil SpMV + two-level
   PCG + semi-Lagrangian dye, its physics and dye gates, 5 steps against
   an f64 CSR run of the same problem, the step's memory analysis;
4. every other entry point at moderate size — matrix-free Navier–Stokes,
   Poisson, heat, sparse Taylor–Hood (CSR engine) and a 3-gait sweep;
5. the ``gpu``-marked tests, in this process.

``--four`` runs only the four-device paths: a 4-gait ``ShardedEnsemble``
against four single-device runs, and the space-sharded stencil-halo step
at 1,048,576 nodes against the single-device step.

Any failed gate or comparison raises: the script exits non-zero and
prints no result line.  It refuses a machine whose JAX device is not a
GPU.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# f32 fused step vs the same 1000 steps in f64.  The step is a contractive
# affine map applied in f32 at HIGHEST precision, so u carries only f32
# rounding (~1e-6 relative); TF32 operand rounding would show as ~1e-3.
HEADLINE_U_RTOL = 1e-4
# Capture is a threshold on tracer radius: f32 rounding of the tracer
# paths flips tracers that sit within ~1e-6 of the capture circle.
HEADLINE_EATEN_FRAC = 0.005
# f32 stencil vs f64 CSR after 5 steps.  Both runs stop their CGs at a
# relative residual of 1e-5 (pressure and viscous), so that tolerance, not
# f32 rounding (~1e-7), sets how far the two u may drift apart: 10× the
# CG tolerance.
LARGE_U_RTOL = 1e-4
# The 4-gait ensemble computes the same f32 steps with another layout and
# reduction order (row-sharded matvecs, psum'd element sums).
FOUR_ENSEMBLE_U_RTOL = 1e-4
FOUR_ENSEMBLE_EATEN = 2  # tracers per gait, as tests/test_sweep.py allows
# The halo step runs the same fixed-iteration Jacobi CG as the single-
# device step in f64: only the distributed reduction order differs.
FOUR_HALO_U_RTOL = 1e-9


def require_gpu(devices=None):
    """The JAX devices, if the first is a GPU; raises otherwise."""
    import jax

    devices = jax.devices() if devices is None else devices
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX found platform {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return devices


def result_line(devices) -> str:
    dev = devices[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
    })


def card_name_and_power() -> str:
    """``name, power.limit`` of every card, from a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _report(phase: str, row: dict):
    print(f"[{phase}] " + json.dumps(row, default=float), flush=True)


def _require(ok: bool, row) -> None:
    """A gate: raises (also under ``python -O``) with the phase's row."""
    if not ok:
        raise RuntimeError(f"gate failed: {row}")


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _release():
    """Drop compiled programs and problems between phases."""
    import jax

    from tpufem.workloads import navier_stokes, stokes, th_sparse

    for mod in (stokes, navier_stokes, th_sparse):
        mod._RUN_CACHE.clear()
    jax.clear_caches()
    gc.collect()


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(query_card=True):
    import jax

    devs = jax.devices()
    row = {"devices": [str(d) for d in devs], "kind": devs[0].device_kind,
           "count": len(devs)}
    if query_card:
        row["card"] = card_name_and_power()
    _report("device", row)
    return row


def phase_headline(n_side=33, n_circle=48, steps=1000, tracer_density=115):
    """The dense regime: fused f32 StokesFood run, gates, f64 comparison."""
    import dataclasses

    import jax

    import bench
    import tpufem
    from tpufem import bench_large
    from tpufem.workloads import stokes

    mesh = tpufem.generate_annulus_mesh(n_side=n_side, n_circle=n_circle)
    cfg = dataclasses.replace(bench.headline_config(),
                              tracer_density=tracer_density)
    t0 = time.perf_counter()
    prob = stokes.StokesProblem.build(mesh, cfg)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(stokes.run(prob, steps=steps))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, mets = jax.block_until_ready(stokes.run(prob, steps=steps))
    sps = steps / (time.perf_counter() - t0)
    phys = bench_large.physics_report(prob, state, mets, steps)

    ref = stokes.StokesProblem.build(
        mesh, dataclasses.replace(cfg, precision="f64"))
    s64, m64 = stokes.run(ref, steps=steps)
    n_tr = int(prob.tracer_init.shape[0])
    eaten32 = int(np.asarray(mets["eaten"])[-1])
    eaten64 = int(np.asarray(m64["eaten"])[-1])
    u_rel = _rel(state["u"], s64["u"])
    row = {
        "n_nodes": int(mesh.n_nodes), "tracers": n_tr, "steps": steps,
        "steps_per_s": sps, "build_s": t_build, "first_run_s": t_first,
        "u_rel_f32_vs_f64": u_rel, "u_rtol": HEADLINE_U_RTOL,
        "eaten_f32": eaten32, "eaten_f64": eaten64, **phys,
    }
    _report("headline", row)
    _require(u_rel < HEADLINE_U_RTOL, row)
    _require(abs(eaten32 - eaten64) <= HEADLINE_EATEN_FRAC * n_tr, row)
    _require(0 < eaten32 < n_tr, row)
    return row


def phase_large(n_side=1024, n_circle=1088, steps=30, cmp_steps=5,
                transport="dye"):
    """The matrix-free regime at 1M nodes: bench row, gates, f64 CSR."""
    import jax

    from tpufem import bench_large
    from tpufem.workloads import stokes

    mesh, config, prob, t_build = bench_large.build_one(
        n_side, n_circle, transport=transport)
    sps, t_compile, state, mets, warm_sps = bench_large.run_problem(prob, steps)
    row = bench_large._row(prob, mesh, config, steps, sps, t_build, t_compile,
                           state, mets, "twolevel", warm_sps)
    row["peak_bytes_in_use"] = _peak_bytes()

    # the step's compiled memory footprint, then cmp_steps of the same step
    st0 = stokes.initial_state(prob)
    step = jax.jit(stokes.make_step(prob)).lower(st0, None).compile()
    mem = step.memory_analysis()
    row["step_memory_analysis"] = str(mem)
    s32 = st0
    for _ in range(cmp_steps):
        s32, _ = step(s32, None)

    _, _, ref, _ = bench_large.build_one(
        n_side, n_circle, transport=transport, storage="csr",
        precision="f64", cg_coarse_dtype="same")
    step64 = jax.jit(stokes.make_step(ref))
    s64 = stokes.initial_state(ref)
    for _ in range(cmp_steps):
        s64, _ = step64(s64, None)
    u_rel = _rel(s32["u"], s64["u"])
    c_rel = _rel(s32["c"], s64["c"]) if "c" in s32 else None
    row.update({
        "cmp_steps": cmp_steps, "u_rel_f32_stencil_vs_f64_csr": u_rel,
        "c_rel_f32_stencil_vs_f64_csr": c_rel, "u_rtol": LARGE_U_RTOL,
        "ref_storage": type(ref.visc_solver.K).__name__,
        "peak_bytes_in_use_after_ref": _peak_bytes(),
    })
    _report("large", row)
    if jax.default_backend() == "gpu":
        _require(row["storage"] == "StencilOperator", row)
    _require(u_rel < LARGE_U_RTOL, row)
    return row


def phase_entry_points(ns=(280, 320, 50), field=(400, 448), heat_steps=20,
                       th=(96, 5), sweep=(33, 48, 1500)):
    """Every other workload entry point through its bench runner."""
    import tpufem
    from tpufem import bench_large
    from tpufem.workloads import sweep as sweep_mod

    rows = {}
    rows["ns"] = bench_large.run_ns(ns[0], ns[1], ns[2])
    _release()
    rows["poisson"] = bench_large.run_poisson_large(*field)
    _release()
    rows["heat"] = bench_large.run_heat_large(*field, steps=heat_steps)
    _release()
    rows["th_sparse"] = bench_large.run_th_sparse(th[0], th[0], th[1])
    _release()
    mesh = tpufem.generate_annulus_mesh(n_side=sweep[0], n_circle=sweep[1])
    t0 = time.perf_counter()
    res = sweep_mod.food_capture_sweep(
        mesh, sweep_mod.SweepConfig(steps=sweep[2]))
    frac = {b2: r["consumed_fraction"] for b2, r in res.items()}
    rows["sweep"] = {"steps": sweep[2], "consumed": frac,
                     "seconds": time.perf_counter() - t0}
    for name, row in rows.items():
        _report(f"entry:{name}", row)
    # the campaign's published ordering (reference README: swimming gaits
    # feed far better than the neutral squirmer)
    _require(frac[-5.0] > frac[0.0] and frac[5.0] > frac[0.0], frac)
    _require(all(0.0 < f <= 1.0 for f in frac.values()), frac)
    return rows


def phase_gpu_tests():
    """The ``gpu``-marked tests (they live in ``tests/test_gpu.py``, which
    imports nothing beyond what this script needs), run by pytest inside
    this process."""
    import pytest

    os.environ["TPUFEM_TESTS_KEEP_PLATFORM"] = "1"
    rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                      "-o", "addopts=",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    row = {"pytest_exit_code": int(rc)}
    _report("gpu_tests", row)
    _require(rc == 0, row)
    return row


def phase_four_ensemble(n_side=33, n_circle=48, steps=200, tracer_density=115,
                        n_devices=4):
    """4-gait ShardedEnsemble (data × space) vs four single-device runs."""
    import dataclasses

    import jax

    import bench
    import tpufem
    from tpufem.parallel import ShardedEnsemble, build_device_mesh, run_sharded
    from tpufem.workloads import stokes

    dmesh = build_device_mesh(n_devices)
    mesh = tpufem.generate_annulus_mesh(n_side=n_side, n_circle=n_circle)
    b2s = np.array([0.0, -5.0, 5.0, 2.5])
    cfg = dataclasses.replace(bench.headline_config(), fused=False,
                              tracer_density=tracer_density)
    ens = ShardedEnsemble.build(mesh, dmesh, np.full(len(b2s), cfg.B1), b2s,
                                config=cfg)
    t0 = time.perf_counter()
    st, eaten = jax.block_until_ready(run_sharded(ens, steps))
    t_sharded = time.perf_counter() - t0
    rels, d_eaten = [], []
    for i, b2 in enumerate(b2s):
        prob = stokes.StokesProblem.build(
            mesh, dataclasses.replace(cfg, B2=float(b2)))
        s1, m1 = stokes.run(prob, steps=steps)
        rels.append(_rel(np.asarray(st["u"])[i], s1["u"]))
        d_eaten.append(int(np.asarray(eaten)[-1, i])
                       - int(np.asarray(m1["eaten"])[-1]))
    row = {"mesh": dict(dmesh.shape), "gaits": b2s.tolist(), "steps": steps,
           "sharded_first_run_s": t_sharded, "u_rel": rels,
           "u_rtol": FOUR_ENSEMBLE_U_RTOL, "eaten_sharded_minus_single": d_eaten}
    _report("four:ensemble", row)
    _require(max(rels) < FOUR_ENSEMBLE_U_RTOL, row)
    _require(max(abs(d) for d in d_eaten) <= FOUR_ENSEMBLE_EATEN, row)
    return row


def phase_four_halo(n_side=1024, n_circle=1088, steps=3, n_devices=4):
    """Space-sharded stencil-halo step vs the single-device step."""
    import jax

    import tpufem
    from tpufem.parallel import build_device_mesh, make_sharded_matfree_step
    from tpufem.workloads import stokes

    dmesh = build_device_mesh(n_devices, data=1)
    mesh = tpufem.generate_annulus_mesh(n_side=n_side, n_circle=n_circle,
                                        pad_hole=True)
    cfg = stokes.StokesConfig(
        dt=0.01, nu=1.0, solver="cg", cg_storage="stencil", precision="f64",
        cg_iters_visc=20, cg_iters_pressure=40, cg_warm_start=False,
        transport="none",
    )
    prob = stokes.StokesProblem.build(mesh, cfg)
    sh_step = make_sharded_matfree_step(dmesh, prob)
    step = jax.jit(stokes.make_step(prob))
    state = stokes.initial_state(prob)
    u_sh = state["u"]
    t0 = time.perf_counter()
    for _ in range(steps):
        u_sh, m_sh = sh_step(u_sh)
    jax.block_until_ready(u_sh)
    t_sharded = time.perf_counter() - t0
    for _ in range(steps):
        state, m1 = step(state, None)
    rel = _rel(u_sh, state["u"])
    row = {"mesh": dict(dmesh.shape), "n_nodes": int(mesh.n_nodes),
           "steps": steps, "sharded_first_steps_s": t_sharded, "u_rel": rel,
           "u_rtol": FOUR_HALO_U_RTOL,
           "final_div_max": [float(m_sh["final_div_max"]),
                             float(m1["final_div_max"])]}
    _report("four:halo", row)
    _require(rel < FOUR_HALO_U_RTOL, row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths and their references")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"--four needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from tpufem.bench_large import enable_compile_cache

    enable_compile_cache()

    t_all = time.perf_counter()
    phase_device()
    if args.four:
        phases = (phase_four_ensemble, phase_four_halo)
        devices = devices[:4]
    else:
        phases = (phase_headline, phase_large, phase_entry_points,
                  phase_gpu_tests)
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"[{phase.__name__}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        _release()
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(card_name_and_power(), flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
