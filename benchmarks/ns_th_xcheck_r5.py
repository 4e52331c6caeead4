"""NS trusted-reference cross-check (accuracy).

The NS convergence ladder (``tpufem converge --study ns``) is
self-referential:
every rung is the same P1/P1 projection discretization.  This script
checks the NS stepper against an INDEPENDENT trusted discretization —
the transient P2/P1 Taylor–Hood stepper (LBB-stable, validated against
dense factorization to 3e-13) — on the same P1 mesh, same
impulsive-start configuration (all-wall + inner-body no-slip, ν=1,
dt=1e-4, 50 steps), exactly as PARITY §7 did for Stokes.  At this
horizon |u| ~ 1e-5·|f| so the advection term (~|u|²/h) is six orders
below the forcing — transient TH *Stokes* is the right oracle.

Two force configurations:

* ``rotational`` — f = 2·(0.5−y, x−0.5): non-conservative, drives a real
  vortex.  The row's ``rel_err_l2`` is the NS discretization error
  against the trusted field (the headline cross-check number).
* ``constant`` — f = (0.1, 0) (the NS bench/channel config,
  ``operator_spitting_ns.py:477-507``).  In this CLOSED box a constant
  force is exactly pressure-balanced (p = f·x ∈ P1), so the true
  velocity is ZERO — the TH row proves it (|u| ~ solver tolerance) and
  the NS row's ``ns_max_u`` therefore MEASURES the P1/P1 splitting
  artifact, the quantitative form of the reference's README.md:19
  accuracy caveat for its NS configuration.

Run from the repository root (CPU, f64):

    python benchmarks/ns_th_xcheck_r5.py [n_side ...]

One JSON row per line on standard output.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_pair(n_side, steps, dt, nu, force_fn, label, mass_consistent=False):
    import jax.numpy as jnp

    import tpufem
    from tpufem.mesh.p2 import p2_refine
    from tpufem.ops import assembly, calculus
    from tpufem.workloads import navier_stokes as ns
    from tpufem.workloads import th_sparse

    mesh = tpufem.generate_annulus_mesh(n_side=n_side, n_circle=n_side)
    f_p1 = force_fn(np.asarray(mesh.coords))

    t0 = time.perf_counter()
    ns_prob = ns.NSProblem.build(
        mesh,
        ns.NSConfig(
            dt=dt, nu=nu, body_force=f_p1, solver="cg", precision="f64",
            cg_iters_visc=40, cg_iters_pressure=200, cg_tol=1e-10,
            cg_precond="twolevel", mass_consistent=mass_consistent,
        ),
    )
    u_ns, mets = ns.run(ns_prob, steps=steps, host_loop=True)
    u_ns = np.asarray(u_ns, dtype=np.float64)
    t_ns = time.perf_counter() - t0
    print(f"[{label}] NS done in {t_ns:.1f}s, max_u={np.abs(u_ns).max():.3e}",
          flush=True)

    t0 = time.perf_counter()
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    f_p2 = force_fn(np.asarray(m2.coords))
    ii = max(60, int(1.5 * n_side))
    io_ = max(40, n_side // 2)
    ip = max(20, n_side // 3)
    th_prob = th_sparse.SparseTHProblem.build(
        m2,
        th_sparse.SparseTHConfig(
            dt=dt, nu=nu, B1=0.0, B2=0.0, body_force=f_p2, precision="f64",
            iters_inner=ii, iters_outer=io_, iters_plap=ip,
        ),
    )
    u_th, _, th_mets = th_sparse.run(th_prob, steps=steps, host_loop=True)
    u_th = np.asarray(u_th, dtype=np.float64)
    t_th = time.perf_counter() - t0
    print(f"[{label}] TH done in {t_th:.1f}s, max_u={np.abs(u_th).max():.3e}",
          flush=True)

    # compare at the shared P1 (corner) nodes, mass-weighted L2
    u_th_p1 = u_th[np.asarray(th_prob.corners)]
    ml = np.asarray(assembly.lumped_mass(mesh), dtype=np.float64)
    diff = u_ns - u_th_p1
    err_l2 = float(np.sqrt((ml * (diff**2).sum(axis=1)).sum()))
    ref_l2 = float(np.sqrt((ml * (u_th_p1**2).sum(axis=1)).sum()))
    ns_l2 = float(np.sqrt((ml * (u_ns**2).sum(axis=1)).sum()))

    return {
        "label": label,
        "mass_consistent": mass_consistent,
        "n_side": n_side,
        "n_nodes": int(mesh.n_nodes),
        "th_dofs": int(2 * th_prob.n2 + th_prob.n1),
        "steps": steps,
        "dt": dt,
        "ns_max_u": float(np.abs(u_ns).max()),
        "th_max_u": float(np.abs(u_th_p1).max()),
        "ns_u_l2": ns_l2,
        "th_u_l2": ref_l2,
        "err_l2": err_l2,
        "rel_err_l2": err_l2 / max(ref_l2, 1e-30),
        "ns_div_star_max": float(np.asarray(mets["div_star_max"])),
        "th_div_weak_max": float(np.asarray(th_mets["div_weak_max"])),
        "ns_seconds": round(t_ns, 1),
        "th_seconds": round(t_th, 1),
    }


def main():
    rungs = (
        [int(a) for a in sys.argv[1:]] if len(sys.argv) > 1 else [28, 56, 96]
    )
    steps = 50
    dt, nu = 1e-4, 1.0

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    rows = []
    # rotational: curl ≠ 0 → genuine flow; amplitude 2 keeps |u| in the
    # NS bench's scale.  A RUNG LADDER: rel_err falling under h-refinement
    # is the cross-check passing; a plateau is the P1/P1 LBB floor
    # (PARITY §7 measured ~0.118 for the Stokes squirmer)
    rot = lambda xy: np.stack(
        [2.0 * (0.5 - xy[:, 1]), 2.0 * (xy[:, 0] - 0.5)], axis=1
    )
    for n_side in rungs:
        rows.append(run_pair(n_side, steps, dt, nu, rot, "rotational"))
        print(json.dumps(rows[-1]), flush=True)
        # the mass-consistent form (NSConfig.mass_consistent=True): the
        # corrected weak scaling must CONVERGE to the TH transient where
        # the reference-parity form diverges from it
        rows.append(run_pair(n_side, steps, dt, nu, rot,
                             "rotational+consistent", mass_consistent=True))
        print(json.dumps(rows[-1]), flush=True)
    const = lambda xy: np.broadcast_to(
        np.array([0.1, 0.0]), (xy.shape[0], 2)
    ).copy()
    for n_side in (rungs[0], rungs[-1]):
        rows.append(run_pair(n_side, steps, dt, nu, const, "constant"))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
