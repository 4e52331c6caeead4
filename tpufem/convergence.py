"""Accuracy-at-scale convergence study (``python -m tpufem converge``).

The large-mesh paths were first shown to be *fast*; this study shows
they are *correct physics*: the committed large-mesh
numbers previously validated finiteness only, while ``final_div_max``
grew with N and nothing separated "fast solver" from "fast noise".

Two complementary studies, both on the squirmer configuration with
**dt scaled ∝ h** (fixed physical horizon T, so every size integrates
the same flow):

1. ``self``: velocity self-convergence — solve on a size ladder, sample
   every solution at one fixed probe-point set (P1 interpolation via the
   transport locator), and measure the relative L2 error against the
   finest ladder rung.  A convergent discretization shows monotonically
   decreasing error ~O(h); a diverging/unstable one does not converge at
   all.  Also reports the *normalized* divergence ‖div u‖_M·h/‖u‖_M per
   size (the mesh-size-comparable form of the reference's own
   ``Final Div(u)`` failure detector, ``code/StokesColor.py:575``).

2. ``th``: trusted-reference cross-check — on each of a few geometries
   the P1/P1 projection steady state is compared against the LBB-stable
   P2/P1 Taylor–Hood solution of the SAME mesh (``p2_refine`` +
   ``solve_taylor_hood``) — the in-repo gold standard whose weak
   divergence is zero against the full P1 test space.  The error should
   decrease with refinement.

Output: one JSON line per size + a markdown table (committed to
``docs/PARITY.md`` §7 with the raw JSONL in ``benchmarks/``).
"""

from __future__ import annotations

import json
import time

import numpy as np

# (label, n_side, n_circle) — pad_hole ladder; dt ∝ 1/(n_side−1) ∝ h
SELF_SIZES = [
    ("1.6k", 40, 48),
    ("6.5k", 80, 96),
    ("26k", 160, 192),
    ("79k", 280, 320),
    ("160k", 400, 448),
]
DT0 = 0.01  # at n_side = 40  (the reference's food-run dt, StokesFood.py:42)
T_FINAL = 1.0  # physical horizon: ~viscous time L²/ν, well into steady state
NU = 1.0


def probe_points(n: int = 1600, seed: int = 7) -> np.ndarray:
    """Fixed probe set: quasi-uniform points in the annulus interior,
    ≥0.33 from the center (off the squirmer surface) and ≥0.08 from the
    outer boundary — identical across every mesh size."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        cand = rng.uniform(0.08, 0.92, size=(4 * n, 2))
        r = np.hypot(cand[:, 0] - 0.5, cand[:, 1] - 0.5)
        cand = cand[r > 0.33]
        pts.extend(cand.tolist())
    return np.asarray(pts[:n])


def _steady_config(
    n_side: int, steps: int, dt: float, storage: str = "auto",
    all_walls: bool = False, lift: bool = True,
):
    from tpufem.workloads import stokes

    return stokes.StokesConfig(
        dt=dt, nu=NU, transport="none", solver="cg", cg_storage=storage,
        precision="f32", cg_iters_visc=30, cg_iters_pressure=60,
        cg_precond="twolevel", cg_warm_start=True, cg_tol_pressure=1e-5,
        cg_tol_visc=1e-5 if n_side >= 160 else 0.0, all_walls=all_walls,
        # consistent Dirichlet-column lifting: without it the projection
        # inherits the reference's accuracy ceiling (the slip exerts no
        # viscous traction) and does NOT converge to the Taylor–Hood
        # solution — measured 0.52 vs 0.19 rel. error at h=0.032
        dirichlet_lift=lift,
    )


def _probe(problem, u, pts):
    import jax.numpy as jnp

    from tpufem import transport

    vals, found = transport.interpolate(
        problem.mesh, jnp.asarray(u), jnp.asarray(pts, dtype=u.dtype),
        problem.get_locator(),
    )
    return np.asarray(vals, dtype=np.float64), np.asarray(found)


def run_self(
    sizes=None, steps0: int | None = None, storage: str = "auto",
    check: bool = True,
):
    """Self-convergence ladder → list of row dicts (finest = reference)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from tpufem import bench_large
    from tpufem.mesh.generate import generate_annulus_mesh
    from tpufem.workloads import stokes

    bench_large.enable_compile_cache()
    sizes = sizes or SELF_SIZES
    pts = probe_points()
    sampled = []
    rows = []
    for label, n_side, n_circle in sizes:
        dt = DT0 * (40 - 1) / (n_side - 1)
        steps = int(round((steps0 * DT0 if steps0 else T_FINAL) / dt))
        t0 = time.perf_counter()
        mesh = generate_annulus_mesh(
            n_side=n_side, n_circle=n_circle, pad_hole=True
        )
        problem = stokes.StokesProblem.build(
            mesh, _steady_config(n_side, steps, dt, storage)
        )
        state, metrics = stokes.run(problem, steps=steps)
        u = np.asarray(state["u"])
        elapsed = time.perf_counter() - t0
        phys = bench_large.physics_report(problem, state, metrics, steps)
        vals, found = _probe(problem, state["u"], pts)
        assert found.all(), f"{(~found).sum()} probe points not located"
        h = float(np.sqrt(2.0 * np.median(np.asarray(problem.mesh.area))))
        sampled.append(vals)
        rows.append({
            "label": label, "n_nodes": int(mesh.n_nodes), "h": round(h, 5),
            "dt": dt, "steps": steps, "wall_s": round(elapsed, 1), **phys,
        })
    ref = sampled[-1]
    ref_norm = float(np.sqrt((ref**2).mean()))
    for row, vals in zip(rows, sampled):
        row["err_vs_finest"] = round(
            float(np.sqrt(((vals - ref) ** 2).mean())) / ref_norm, 6
        )
    if check:
        # convergence gate: each coarser rung must be strictly worse than
        # the next finer one (the finest's self-error is 0 by construction)
        errs = [r["err_vs_finest"] for r in rows[:-1]]
        assert all(a > b for a, b in zip(errs, errs[1:])), (
            f"velocity error not decreasing under refinement: {errs}"
        )
        divs = [r["div_rel"] for r in rows]
        assert max(divs) < bench_large.DIV_REL_GATES["stokes"], divs
    return rows


# non-pad_hole geometries small enough for the dense Taylor–Hood factor
TH_SIZES = [
    ("0.5k", 24, 32), ("0.8k", 32, 40), ("1.2k", 40, 48), ("1.7k", 48, 56),
]
# Finer rungs (TH reference switches to th_sparse.steady_solve past the
# dense factorization ceiling).  NOT part of the monotone-decrease gate:
# the lifted P1/P1 error vs same-mesh TH bottoms out at ~0.118 near
# h≈1/48 and GROWS under further refinement (0.133 at 60, 0.240 at 80 —
# dt-, precision- and solver-tolerance-independent).
# Once the Dirichlet-traction defect is lifted, the un-stabilized
# P1/P1 pair's LBB modes dominate: the projection scheme has a genuine
# accuracy FLOOR, which is the quantitative form of the reference's own
# caveat (README.md:19) — fine-mesh accuracy requires the (sparse)
# Taylor–Hood path.
TH_SIZES_EXT = [("3.6k", 60, 68), ("6.4k", 80, 88)]
DENSE_TH_DOF_CEIL = 15_000  # 2N₂+N₁ above this → sparse steady Uzawa
T_STEADY = 12.0  # enclosed-box spin-up: measured steady by T≈6–12 (the
# bare viscous estimate L²/(π²ν)≈0.1 is off ~100× for the recirculation)


def run_th(sizes=None, steps0: int | None = None, check: bool = True,
           extended: bool = False):
    """P1/P1 projection steady state vs same-mesh Taylor–Hood.

    ``extended=True`` appends the TH_SIZES_EXT rungs, where the lifted
    P1/P1 error is documented to turn NON-monotone (see the comment at
    TH_SIZES_EXT) — the monotone gate then applies to the base rungs
    only."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from tpufem.mesh.generate import generate_annulus_mesh
    from tpufem.mesh.p2 import p2_refine
    from tpufem.workloads import navier_stokes as ns
    from tpufem.workloads import stokes

    pts = probe_points(800)
    rows = []
    base = sizes or TH_SIZES
    table = list(base) + (TH_SIZES_EXT if extended and sizes is None else [])
    n_gated = len(base)
    for label, n_side, n_circle in table:
        dt = DT0 * (40 - 1) / (n_side - 1)
        steps = int(round((steps0 * DT0 if steps0 else T_STEADY) / dt))
        mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle)
        # enclosed box (all outer nodes no-slip): the BC set the TH
        # solver imposes — the periodic-channel variant would compare
        # different flows
        problem = stokes.StokesProblem.build(
            mesh,
            _steady_config(n_side, steps, dt, storage="csr", all_walls=True),
        )
        state, _ = stokes.run(problem, steps=steps)
        u1, found1 = _probe(problem, state["u"], pts)

        m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
        n2 = m2.coords.shape[0]
        n1 = mesh.n_nodes
        if 2 * n2 + n1 > DENSE_TH_DOF_CEIL:
            from tpufem.workloads import th_sparse

            sp = th_sparse.SparseTHProblem.build(
                m2, th_sparse.SparseTHConfig(nu=NU, B1=-2.0, B2=0.0)
            )
            uth, _ = th_sparse.steady_solve(sp)
        else:
            uth, _, res = ns.solve_taylor_hood(
                m2, ns.TaylorHoodConfig(nu=NU, B1=-2.0, B2=0.0)
            )
            assert float(res) < 1e-8
        # P2 velocity sampled with the P1 interpolant of its corner values
        # (probe-level comparison; both fields share the corner nodes)
        import jax.numpy as jnp

        from tpufem import transport

        vals2, found2 = transport.interpolate(
            mesh, jnp.asarray(np.asarray(uth)[: mesh.n_nodes]),
            jnp.asarray(pts), problem.get_locator(),
        )
        u2 = np.asarray(vals2, dtype=np.float64)
        ok = np.asarray(found1) & np.asarray(found2)
        err = float(
            np.sqrt(((u1[ok] - u2[ok]) ** 2).mean())
            / np.sqrt((u2[ok] ** 2).mean())
        )
        h = float(np.sqrt(2.0 * np.median(mesh.area)))
        rows.append({
            "label": label, "n_nodes": int(mesh.n_nodes), "h": round(h, 5),
            "dt": dt, "steps": steps, "err_vs_taylor_hood": round(err, 6),
        })
    if check:
        errs = [r["err_vs_taylor_hood"] for r in rows[:n_gated]]
        assert all(a > b for a, b in zip(errs, errs[1:])), (
            f"P1 error vs Taylor–Hood not decreasing under refinement: {errs}"
        )
    return rows


# Navier–Stokes ladder (channel + inner body, body-force-driven —
# the matrix-free NS path, operator_spitting_ns.py:557-604 semantics).
# dt ∝ h from the reference's own dt at the coarsest rung; horizon fixed.
NS_SIZES = [
    ("2k", 40, 48),
    ("6.5k", 80, 96),
    ("26k", 160, 192),
    ("79k", 280, 320),
    # 160k reference rung: a finer oracle for the
    # lower rungs' err_vs_finest — at dt ∝ h this is ~1560 steps
    ("160k", 400, 448),
]
NS_DT0 = 4e-4  # at n_side = 40 (reference dt=1e-4 is for its ~1k meshes;
# the ∝h law lands exactly there near their h)
NS_T = 0.05  # physical horizon (125 coarse steps): the impulsively-forced
# flow is still developing — convergence is tested on the transient, which
# exercises the advection operator harder than the creeping steady state


def run_ns_conv(sizes=None, steps0: int | None = None, check: bool = True):
    """NS velocity self-convergence + normalized-divergence ladder.

    Before it, nothing showed the NS path's error
    decreasing under refinement, and its div_rel (~0.15–0.20 measured at
    26k–79k after 50 dt=1e-4 steps from rest) sits ~8× above the Stokes
    path's.  The ladder measures BOTH curves under dt ∝ h refinement:
    err_vs_finest must fall monotonically; div_rel's trend quantifies
    whether the divergence level is a scheme property (projection error
    of the *developing* flow) or noise."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from tpufem import bench_large
    from tpufem.mesh.generate import generate_annulus_mesh
    from tpufem.ops import assembly, calculus
    from tpufem.workloads import navier_stokes as ns
    from tpufem.workloads import stokes

    bench_large.enable_compile_cache()
    sizes = sizes or NS_SIZES
    pts = probe_points()
    sampled, rows = [], []
    for label, n_side, n_circle in sizes:
        import jax.numpy as jnp

        dt = NS_DT0 * (40 - 1) / (n_side - 1)
        steps = int(round((steps0 * NS_DT0 if steps0 else NS_T) / dt))
        t0 = time.perf_counter()
        mesh = generate_annulus_mesh(
            n_side=n_side, n_circle=n_circle, pad_hole=True
        )
        cfg = ns.NSConfig(
            dt=dt, nu=NU, solver="cg", precision="f32",
            cg_iters_visc=30, cg_iters_pressure=120, cg_tol=1e-5,
        )
        prob = ns.NSProblem.build(mesh, cfg)
        u, _ = ns.run(prob, steps=steps, host_loop=True)
        u_host = np.asarray(u, dtype=np.float64)
        elapsed = time.perf_counter() - t0
        assert np.isfinite(u_host).all(), f"NS {label} diverged"

        div = np.asarray(calculus.divergence(mesh, jnp.asarray(u)),
                         dtype=np.float64)
        ml = np.asarray(assembly.lumped_mass(mesh), dtype=np.float64)
        h = float(np.sqrt(2.0 * np.median(np.asarray(mesh.area))))
        div_l2 = float(np.sqrt((ml * div**2).sum()))
        u_l2 = float(np.sqrt((ml * (u_host**2).sum(axis=1)).sum()))
        # probe via a throwaway Stokes problem's locator (same mesh)
        sprob = stokes.StokesProblem.build(
            mesh, stokes.StokesConfig(dt=dt, transport="none", solver="cg",
                                      precision="f32"),
        )
        vals, found = _probe(sprob, jnp.asarray(u), pts)
        assert found.all(), f"{(~found).sum()} probe points not located"
        sampled.append(vals)
        rows.append({
            "label": label, "n_nodes": int(mesh.n_nodes), "h": round(h, 5),
            "dt": dt, "steps": steps, "wall_s": round(elapsed, 1),
            "max_u": float(np.abs(u_host).max()),
            "div_rel": round(div_l2 * h / max(u_l2, 1e-30), 4),
        })
    ref = sampled[-1]
    ref_norm = float(np.sqrt((ref**2).mean()))
    for row, vals in zip(rows, sampled):
        row["err_vs_finest"] = round(
            float(np.sqrt(((vals - ref) ** 2).mean())) / ref_norm, 6
        )
    if check:
        errs = [r["err_vs_finest"] for r in rows[:-1]]
        assert all(a > b for a, b in zip(errs, errs[1:])), (
            f"NS velocity error not decreasing under refinement: {errs}"
        )
    return rows


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(prog="tpufem converge")
    parser.add_argument("--study", default="self", choices=["self", "th", "ns"])
    parser.add_argument("--sizes", default=None,
                        help="comma-separated labels to include")
    parser.add_argument("--steps0", type=int, default=None,
                        help="step count at the coarsest size (default: "
                             "T=1.0 horizon)")
    parser.add_argument("--storage", default="auto")
    parser.add_argument("--extended", action="store_true",
                        help="th: append the beyond-convergent-range "
                             "rungs (sparse steady TH reference)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    if args.study == "self":
        table = SELF_SIZES
        wanted = set(args.sizes.split(",")) if args.sizes else None
        sizes = [s for s in table if wanted is None or s[0] in wanted]
        rows = run_self(sizes, steps0=args.steps0, storage=args.storage)
        cols = ("label", "n_nodes", "h", "dt", "steps", "err_vs_finest",
                "div_rel", "final_div_max")
    elif args.study == "ns":
        table = NS_SIZES
        wanted = set(args.sizes.split(",")) if args.sizes else None
        sizes = [s for s in table if wanted is None or s[0] in wanted]
        rows = run_ns_conv(sizes, steps0=args.steps0)
        cols = ("label", "n_nodes", "h", "dt", "steps", "err_vs_finest",
                "div_rel", "max_u")
    else:
        table = TH_SIZES
        wanted = set(args.sizes.split(",")) if args.sizes else None
        sizes = [s for s in table if wanted is None or s[0] in wanted]
        rows = run_th(sizes if wanted is not None else None,
                      steps0=args.steps0 or 150, extended=args.extended)
        cols = ("label", "n_nodes", "h", "dt", "steps", "err_vs_taylor_hood")

    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print("\n| " + " | ".join(cols) + " |")
    print("|" + "---|" * len(cols))
    for r in rows:
        print("| " + " | ".join(str(r.get(c)) for c in cols) + " |")
    return rows


if __name__ == "__main__":
    main()
