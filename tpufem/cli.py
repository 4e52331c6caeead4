"""Command-line entry points: one subcommand per reference workload.

The reference's "config system" is hand-edited module constants duplicated
per script (SURVEY.md §5); here every workload is a dataclass config
driven from one CLI::

    python -m tpufem poisson --mesh mesh2.1 --out out/
    python -m tpufem heat    --mesh mesh2.1 --steps 600
    python -m tpufem stokes  --mesh mesh.1 --transport dye --b2 5 --steps 1000
    python -m tpufem food    --mesh mesh_fine.1 --steps 1000 --precision f32
    python -m tpufem report  --mesh mesh5.1 --steps 500
    python -m tpufem ns      --mesh mesh2.1 --steps 1000
    python -m tpufem monolithic --mesh mesh.1
    python -m tpufem stam    --frames 400
    python -m tpufem ad      --mesh mesh2.1
    python -m tpufem graph   --mesh mesh.1
    python -m tpufem bench

``--mesh`` accepts a bundled reference mesh stem (resolved via
TPUFEM_REFERENCE_DIR), a path stem to Triangle files, or ``generated``.
Outputs: metrics JSONL, final-state checkpoint, and a PNG per run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _resolve_mesh(spec: str):
    import tpufem
    from tpufem import config as cfg

    if spec == "generated":
        return tpufem.generate_annulus_mesh()
    stem = cfg.reference_mesh_path(spec)
    if stem is None and os.path.exists(spec + ".node"):
        stem = spec
    if stem is None:
        raise SystemExit(f"mesh {spec!r} not found (bundled name, path stem, or 'generated')")
    return tpufem.load_mesh(stem)


def _common(sub, mesh_default="mesh.1"):
    sub.add_argument("--mesh", default=mesh_default)
    sub.add_argument("--out", default=None, help="output directory")
    sub.add_argument("--steps", type=int, default=None)
    sub.add_argument("--verbose", action="store_true",
                     help="print reference-style per-step lines after the run")


def _finish(args, name, state_or_field, metrics=None, mesh=None, field=None):
    out = args.out
    if metrics is not None:
        from tpufem.metrics import summarize

        if getattr(args, "verbose", False):
            from tpufem.metrics import print_reference_style

            print_reference_style(metrics, every=max(1, len(next(iter(metrics.values()))) // 50))
        print(json.dumps({name: summarize(metrics)}, indent=None, default=float))
    if out:
        os.makedirs(out, exist_ok=True)
        if metrics is not None:
            from tpufem.metrics import write_jsonl

            write_jsonl(os.path.join(out, f"{name}_metrics.jsonl"), metrics)
        if isinstance(state_or_field, dict):
            from tpufem.checkpoint import save_state

            save_state(os.path.join(out, f"{name}_state.npz"), state_or_field)
        if mesh is not None and field is not None:
            from tpufem import viz

            ax = viz.plot_scalar(mesh, field)
            ax.figure.savefig(os.path.join(out, f"{name}.png"), dpi=120)
        print(f"outputs written to {out}/")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpufem")
    sub = parser.add_subparsers(dest="cmd", required=True)

    for name in ("poisson", "heat", "stokes", "food", "report", "ns",
                 "monolithic", "taylorhood", "ad", "graph"):
        s = sub.add_parser(name)
        _common(s)
        if name == "taylorhood":
            s.add_argument("--sparse", action="store_true",
                           help="Uzawa-CG sparse path (any mesh size; "
                                "P2 built in-process if needed)")
        if name in ("stokes", "food"):
            s.add_argument("--b1", type=float, default=-2.0)
            s.add_argument("--b2", type=float, default=0.0)
            s.add_argument("--precision", default="f64", choices=["f64", "f32"])
            s.add_argument("--transport", default=None)
    s = sub.add_parser("sweep")
    _common(s)
    s = sub.add_parser("stam")
    s.add_argument("--frames", type=int, default=400)
    s.add_argument("--size", type=int, default=200)
    s.add_argument("--out", default=None)
    s = sub.add_parser("converge")
    s.add_argument("--study", default="self", choices=["self", "th"])
    s.add_argument("--sizes", default=None)
    s.add_argument("--steps0", type=int, default=None)
    s.add_argument("--storage", default="auto")
    s.add_argument("--out", default=None)
    s = sub.add_parser("bench")
    s.add_argument("--large", action="store_true",
                   help="large-mesh scaling sweep (tpufem.bench_large)")
    s.add_argument("--steps", type=int, default=50)
    s.add_argument("--sizes", default=None)
    s.add_argument("--precond", default="twolevel")
    s.add_argument("--bench-out", default=None)
    s.add_argument("--bench-transport", default=None,
                   help="large sweep transport: none | tracers | dye")
    s.add_argument("--bench-storage", default=None,
                   help="large sweep cg_storage: auto | stencil | banded | csr")
    s.add_argument("--bench-mesh", default=None,
                   help="imported mesh stem (e.g. mesh_fine.1) for --large")
    s.add_argument("--no-pad-hole", action="store_true")
    s.add_argument("--th", action="store_true",
                   help="--large: sparse Taylor–Hood timed run + same-mesh "
                        "P1/P1 divergence comparison")
    s.add_argument("--ns", action="store_true",
                   help="--large: matrix-free Navier–Stokes scaling rows")
    s.add_argument("--poisson", action="store_true",
                   help="--large: matrix-free steady Poisson rows")
    s.add_argument("--heat", action="store_true",
                   help="--large: matrix-free implicit-Euler heat rows")
    s.add_argument("--n-side", type=int, default=96,
                   help="--large --th mesh resolution")
    s.add_argument("--bench-precision", default=None,
                   help="--large --th/--ns/--poisson/--heat precision "
                        "override (f32 | f64)")

    args = parser.parse_args(argv)
    import tpufem

    tpufem.enable_x64()

    if args.cmd == "converge":
        from tpufem import convergence

        conv_argv = ["--study", args.study, "--storage", args.storage]
        if args.sizes:
            conv_argv += ["--sizes", args.sizes]
        if args.steps0:
            conv_argv += ["--steps0", str(args.steps0)]
        if args.out:
            conv_argv += ["--out", args.out]
        convergence.main(conv_argv)
        return

    if args.cmd == "bench":
        if args.large:
            from tpufem import bench_large

            bench_argv = ["--steps", str(args.steps), "--precond", args.precond]
            if args.sizes:
                bench_argv += ["--sizes", args.sizes]
            if args.bench_out:
                bench_argv += ["--out", args.bench_out]
            if args.bench_transport:
                bench_argv += ["--transport", args.bench_transport]
            if args.bench_storage:
                bench_argv += ["--storage", args.bench_storage]
            if args.bench_mesh:
                bench_argv += ["--mesh", args.bench_mesh]
            if args.no_pad_hole:
                bench_argv += ["--no-pad-hole"]
            if args.th:
                bench_argv += ["--th", "--n-side", str(args.n_side)]
            if args.ns:
                bench_argv += ["--ns"]
            if args.poisson:
                bench_argv += ["--poisson"]
            if args.heat:
                bench_argv += ["--heat"]
            if args.bench_precision:
                bench_argv += ["--precision", args.bench_precision]
            bench_large.main(bench_argv)
            return
        import bench

        bench.main()
        return

    if args.cmd == "stam":
        from tpufem.workloads import stam_grid

        cfg = stam_grid.StamConfig(size=args.size)
        state, max_speed = stam_grid.run(cfg, frames=args.frames)
        print(json.dumps({"stam": {"frames": args.frames,
                                   "final_max_speed": float(np.asarray(max_speed)[-1])}}))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.save(os.path.join(args.out, "stam_density.npy"), np.asarray(state["density"]))
        return

    mesh = _resolve_mesh(args.mesh)

    if args.cmd == "poisson":
        from tpufem.workloads import poisson

        f, res = poisson.solve(mesh)
        print(json.dumps({"poisson": {"residual": float(res)}}))
        _finish(args, "poisson", None, mesh=mesh, field=np.asarray(f))
    elif args.cmd == "heat":
        from tpufem.workloads import heat

        steps = args.steps or 600
        u, maxu = heat.run(mesh, heat.HeatConfig(steps=steps))
        _finish(args, "heat", None, metrics={"max_u": maxu}, mesh=mesh,
                field=np.asarray(u))
    elif args.cmd in ("stokes", "food", "report"):
        from tpufem.workloads import stokes

        if args.cmd == "stokes":
            cfg = stokes.StokesConfig(
                B1=args.b1, B2=args.b2, precision=args.precision,
                transport=args.transport or "dye",
                pressure_mode="merge" if args.precision != "f64" else "penalty",
                solver="inverse" if args.precision != "f64" else "lu",
            )
        elif args.cmd == "food":
            cfg = stokes.StokesConfig(
                dt=0.01, nu=1.0, B1=args.b1, B2=args.b2, transport="tracers",
                precision=args.precision,
                pressure_mode="merge" if args.precision != "f64" else "penalty",
                solver="inverse" if args.precision != "f64" else "lu",
            )
        else:
            cfg = stokes.StokesConfig(
                variant="report", bc_kind="rotating", dt=1e-5, ramp_steps=200,
                pressure_smoothing=0.01, double_projection=False,
            )
        problem = stokes.StokesProblem.build(mesh, cfg)
        steps = args.steps or 1000
        state, metrics = stokes.run(problem, steps=steps)
        field = np.asarray(state.get("c", np.linalg.norm(np.asarray(state["u"]), axis=1)))
        _finish(args, args.cmd, state, metrics=metrics, mesh=mesh, field=field)
    elif args.cmd == "ns":
        from tpufem.workloads import navier_stokes as ns

        problem = ns.NSProblem.build(mesh, ns.NSConfig())
        u, metrics = ns.run(problem, steps=args.steps or 1000)
        _finish(args, "ns", None, metrics=metrics, mesh=mesh,
                field=np.linalg.norm(np.asarray(u), axis=1))
    elif args.cmd == "monolithic":
        from tpufem.workloads import navier_stokes as ns

        u, p, res = ns.solve_monolithic(mesh)
        print(json.dumps({"monolithic": {"residual": float(res),
                                         "max_u": float(np.abs(np.asarray(u)).max())}}))
        _finish(args, "monolithic", None, mesh=mesh, field=np.asarray(p))
    elif args.cmd == "taylorhood":
        from tpufem.workloads import navier_stokes as ns

        if getattr(args, "sparse", False):
            # Uzawa-CG sparse path — any size (generated meshes get their
            # P2 connectivity in-process via p2_refine)
            from tpufem.mesh.p2 import p2_refine
            from tpufem.workloads import th_sparse

            m2 = mesh
            if m2.tris_p2 is None:
                m2 = p2_refine(
                    mesh, snap_center=(0.5, 0.5), snap_radius=0.25
                )
            prob = th_sparse.SparseTHProblem.build(
                m2, th_sparse.SparseTHConfig(steps=args.steps or 200)
            )
            # host loop: one compiled step serves any --steps, and the
            # summary below reads final-step metrics only
            u, p, metrics = th_sparse.run(prob, host_loop=True)
            print(json.dumps({"taylorhood_sparse": {
                "n2": int(prob.n2), "n1": int(prob.n1),
                "steps": args.steps or 200,
                "max_u": float(np.abs(np.asarray(u)).max()),
                "div_weak_max": float(np.ravel(metrics["div_weak_max"])[-1]),
                "final_div_max": float(np.ravel(metrics["final_div_max"])[-1]),
            }}))
            _finish(args, "taylorhood", None, mesh=mesh,
                    field=np.linalg.norm(np.asarray(u)[: mesh.n_nodes], axis=1))
        elif args.steps:  # transient θ-scheme run
            prob = ns.TransientTHProblem.build(
                mesh, ns.TransientTHConfig(steps=args.steps)
            )
            u, p, metrics = ns.run_transient_th(prob)
            print(json.dumps({"taylorhood": {
                "steps": args.steps,
                "max_u": float(np.abs(np.asarray(u)).max()),
                "div_max": float(np.asarray(metrics["div_max"])[-1]),
            }}))
        else:
            u, p, res = ns.solve_taylor_hood(mesh)
            print(json.dumps({"taylorhood": {"residual": float(res),
                                             "max_u": float(np.abs(np.asarray(u)).max())}}))
        _finish(args, "taylorhood", None, mesh=mesh,
                field=np.linalg.norm(np.asarray(u), axis=1))
    elif args.cmd == "ad":
        from tpufem.workloads import advection_diffusion as ad

        problem = ad.ADProblem.build(mesh, ad.ADConfig(steps=args.steps or 1000))
        f, maxf = ad.run(problem)
        _finish(args, "ad", None, metrics={"max_f": maxf}, mesh=mesh,
                field=np.asarray(f))
    elif args.cmd == "sweep":
        from tpufem.workloads import sweep as sweep_mod

        cfg = sweep_mod.SweepConfig()
        if args.steps:
            cfg = sweep_mod.SweepConfig(steps=args.steps)
        res = sweep_mod.food_capture_sweep(mesh, cfg)
        print(json.dumps({
            "sweep": {str(b2): round(100 * r["consumed_fraction"], 1) for b2, r in res.items()}
        }))
    elif args.cmd == "graph":
        from tpufem.workloads import graph_average

        f, res = graph_average.solve(mesh)
        print(json.dumps({"graph": {"residual": float(res)}}))
        _finish(args, "graph", None, mesh=mesh, field=np.asarray(f))


if __name__ == "__main__":
    main()
