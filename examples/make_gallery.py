"""Render the reference's committed figures from tpufem runs.

The reference repo ships `images/{Mesh,Poisson,Heat,Stokes_flow}.png` and
`scripts/fluid_squirmer_dye.mp4`; this script reproduces the gallery from
framework runs on whatever device JAX finds:

    python examples/make_gallery.py [outdir]

Outputs: mesh.png, poisson.png, heat.png, stokes_flow.png, food.png,
dye_mixing.(mp4|gif).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(outdir="examples/gallery", quick=False):
    import os

    import tpufem

    tpufem.enable_x64()
    import jax.numpy as jnp

    from tpufem import config as cfgmod, viz
    from tpufem.ops import calculus
    from tpufem.workloads import heat, poisson, stokes

    os.makedirs(outdir, exist_ok=True)
    stem = cfgmod.reference_mesh_path("mesh.1")
    mesh = tpufem.load_mesh(stem) if stem else tpufem.generate_annulus_mesh()
    if quick:  # smoke-test sizes (tests/test_examples.py)
        mesh = tpufem.generate_annulus_mesh(n_side=14, n_circle=16)
    heat_steps = 30 if quick else 600
    stokes_steps = 20 if quick else 300
    food_steps = 15 if quick else 400
    anim_steps, anim_int = (8, 4) if quick else (300, 15)

    # Mesh.png
    viz.plot_mesh(mesh).figure.savefig(f"{outdir}/mesh.png", dpi=110)

    # Poisson.png
    f, _ = poisson.solve(mesh)
    ax = viz.plot_scalar(mesh, np.asarray(f), label="f(x, y)")
    ax.set_title("FEM Poisson, periodic x + Dirichlet")
    ax.figure.savefig(f"{outdir}/poisson.png", dpi=110)

    # Heat.png
    u, _ = heat.run(mesh, heat.HeatConfig(steps=heat_steps))
    ax = viz.plot_scalar(mesh, np.asarray(u), label="u")
    ax.set_title("Implicit heat equation, 600 steps")
    ax.figure.savefig(f"{outdir}/heat.png", dpi=110)

    # Stokes_flow.png — squirmer dashboard
    prob = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(pressure_mode="merge")
    )
    state, _ = stokes.run(prob, steps=stokes_steps)
    uu = np.asarray(state["u"])
    w = np.asarray(calculus.vorticity(mesh, jnp.asarray(uu)))
    # pressure snapshot from one extra projection step
    _, p, _, _ = stokes.projection_step(prob, state["u"])
    viz.dashboard(mesh, uu, np.asarray(p), vorticity=w,
                  path=f"{outdir}/stokes_flow.png")

    # food.png — tracer capture frame
    probf = stokes.StokesProblem.build(
        mesh,
        stokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers",
                            pressure_mode="merge"),
    )
    statef, _, food_frames = viz.run_with_frames(
        probf, steps=food_steps, frame_interval=max(1, food_steps // 40),
        field=("u", "tracers", "tracer_status"),
    )
    ax = viz.tracer_frame(mesh, np.asarray(statef["u"]), statef["tracers"],
                          statef["tracer_status"])
    ax.set_title("Squirmer food capture")
    ax.figure.savefig(f"{outdir}/food.png", dpi=110)

    # food movie — the reference's most distinctive visual output
    # (code/StokesFood.py:507-536 live loop → offline mp4/gif here)
    food_path = viz.animate_tracers(
        mesh, food_frames["u"], food_frames["tracers"],
        food_frames["tracer_status"], path=f"{outdir}/food.mp4", fps=8,
    )

    # dye mixing animation (fluid_squirmer_dye.mp4 equivalent)
    probd = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(transport="dye", pressure_mode="merge")
    )
    _, _, frames = viz.run_with_frames(probd, steps=anim_steps, frame_interval=anim_int)
    path = viz.animate(mesh, frames, path=f"{outdir}/dye_mixing.mp4", fps=8)
    print(f"gallery written to {outdir}/ (animations: {path}, {food_path})")


def xl_dye_movie(outdir="examples/gallery", n_side=640, n_circle=720,
                 steps=600, frame_interval=20, quick=False):
    """The flagship movie: a semi-Lagrangian dye run
    at 410k nodes — 384× the reference's largest mesh — exported as an
    offline animation from :func:`viz.run_with_frames` snapshots, the
    decoupled form of ``scripts/good_visualization2.py:735-744`` (which
    commits ``fluid_squirmer_dye.mp4``).

    The sandbox image has NO ffmpeg (``matplotlib.animation.FFMpegWriter
    .isAvailable() == False``), so :func:`viz.animate`'s pillow/GIF
    fallback is the declared mp4-equivalent here; on a machine with
    ffmpeg the same call writes the mp4.

        python examples/make_gallery.py --xl          # 410k
        python examples/make_gallery.py --xl-quick    # smoke size
    """
    import jax

    jax.config.update("jax_enable_x64", True)
    import tpufem
    from tpufem import viz
    from tpufem.bench_large import bench_config, enable_compile_cache

    enable_compile_cache()
    if quick:
        n_side, n_circle, steps, frame_interval = 14, 16, 8, 4
    os.makedirs(outdir, exist_ok=True)
    mesh = tpufem.generate_annulus_mesh(
        n_side=n_side, n_circle=n_circle, pad_hole=not quick
    )
    from tpufem.workloads import stokes

    cfg = bench_config(
        "twolevel", n_nodes=int(mesh.n_nodes), transport="dye",
        storage="auto" if not quick else "csr",
    )
    prob = stokes.StokesProblem.build(mesh, cfg)
    _, _, frames = viz.run_with_frames(
        prob, steps=steps, frame_interval=frame_interval
    )
    path = viz.animate(
        mesh, frames, path=f"{outdir}/dye_{mesh.n_nodes // 1000}k.mp4",
        fps=8, dpi=72 if not quick else 40,
    )
    print(f"flagship movie written: {path} ({len(frames)} frames)")
    return path


if __name__ == "__main__":
    if "--xl" in sys.argv:
        xl_dye_movie()
    elif "--xl-quick" in sys.argv:
        xl_dye_movie(quick=True)
    else:
        main(*sys.argv[1:])
