"""tpufem — an accelerator-native unstructured-FEM fluid-simulation framework.

Built from scratch in JAX/XLA with the capabilities of the reference
project ``TobiasHoffmannP/PUC-Fluidsimulation-Project`` (see SURVEY.md):
Triangle-mesh P1 FEM, Poisson / heat / Stokes-projection solvers, squirmer
and periodic boundary conditions, dye and tracer transport, diagnostics,
and rendering — all redesigned as pure functional programs that compile to
a single XLA executable per workload (``jit`` + ``lax.scan``), instead of
the reference's per-step dense LAPACK solves and Python element loops.

Quick start::

    import tpufem
    tpufem.enable_x64()                   # f64 parity mode (reference default)
    mesh = tpufem.load_mesh("mesh.1")     # Triangle .node/.ele[/.poly] files
    from tpufem.workloads import stokes
    problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig())
    state, metrics = stokes.run(problem, steps=1000)
"""

from tpufem.mesh import Mesh, load_mesh, generate_annulus_mesh
from tpufem.mesh.gridify import Gridified, gridify_mesh
from tpufem.mesh.p2 import p2_refine
from tpufem import ops, bc, platform, solve, transport, diag
from tpufem.config import enable_x64, default_float

__version__ = "0.1.0"

__all__ = [
    "Mesh",
    "load_mesh",
    "generate_annulus_mesh",
    "Gridified",
    "gridify_mesh",
    "p2_refine",
    "ops",
    "bc",
    "platform",
    "solve",
    "transport",
    "diag",
    "enable_x64",
    "default_float",
]
