"""The backend → implementation choice (``tpufem.platform``), f32 product
precision on the step paths, and the compile-cache location.

The GPU choice is checked here on the CPU by injecting the backend string:
every workload must land on its XLA stencil/banded/CSR path, never on a
Pallas kernel.
"""

import os

import jax
import jax.extend as jex
import jax.numpy as jnp
import numpy as np
import pytest

import tpufem
from tpufem import platform
from tpufem.ops.banded import BandedOperator
from tpufem.ops.sparse import CSROperator
from tpufem.ops.stencil import StencilOperator
from tpufem.workloads import stokes


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(platform, "backend", lambda: "gpu")


def _sub_jaxprs(params):
    for v in params.values():
        vs = v if isinstance(v, (list, tuple)) else [v]
        for x in vs:
            if isinstance(x, jex.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex.core.Jaxpr):
                yield x


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for sub in _sub_jaxprs(eqn.params):
            yield from _eqns(sub)


def _primitives(fn, *args):
    return list(_eqns(jax.make_jaxpr(fn)(*args).jaxpr))


def _assert_f32_dots_highest(eqns):
    hi = jax.lax.Precision.HIGHEST
    dots = [e for e in eqns if e.primitive.name == "dot_general"
            and all(v.aval.dtype == jnp.float32 for v in e.invars)]
    assert dots, "expected f32 products on the step path"
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(p == hi for p in prec), (
            f"f32 dot_general without HIGHEST precision: {e}"
        )
    assert not [e for e in eqns if "pallas" in e.primitive.name]


def _stokes_choice():
    mesh = tpufem.generate_annulus_mesh(n_side=20, n_circle=24, pad_hole=True)
    p = stokes.StokesProblem.build(mesh, stokes.StokesConfig(
        solver="cg", precision="f32", cg_precond="twolevel",
        transport="none", cg_tol_pressure=1e-5))
    return [p.visc_solver.K, p.pressure_solver.K_merged, p.mf_dx, p.mf_dy]


def _ns_choice():
    from tpufem.workloads import navier_stokes as ns

    mesh = tpufem.generate_annulus_mesh(n_side=20, n_circle=24, pad_hole=True)
    p = ns.NSProblem.build(mesh, ns.NSConfig(solver="cg", precision="f32"))
    u, _ = ns.run(p, steps=2)
    assert np.isfinite(np.asarray(u)).all()
    return [p.K_csr, p.pressure_solver.K_merged]


def _th_choice():
    from tpufem.mesh.p2 import p2_refine
    from tpufem.workloads import th_sparse

    mesh = p2_refine(tpufem.generate_annulus_mesh(n_side=8, n_circle=12),
                     snap_center=(0.5, 0.5), snap_radius=0.25)
    p = th_sparse.SparseTHProblem.build(
        mesh, th_sparse.SparseTHConfig(iters_inner=10, iters_outer=5,
                                       iters_plap=4))
    u, _, _ = th_sparse.run(p, steps=1)
    assert np.isfinite(np.asarray(u)).all()
    return [p.K2, p.M2, p.Bx, p.Kp]


@pytest.mark.parametrize(
    "workload, build, allowed",
    [
        ("stokes", _stokes_choice, (StencilOperator,)),
        ("navier_stokes", _ns_choice, (StencilOperator,)),
        ("taylor_hood", _th_choice, (CSROperator,)),
    ],
)
def test_gpu_backend_picks_xla_operators(on_gpu, workload, build, allowed):
    """With the backend reported as "gpu", each workload builds its XLA
    stencil/CSR operators (pad_hole meshes are stencil-covered)."""
    assert platform.backend() == "gpu"
    for op in build():
        assert isinstance(op, allowed), (workload, type(op).__name__)


def test_stokes_storage_resolution(monkeypatch):
    monkeypatch.setattr(platform, "backend", lambda: "cpu")
    assert platform.stokes_storage("auto") == "csr"
    monkeypatch.setattr(platform, "backend", lambda: "gpu")
    assert platform.stokes_storage("auto") == "accel"
    for s in ("csr", "banded", "stencil"):
        assert platform.stokes_storage(s) == s
    for s in ("grid", "accel"):
        with pytest.raises(ValueError, match=s):
            platform.stokes_storage(s)


def test_cpu_backend_keeps_csr():
    """On the CPU the auto storage stays CSR (gather/segment-sum)."""
    assert platform.backend() == "cpu"
    ops = _stokes_choice()
    assert all(isinstance(op, CSROperator) for op in ops)


def test_gpu_banded_fallback_on_unstructured_numbering(on_gpu):
    mesh = tpufem.generate_annulus_mesh(n_side=20, n_circle=24)
    p = stokes.StokesProblem.build(mesh, stokes.StokesConfig(
        solver="cg", precision="f32", transport="none"))
    assert isinstance(p.visc_solver.K, BandedOperator)


@pytest.mark.parametrize("path", ["fused", "matfree"])
def test_step_f32_products_run_at_highest_precision(path):
    """Every f32 dot_general in the jitted step carries HIGHEST precision
    (the GPU's default would round operands to TF32).  The bf16 coarse
    inverse is the one deliberate exception and is not an f32 product."""
    mesh = tpufem.generate_annulus_mesh(n_side=12, n_circle=16, pad_hole=True)
    if path == "fused":
        cfg = stokes.StokesConfig(
            dt=0.01, nu=1.0, solver="inverse", precision="f32",
            pressure_mode="merge", fused=True, transport="tracers",
            tracer_density=10)
    else:
        cfg = stokes.StokesConfig(
            dt=0.01, nu=1.0, solver="cg", precision="f32",
            cg_storage="stencil", cg_precond="twolevel", cg_tol_pressure=1e-5,
            cg_tol_visc=1e-5, transport="dye")
    prob = stokes.StokesProblem.build(mesh, cfg)
    step = stokes.make_step(prob)
    eqns = _primitives(lambda s: step(s, None), stokes.initial_state(prob))
    _assert_f32_dots_highest(eqns)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from tpufem import bench_large

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bench_large.compile_cache_dir() == str(tmp_path)
    bench_large.enable_compile_cache()
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from tpufem import bench_large

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert bench_large.compile_cache_dir() == want
    bench_large.enable_compile_cache()
    assert ("jax_compilation_cache_dir", want) in calls
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
