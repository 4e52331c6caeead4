"""Tests that need the GPU (marker ``gpu``; they skip elsewhere).

Run on the card by ``python chip_smoke.py`` (phase 5) or
``TPUFEM_TESTS_KEEP_PLATFORM=1 python -m pytest -m gpu tests/test_gpu.py``.
Keep every ``gpu`` test in this file: the machine with the card lacks
some of the other test modules' imports (matplotlib).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpufem
from tpufem import platform
from tpufem.ops.stencil import StencilOperator
from tpufem.workloads import stokes

pytestmark = pytest.mark.gpu


def test_auto_storage_is_stencil_on_the_card(gpu_device):
    assert platform.backend() == "gpu"
    mesh = tpufem.generate_annulus_mesh(n_side=40, n_circle=48, pad_hole=True)
    p = stokes.StokesProblem.build(mesh, stokes.StokesConfig(
        solver="cg", precision="f32", transport="none"))
    assert isinstance(p.visc_solver.K, StencilOperator)
    assert isinstance(p.pressure_solver.K_merged, StencilOperator)


def test_fused_matvec_keeps_f32_accuracy(gpu_device):
    """The fused-step matvec on the card agrees with an f64 host product
    to f32 rounding (TF32 operands would leave ~1e-3 relative error)."""
    mesh = tpufem.generate_annulus_mesh(n_side=33, n_circle=48)
    p = stokes.StokesProblem.build(mesh, stokes.StokesConfig(
        dt=0.01, nu=1.0, solver="inverse", precision="f32",
        pressure_mode="merge", fused=True))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(p.fused_M.shape[0]).astype(np.float32)
    y = np.asarray(jax.jit(stokes._mv)(p.fused_M, jnp.asarray(x)))
    ref = np.asarray(p.fused_M, np.float64) @ x.astype(np.float64)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


def test_f32_cg_step_tracks_f64_on_the_card(gpu_device):
    """Five matrix-free steps in f32 (stencil) against f64 (CSR) on the
    card, at the CG tolerance that sets the gap."""
    from tpufem import bench_large

    runs = {}
    for prec, storage in (("f32", "auto"), ("f64", "csr")):
        _, _, prob, _ = bench_large.build_one(
            80, 96, storage=storage, precision=prec, cg_coarse_dtype="same")
        st, _ = stokes.run(prob, steps=5)
        runs[prec] = np.asarray(st["u"], np.float64)
    err = np.linalg.norm(runs["f32"] - runs["f64"]) / np.linalg.norm(runs["f64"])
    assert err < 1e-3, err
