"""Test configuration: CPU backend with 8 virtual devices, float64.

Tests run on the CPU backend with ``xla_force_host_platform_device_count=8``
so the multi-device sharding tests exercise a real 8-device mesh, and the
tolerances are those of the CPU backend's f64 arithmetic.

Tests marked ``gpu`` need the card; they take the ``gpu_device`` fixture,
which skips when JAX's first device is not a GPU.  To run them on a GPU
machine set ``TPUFEM_TESTS_KEEP_PLATFORM=1`` (``chip_smoke.py`` does so
for its in-process run), which leaves the platform JAX chose instead of
switching to the CPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("TPUFEM_TESTS_KEEP_PLATFORM"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tpufem import config as tpufem_config  # noqa: E402
from tpufem.mesh import load_mesh, generate_annulus_mesh  # noqa: E402


def reference_mesh(name: str):
    stem = tpufem_config.reference_mesh_path(name)
    if stem is None:
        pytest.skip(f"reference mesh {name} not available")
    return load_mesh(stem)


@pytest.fixture
def gpu_device():
    """The GPU a ``gpu``-marked test runs on; skips without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def mesh1():
    """The reference's flagship mesh (331 nodes / 522 tris)."""
    return reference_mesh("mesh.1")


@pytest.fixture(scope="session")
def mesh21():
    """mesh2.1 (277 nodes / 450 tris) — Poisson/heat parity mesh."""
    return reference_mesh("mesh2.1")


@pytest.fixture(scope="session")
def mesh_fine():
    """mesh_fine.1 (1067 nodes / 1734 tris) — the benchmark mesh."""
    return reference_mesh("mesh_fine.1")


@pytest.fixture(scope="session")
def gen_mesh():
    """Generated annulus mesh — exercises the standalone path."""
    return generate_annulus_mesh(n_side=20, n_circle=24)


@pytest.fixture(scope="session")
def mesh5():
    """mesh5.1 (331 nodes / 522 tris) — the report/rotating-cylinder mesh."""
    return reference_mesh("mesh5.1")


def pytest_collection_modifyitems(config, items):
    """Two-tier gate: mark measured-slow tests so ``pytest -m "not slow"``
    is a fast whole-surface smoke gate while the full suite stays the
    merge gate.  Registry: tests/slow_list.py."""
    from tests.slow_list import SLOW_TESTS

    for item in items:
        base = f"{item.fspath.basename}::{item.name.split('[')[0]}"
        if base in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
