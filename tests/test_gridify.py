"""Grid renumbering of arbitrary meshes (``tpufem/mesh/gridify.py``),
validated on the reference's own ``mesh_fine.1`` (the largest bundled
asset), plus the storage choice on square-N meshes whose numbering is
not grid-structured.
"""

import numpy as np
import pytest

import tpufem
from tpufem.mesh.gridify import (
    Gridified,
    ensure_grid_numbering,
    grid_numbering_ok,
    gridify_mesh,
)
from tpufem.workloads import stokes

from tests.conftest import reference_mesh


@pytest.fixture(scope="module")
def mesh_fine():
    return reference_mesh("mesh_fine.1")


def test_permutation_is_bijective_and_geometry_preserved(mesh_fine):
    g = gridify_mesh(mesh_fine)
    n = mesh_fine.n_nodes
    assert g.mesh.n_nodes == g.ns * g.ns >= n
    assert len(np.unique(g.perm)) == n
    # real nodes keep coords/markers; triangles carry identical geometry
    assert np.array_equal(g.mesh.coords[g.perm], mesh_fine.coords)
    assert np.array_equal(g.mesh.markers[g.perm], mesh_fine.markers)
    np.testing.assert_allclose(
        np.sort(g.mesh.area), np.sort(mesh_fine.area), rtol=1e-12
    )
    # dummy slots: marker −1, strictly interior coords, no incident tris
    dummy = np.ones(g.mesh.n_nodes, dtype=bool)
    dummy[g.perm] = False
    assert (g.mesh.markers[dummy] == -1).all()
    dc = g.mesh.coords[dummy]
    assert (dc > 1e-3).all() and (dc < 1 - 1e-3).all()
    assert not np.isin(g.mesh.tris, np.nonzero(dummy)[0]).any()


def test_periodic_pairs_on_opposite_grid_rows(mesh_fine):
    from tpufem import bc

    g = gridify_mesh(mesh_fine)
    masters, slaves = bc.find_periodic_pairs(g.mesh.coords)
    assert len(masters) > 0
    mi, mj = np.divmod(np.asarray(masters), g.ns)
    si, sj = np.divmod(np.asarray(slaves), g.ns)
    assert (mi == 0).all() and (si == g.ns - 1).all()
    assert np.array_equal(mj, sj)


def test_numbering_check_and_passthrough(mesh_fine):
    # pad_hole generated meshes are already grid-structured → pass-through
    gen = tpufem.generate_annulus_mesh(n_side=20, n_circle=24, pad_hole=True)
    assert grid_numbering_ok(gen)
    m2, g2 = ensure_grid_numbering(gen)
    assert m2 is gen and g2 is None
    # imported Triangle meshes are not → renumbered
    assert not grid_numbering_ok(mesh_fine)
    m3, g3 = ensure_grid_numbering(mesh_fine)
    assert isinstance(g3, Gridified) and m3.n_nodes == g3.ns * g3.ns


def test_auto_storage_falls_back_on_square_nongrid_mesh(monkeypatch):
    """On the GPU, a square-node-count mesh with non-grid numbering must
    fall back from the stencil operator to banded storage on the auto
    path, not crash."""
    from tpufem import platform
    from tpufem.mesh.core import mesh_from_arrays
    from tpufem.ops.banded import BandedOperator

    base = tpufem.generate_annulus_mesh(n_side=20, n_circle=24, pad_hole=True)
    rng = np.random.default_rng(3)
    perm = rng.permutation(base.n_nodes)  # scramble: square N, non-grid ids
    coords = np.empty_like(base.coords)
    markers = np.empty_like(base.markers)
    coords[perm] = base.coords
    markers[perm] = base.markers
    mesh = mesh_from_arrays(coords, perm[base.tris].astype(np.int32), markers)
    cfgs = stokes.StokesConfig(
        solver="cg", cg_storage="auto", precision="f32", transport="none"
    )
    monkeypatch.setattr(platform, "backend", lambda: "gpu")
    p = stokes.StokesProblem.build(mesh, cfgs)  # must not raise
    assert isinstance(p.visc_solver.K, BandedOperator)
    assert isinstance(p.pressure_solver.K_merged, BandedOperator)


def test_ring_slot_overflow_raises_clear_error():
    """n_circle exceeding the hole-interior slots must fail
    with an actionable message, not an argmin-of-empty crash."""
    with pytest.raises(ValueError, match="n_circle"):
        tpufem.generate_annulus_mesh(n_side=12, n_circle=64, pad_hole=True)
