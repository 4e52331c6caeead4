"""Convergence-study machinery (``tpufem/convergence.py``) + P2 refine.

The full studies are long runs (``python -m tpufem converge``); these
tests validate the machinery at toy sizes and the P1→P2 refinement against the reference's own bought
P2 mesh (``mesh2.2`` = P2 of ``mesh2.1``'s triangulation).
"""

import numpy as np
import pytest

import tpufem
from tpufem.mesh.p2 import p2_refine

from tests.conftest import reference_mesh


def test_p2_refine_matches_reference_p2_mesh(mesh21):
    """p2_refine(mesh2.1) reproduces mesh2.2's P2 structure: same corner
    set per element, midpoints at the same coordinates (matched as sets —
    Triangle's midside numbering differs)."""
    m22 = reference_mesh("mesh2.2")
    ours = p2_refine(mesh21)
    assert ours.tris_p2.shape == m22.tris_p2.shape == (450, 6)
    assert ours.coords.shape[0] == m22.coords.shape[0] == 1004
    # corner node ids are shared (identical coords); element ORDER is not —
    # match elements by corner-id sets, then midside coords must agree
    np.testing.assert_allclose(m22.coords[: mesh21.n_nodes], mesh21.coords)
    by_corners = {
        frozenset(map(int, row[:3])): row for row in m22.tris_p2
    }
    for t in range(0, 450, 37):
        row = by_corners[frozenset(map(int, ours.tris_p2[t, :3]))]
        a = ours.coords[ours.tris_p2[t, 3:]]
        b = m22.coords[row[3:]]
        np.testing.assert_allclose(
            np.sort(a, axis=0), np.sort(b, axis=0), atol=1e-12
        )


def test_p2_refine_markers_and_snap():
    mesh = tpufem.generate_annulus_mesh(n_side=16, n_circle=24)
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    mids = slice(mesh.n_nodes, None)
    ring_mids = np.nonzero(m2.markers[mids] == 2)[0] + mesh.n_nodes
    assert len(ring_mids) == 24  # one midpoint per ring segment
    r = np.hypot(m2.coords[ring_mids, 0] - 0.5, m2.coords[ring_mids, 1] - 0.5)
    np.testing.assert_allclose(r, 0.25, atol=1e-12)
    # interior chords between two marked nodes stay unmarked
    tris = m2.tris_p2
    assert (m2.markers >= -1).all()


def test_probe_points_deterministic_and_in_annulus():
    from tpufem.convergence import probe_points

    a = probe_points(200)
    b = probe_points(200)
    np.testing.assert_array_equal(a, b)
    r = np.hypot(a[:, 0] - 0.5, a[:, 1] - 0.5)
    assert (r > 0.33).all()
    assert (a > 0.08 - 1e-12).all() and (a < 0.92 + 1e-12).all()


def test_self_study_machinery_toy():
    """Two toy rungs through the full pipeline (no monotonicity assert —
    T is too short at toy sizes for that; the committed artifact uses the
    real ladder)."""
    from tpufem import convergence

    rows = convergence.run_self(
        sizes=[("a", 24, 24), ("b", 40, 48)], steps0=30, check=False
    )
    assert len(rows) == 2
    assert rows[0]["err_vs_finest"] > rows[1]["err_vs_finest"] == 0.0
    assert all(np.isfinite(r["div_rel"]) for r in rows)


def test_th_study_machinery_toy_with_sparse_reference(monkeypatch):
    """run_th through both reference branches: forcing the dense ceiling
    to 100 dofs makes every rung use th_sparse.steady_solve (the
    beyond-dense-ceiling path of the --extended study)."""
    from tpufem import convergence

    monkeypatch.setattr(convergence, "DENSE_TH_DOF_CEIL", 100)
    rows = convergence.run_th(
        sizes=[("a", 16, 24), ("b", 24, 32)], steps0=30, check=False
    )
    assert len(rows) == 2
    assert all(np.isfinite(r["err_vs_taylor_hood"]) for r in rows)


def test_ns_study_machinery_toy():
    """run_ns_conv (the NS accuracy ladder) through two toy
    rungs: finite errors, finest self-error 0, div_rel populated."""
    from tpufem import convergence

    rows = convergence.run_ns_conv(
        sizes=[("a", 24, 24), ("b", 40, 48)], steps0=20, check=False
    )
    assert len(rows) == 2
    assert rows[0]["err_vs_finest"] > rows[1]["err_vs_finest"] == 0.0
    assert all(np.isfinite(r["div_rel"]) for r in rows)
