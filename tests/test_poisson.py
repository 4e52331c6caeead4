"""Poisson workload parity vs the NumPy oracle (reference pipeline)."""

import numpy as np

from baselines import numpy_ref
from tpufem.workloads import poisson


def test_poisson_parity_mesh1(mesh1):
    f, residual = poisson.solve(mesh1)
    f_ref, A_ref, b_ref = numpy_ref.poisson_solve(mesh1.coords, mesh1.tris, mesh1.markers)
    assert float(residual) < 1e-8
    l2 = np.linalg.norm(np.asarray(f) - f_ref) / np.linalg.norm(f_ref)
    assert l2 < 1e-8


def test_poisson_parity_mesh21(mesh21):
    f, residual = poisson.solve(mesh21)
    f_ref, _, _ = numpy_ref.poisson_solve(mesh21.coords, mesh21.tris, mesh21.markers)
    l2 = np.linalg.norm(np.asarray(f) - f_ref) / np.linalg.norm(f_ref)
    assert l2 < 1e-8


def test_poisson_system_matches_oracle(mesh21):
    A, b, _ = poisson.build_system(mesh21)
    _, A_ref, b_ref = numpy_ref.poisson_solve(mesh21.coords, mesh21.tris, mesh21.markers)
    np.testing.assert_allclose(np.asarray(A), A_ref, atol=1e-9)
    np.testing.assert_allclose(np.asarray(b), b_ref, atol=1e-9)


def test_poisson_boundary_values_enforced(mesh1):
    f, _ = poisson.solve(mesh1)
    f = np.asarray(f)
    cfg = poisson.PoissonConfig()
    walls = np.isclose(mesh1.coords[:, 1], 0.0) | np.isclose(mesh1.coords[:, 1], 1.0)
    inner = mesh1.markers == cfg.inner_marker
    np.testing.assert_allclose(f[inner], cfg.inner_value, atol=1e-10)
    np.testing.assert_allclose(f[walls & ~inner], cfg.outer_value, atol=1e-10)


def test_poisson_periodicity(mesh1):
    from tpufem import bc

    f, _ = poisson.solve(mesh1)
    f = np.asarray(f)
    masters, slaves = bc.find_periodic_pairs(mesh1.coords)
    np.testing.assert_allclose(f[masters], f[slaves], atol=1e-9)


def test_poisson_generated_mesh(gen_mesh):
    """Standalone path: solve on a generated mesh, check residual + BCs."""
    f, residual = poisson.solve(gen_mesh)
    assert float(residual) < 1e-8
    assert np.isfinite(np.asarray(f)).all()


def test_poisson_cg_matches_dense_on_generated_mesh():
    """solver='cg' (matrix-free BiCGStab on the exact bc_surgery_csr
    operator) reproduces the dense-LU solution to solver tolerance —
    the ≥100k-node path (reference meshes cap at 1067 nodes)."""
    import tpufem
    from tpufem.workloads import poisson

    m = tpufem.generate_annulus_mesh(n_side=32, n_circle=32)
    fd, _ = poisson.solve(m, poisson.PoissonConfig(solver="lu"))
    fc, rc = poisson.solve(m, poisson.PoissonConfig(solver="cg"))
    np.testing.assert_allclose(np.asarray(fd), np.asarray(fc), atol=1e-8)
    assert float(rc) < 1e-8


def test_poisson_cg_refuses_noninjective_periodic_pairs():
    """A duplicated periodic pair (two x≈0 nodes sharing an x≈L partner,
    as on the reference's mesh2.1) needs the dense path's sequential
    elimination semantics — the CSR surgery refuses instead of silently
    diverging.  The mesh is a generated one with its right edge nudged
    into exactly that configuration."""
    import pytest
    import tpufem
    from tpufem import bc
    from tpufem.mesh.core import mesh_from_arrays
    from tpufem.workloads import poisson

    base = tpufem.generate_annulus_mesh(n_side=12, n_circle=16)
    coords = np.array(base.coords)
    right = np.nonzero(np.abs(coords[:, 0] - 1.0) < 1e-9)[0]
    right = right[np.argsort(coords[right, 1])]
    h = float(np.diff(coords[right, 1]).min())
    j, k = right[4], right[5]
    coords[j, 1] += 0.1 * h  # right node j drifts up ...
    coords[k, 0] -= 0.3 * h  # ... and its upper neighbour leaves the edge
    mesh = mesh_from_arrays(coords, np.asarray(base.tris), base.markers)
    masters, slaves = bc.find_periodic_pairs(mesh.coords)
    assert len(set(slaves.tolist())) < len(slaves)  # j has two masters
    with pytest.raises(AssertionError, match="injective"):
        poisson.solve(mesh, poisson.PoissonConfig(solver="cg"))


def test_bc_surgery_csr_equals_dense_surgery():
    """bc_surgery_csr reproduces periodic_elimination + dirichlet_rows
    ENTRY-FOR-ENTRY on an injective-pair mesh."""
    import jax.numpy as jnp
    import tpufem
    from tpufem import bc
    from tpufem.ops import assembly
    from tpufem.workloads import poisson

    mesh = tpufem.generate_annulus_mesh(n_side=24, n_circle=24)
    cfg_ = poisson.PoissonConfig()
    A, b, boundary = poisson.build_system(mesh, cfg_)
    K = assembly.assemble_csr(
        mesh, assembly.element_stiffness(mesh, signed=True)
    )
    b0 = assembly.load_vector(mesh, cfg_.g_source, signed_area=True,
                              negate=True)
    K_mod, b_mod = bc.bc_surgery_csr(
        K, boundary.masters, boundary.slaves, boundary.dirichlet, b=b0
    )
    values = np.full(len(boundary.dirichlet), cfg_.outer_value)
    inner = set(boundary.inner.tolist())
    for i, node in enumerate(boundary.dirichlet):
        if int(node) in inner:
            values[i] = cfg_.inner_value
    b_mod = b_mod.at[jnp.asarray(boundary.dirichlet)].set(
        jnp.asarray(values)
    )
    np.testing.assert_array_equal(
        np.asarray(K_mod.todense()), np.asarray(A)
    )
    np.testing.assert_array_equal(np.asarray(b_mod), np.asarray(b))
