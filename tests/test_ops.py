"""Operator assembly and discrete-calculus parity vs the NumPy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from baselines import numpy_ref
from tpufem.ops import assembly, calculus
from tpufem.ops.sparse import csr_matvec


@pytest.fixture(scope="module", params=["reference", "generated"])
def any_mesh(request, mesh1, gen_mesh):
    return mesh1 if request.param == "reference" else gen_mesh


def test_stiffness_matches_oracle(any_mesh):
    m = any_mesh
    K = assembly.assemble_dense(m, assembly.element_stiffness(m))
    K_ref = numpy_ref.build_stiffness(m.coords, m.tris, signed=False)
    np.testing.assert_allclose(np.asarray(K), K_ref, atol=1e-10)


def test_stiffness_signed_variant(any_mesh):
    m = any_mesh
    K = assembly.assemble_dense(m, assembly.element_stiffness(m, signed=True))
    K_ref = numpy_ref.build_stiffness(m.coords, m.tris, signed=True)
    np.testing.assert_allclose(np.asarray(K), K_ref, atol=1e-10)


def test_load_vector_matches_oracle(any_mesh):
    m = any_mesh
    g = lambda x, y: 50.0 * np.sin(3.0 * y)
    b = assembly.load_vector(m, lambda x, y: 50.0 * jnp.sin(3.0 * y), signed_area=True)
    b_ref = numpy_ref.build_load(m.coords, m.tris, g, signed_area=True)
    np.testing.assert_allclose(np.asarray(b), b_ref, atol=1e-10)


def test_lumped_mass_matches_oracle(any_mesh):
    m = any_mesh
    ml = assembly.lumped_mass(m)
    ml_ref = numpy_ref.lumped_mass(m.coords, m.tris)
    np.testing.assert_allclose(np.asarray(ml), ml_ref, atol=1e-12)
    # total lumped mass = total area
    np.testing.assert_allclose(float(ml.sum()), m.area.sum(), rtol=1e-12)


def test_divergence_matches_oracle(any_mesh):
    m = any_mesh
    rng = np.random.default_rng(1)
    u = rng.standard_normal((m.n_nodes, 2))
    d = calculus.divergence(m, jnp.asarray(u))
    d_ref = numpy_ref.divergence(m.coords, m.tris, u)
    np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-10)


def test_gradient_matches_oracle(any_mesh):
    m = any_mesh
    rng = np.random.default_rng(2)
    p = rng.standard_normal(m.n_nodes)
    g = calculus.gradient(m, jnp.asarray(p))
    gx, gy = numpy_ref.gradient(m.coords, m.tris, p)
    np.testing.assert_allclose(np.asarray(g[:, 0]), gx, atol=1e-10)
    np.testing.assert_allclose(np.asarray(g[:, 1]), gy, atol=1e-10)


def test_consistent_mass_row_sums(any_mesh):
    """Consistent mass row sums equal the lumped mass (P1 identity)."""
    m = any_mesh
    M = assembly.assemble_dense(m, assembly.element_mass(m))
    ml = assembly.lumped_mass(m)
    np.testing.assert_allclose(np.asarray(M.sum(axis=1)), np.asarray(ml), atol=1e-12)


def test_convection_kills_constants(any_mesh):
    """C(u) @ 1 = Σ_j C_ij: rows of C sum to (area/3)·(ū·Σ∇φ_j) = 0."""
    m = any_mesh
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((m.n_nodes, 2)))
    C = assembly.assemble_dense(m, assembly.element_convection(m, u))
    ones = jnp.ones(m.n_nodes)
    np.testing.assert_allclose(np.asarray(C @ ones), 0.0, atol=1e-10)


def test_csr_matches_dense(any_mesh):
    m = any_mesh
    elem = assembly.element_stiffness(m)
    K = assembly.assemble_dense(m, elem)
    op = assembly.assemble_csr(m, elem)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal(m.n_nodes))
    np.testing.assert_allclose(np.asarray(csr_matvec(op, x)), np.asarray(K @ x), atol=1e-10)
    np.testing.assert_allclose(np.asarray(op.todense()), np.asarray(K), atol=1e-12)


def test_vorticity_of_rigid_rotation(any_mesh):
    """u = ω×r ⇒ vorticity = 2ω everywhere (interior)."""
    m = any_mesh
    omega = 3.0
    r = m.coords - np.array([0.5, 0.5])
    u = jnp.asarray(omega * np.stack([-r[:, 1], r[:, 0]], axis=1))
    w = calculus.vorticity(m, u)
    interior = np.asarray(m.markers) == 0
    np.testing.assert_allclose(np.asarray(w)[interior], 2 * omega, rtol=1e-8)


def test_element_convection_flat_matches_rank3(any_mesh):
    """element_convection_flat (the 1-D k-major per-step form, which
    avoids materializing a rank-3 (T,3,3) tensor per step) carries
    exactly the entries of element_convection:
    flat[k*T + t] == elem[t, k//3, k%3], for both reference scalings."""
    m = any_mesh
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal((m.n_nodes, 2)))
    for variant in ("stokescolor", "opsplit"):
        elem = np.asarray(assembly.element_convection(m, u, variant=variant))
        flat = np.asarray(
            assembly.element_convection_flat(m, u, variant=variant)
        )
        t = m.n_tris
        np.testing.assert_allclose(
            flat.reshape(9, t), elem.reshape(t, 9).T, atol=1e-13
        )


def test_refill_flat_matches_refill():
    """StencilRefill.refill_flat on the k-major
    flat values reproduce refill() on the (T,3,3) tensor.  The two
    convection computations differ by ~1 ulp (einsum contraction vs
    explicit FMA order), so the refilled operators agree to machine
    precision, not bitwise; the GATHER itself is exact (covered by
    feeding refill_flat the reshaped rank-3 values)."""
    import tpufem
    from tpufem.ops.stencil import StencilRefill

    mesh = tpufem.generate_annulus_mesh(n_side=24, n_circle=32,
                                        pad_hole=True)
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((mesh.n_nodes, 2)))
    elem = assembly.element_convection(mesh, u, variant="opsplit")
    flat = assembly.element_convection_flat(mesh, u, variant="opsplit")
    t = mesh.n_tris
    # exact-gather check: same values through both index paths
    flat_of_elem = jnp.asarray(
        np.asarray(elem).reshape(t, 9).T.reshape(-1)
    )

    sr = StencilRefill.build(mesh, dtype=jnp.float64)
    a = sr.refill(elem)
    b = sr.refill_flat(flat)
    c = sr.refill_flat(flat_of_elem)
    np.testing.assert_array_equal(np.asarray(a.diags), np.asarray(c.diags))
    np.testing.assert_array_equal(np.asarray(a.rest_data),
                                  np.asarray(c.rest_data))
    np.testing.assert_allclose(np.asarray(a.diags), np.asarray(b.diags),
                               rtol=1e-13, atol=1e-17)
    np.testing.assert_allclose(np.asarray(a.rest_data),
                               np.asarray(b.rest_data),
                               rtol=1e-13, atol=1e-17)
