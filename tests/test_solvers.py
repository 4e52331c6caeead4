"""Linear solver tests: dense LU / inverse caches and CG variants."""

import jax.numpy as jnp
import numpy as np

from tpufem.ops import assembly
from tpufem.solve import DenseLU, DenseInverse, cg, cg_fixed, jacobi_pcg


def _spd_system(mesh):
    K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh))
    n = mesh.n_nodes
    A = K + jnp.eye(n)  # shifted Laplacian: SPD, well-conditioned
    rng = np.random.default_rng(0)
    x_true = jnp.asarray(rng.standard_normal(n))
    return A, x_true, A @ x_true


def test_dense_lu(mesh1):
    A, x_true, b = _spd_system(mesh1)
    solver = DenseLU.factor(A)
    np.testing.assert_allclose(np.asarray(solver.solve(b)), np.asarray(x_true), atol=1e-9)


def test_dense_inverse(mesh1):
    A, x_true, b = _spd_system(mesh1)
    solver = DenseInverse.factor(A)
    np.testing.assert_allclose(np.asarray(solver.solve(b)), np.asarray(x_true), atol=1e-7)


def test_cg(mesh1):
    A, x_true, b = _spd_system(mesh1)
    x, (iters, res) = cg(lambda v: A @ v, b, tol=1e-12, maxiter=2000)
    assert float(res) < 1e-9
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true), atol=1e-7)


def test_jacobi_pcg_converges_faster(mesh1):
    A, x_true, b = _spd_system(mesh1)
    _, (it_plain, _) = cg(lambda v: A @ v, b, tol=1e-10, maxiter=2000)
    _, (it_pcg, _) = jacobi_pcg(lambda v: A @ v, jnp.diag(A), b, tol=1e-10, maxiter=2000)
    assert int(it_pcg) <= int(it_plain)


def test_cg_fixed(mesh1):
    A, x_true, b = _spd_system(mesh1)
    x, res = cg_fixed(lambda v: A @ v, b, iters=400)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true), atol=1e-6)


def test_cg_deflated_singular_laplacian(mesh1):
    """Pure-Neumann Laplacian is singular (constants); deflated CG solves
    the compatible system — the penalty-free pressure path (SURVEY §7.3)."""
    K = assembly.assemble_dense(mesh1, assembly.element_stiffness(mesh1))
    rng = np.random.default_rng(1)
    x_true = jnp.asarray(rng.standard_normal(mesh1.n_nodes))
    x_true = x_true - jnp.mean(x_true)
    b = K @ x_true
    x, (iters, res) = cg(lambda v: K @ v, b, tol=1e-12, maxiter=4000, deflate=True)
    np.testing.assert_allclose(np.asarray(x - jnp.mean(x)), np.asarray(x_true), atol=1e-6)


def test_cg_deflated_preconditioned_matches_cg_fixed(mesh1):
    """Deflated+preconditioned cg() must project the preconditioned direction
    exactly like cg_fixed: on the singular Neumann
    Laplacian, an unprojected z lets nullspace roundoff blow up alpha."""
    K = assembly.assemble_dense(mesh1, assembly.element_stiffness(mesh1))
    diag = jnp.diag(K)
    inv_diag = jnp.where(diag != 0, 1.0 / diag, 1.0)
    precond = lambda r: inv_diag * r
    rng = np.random.default_rng(2)
    x_true = jnp.asarray(rng.standard_normal(mesh1.n_nodes))
    x_true = x_true - jnp.mean(x_true)
    b = K @ x_true
    x_w, (iters, res) = cg(
        lambda v: K @ v, b, tol=1e-12, maxiter=4000, deflate=True, precond=precond
    )
    x_f, res_f = cg_fixed(
        lambda v: K @ v, b, iters=int(iters), deflate=True, precond=precond
    )
    assert float(res) < 1e-8
    np.testing.assert_allclose(
        np.asarray(x_w - jnp.mean(x_w)), np.asarray(x_true), atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(x_w), np.asarray(x_f), atol=1e-8)
