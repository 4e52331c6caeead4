"""Space-sharded matrix-free Stokes step: ONE large mesh across chips.

Complements parallel/spmd.py (which shards an *ensemble* over "data" and
dense operators over "space"): here a single large simulation is
decomposed for the matrix-free regime —

* viscous + pressure solves: halo-exchange banded CG (parallel/halo.py;
  ppermute of O(bandwidth) strips, psum dot products),
* divergence/gradient: element slabs sharded over "space", partial nodal
  scatter sums psum-reduced,
* BC field surgery and transport-free bookkeeping: O(N) replicated.

Physics identical to workloads/stokes.projection_step (color variant,
merged periodic pressure); verified against the single-device CG path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P

from tpufem import bc
from tpufem.parallel.halo import make_halo_pressure_solver, make_halo_viscous_solver
from tpufem.parallel.spmd import _div_local, _grad_local, _shard_elements
from tpufem.workloads import stokes


def make_sharded_matfree_step(device_mesh: DeviceMesh, problem, axis: str = "space"):
    """Build a jitted u → (u', metrics) step sharded over ``axis``.

    ``problem`` must be built with solver="cg" and banded or stencil
    storage: banded halos exchange O(bandwidth) strips
    (parallel/halo.py); stencil halos exchange O(max-offset) strips plus
    a tiny remainder gather and keep the distributed SpMV O(nnz)
    (parallel/halo_stencil.py).  The halo exchanges are ``ppermute``s,
    which XLA lowers to NCCL on the GPU.
    """
    from tpufem.ops.banded import BandedOperator
    from tpufem.ops.stencil import StencilOperator
    from tpufem.parallel.halo_stencil import (
        make_stencil_halo_pressure_solver,
        make_stencil_halo_viscous_solver,
    )

    cfg = problem.config
    mesh = problem.mesh
    vs = problem.visc_solver
    ps = problem.pressure_solver
    assert isinstance(vs.K, (BandedOperator, StencilOperator)), (
        "requires cg_storage='banded' or 'stencil'"
    )
    s = device_mesh.shape[axis]
    dt = cfg.dt
    n = mesh.n_nodes

    if isinstance(vs.K, StencilOperator):
        visc_solve = make_stencil_halo_viscous_solver(
            device_mesh, vs.K, np.asarray(vs.interior_mask), vs.dt_nu,
            iters=vs.iters, axis=axis,
        )
        press_solve = make_stencil_halo_pressure_solver(
            device_mesh, ps.K_merged, ps.m_lumped, ps.masters, ps.slaves,
            np.asarray(ps.active_mask), iters=ps.iters, axis=axis,
        )
    else:
        visc_solve = make_halo_viscous_solver(
            device_mesh, vs.K, np.asarray(vs.interior_mask), vs.dt_nu,
            iters=vs.iters, axis=axis,
        )
        press_solve = make_halo_pressure_solver(
            device_mesh, ps.K_merged, ps.m_lumped, ps.masters, ps.slaves,
            np.asarray(ps.active_mask), iters=ps.iters, axis=axis,
        )

    tris_sh, grads_sh, area_sh, valid_sh = _shard_elements(mesh, s)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _divgrad_sums(tris_l, grads_l, area_l, valid_l, field):
        """Element-sharded partial scatter sums, psum-assembled; returns
        replicated (num, den).  ``field`` (N,2) → divergence sums, or
        (N,1)-shaped pressure handled by caller via _grad."""
        num, den = _div_local(
            tris_l[0], grads_l[0], area_l[0], valid_l[0], field[None], n
        )
        return jax.lax.psum(num[0], axis), jax.lax.psum(den, axis)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _gradsums(tris_l, grads_l, area_l, valid_l, p):
        num, den = _grad_local(
            tris_l[0], grads_l[0], area_l[0], valid_l[0], p[None], n
        )
        return jax.lax.psum(num[0], axis), jax.lax.psum(den, axis)

    tris_j = jnp.asarray(tris_sh).reshape(s, -1, 3)
    grads_j = jnp.asarray(grads_sh).reshape(s, -1, 3, 2)
    area_j = jnp.asarray(area_sh).reshape(s, -1)
    valid_j = jnp.asarray(valid_sh).reshape(s, -1)

    def div(u):
        num, den = _divgrad_sums(tris_j, grads_j.astype(u.dtype),
                                 area_j.astype(u.dtype),
                                 valid_j.astype(u.dtype), u)
        return num / (den + 1e-12)

    def grad(p):
        num, den = _gradsums(tris_j, grads_j.astype(p.dtype),
                             area_j.astype(p.dtype),
                             valid_j.astype(p.dtype), p)
        return num / (den + 1e-12)[:, None]

    # 0/1 indicator instead of an index list: the scatter-add form is an
    # O(N) gather+scatter per step (see stokes.projection_step)
    imask_np = np.ones(problem.mesh.n_nodes)
    imask_np[problem.boundary.dirichlet] = 0.0
    imask = jnp.asarray(imask_np, dtype=problem.dtype)

    def apply_bcs(u):
        return stokes.apply_field_bcs(problem, u)

    @jax.jit
    def step(u):
        rhs = u + dt * jnp.asarray(cfg.body_force, dtype=u.dtype)
        u_star = apply_bcs(visc_solve(rhs))
        div_star = div(u_star)
        p = press_solve(-div_star / dt)
        u_new = apply_bcs(u_star - dt * grad(p))
        if cfg.double_projection:
            p2 = press_solve(-div(u_new) / dt)
            g2 = grad(p2)
            u_new = u_new - dt * g2 * imask[:, None]
        final_div = div(u_new)
        metrics = {
            "div_star_max": jnp.max(jnp.abs(div_star)),
            "final_div_max": jnp.max(jnp.abs(final_div)),
            "max_u": jnp.max(jnp.abs(u_new)),
        }
        return u_new, metrics

    return step
