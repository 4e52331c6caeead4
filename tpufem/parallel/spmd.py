"""Multi-chip SPMD execution: ensemble ("data") × operator ("space") sharding.

The reference is strictly single-threaded (SURVEY.md §2, parallelism note);
the scaling axes for this workload are:

* **data** — an *ensemble* of independent simulations (the reference's
  actual scientific campaign: sweeping squirmer gaits B1/B2 across runs,
  README.md:43-45).  Batched with ``vmap``, sharded across chips.
* **space** — within one simulation, the dense solve operators are
  row-block sharded (tensor-parallel matvec: each chip computes its row
  block of A⁻¹ @ x, then ``all_gather`` along "space" reassembles the
  field over ICI), and the element arrays of the divergence/gradient
  pipelines are block-sharded with a ``psum`` reduction of the scattered
  nodal sums — the PDE analog of TP + sequence-parallel sharding.

Everything is expressed with ``shard_map`` over a ``jax.sharding.Mesh``
so XLA inserts the collectives; no hand-written communication.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P
from jax import shard_map

from tpufem import bc, transport
from tpufem.mesh.core import Mesh
from tpufem.ops import assembly
from tpufem.solve import DenseInverse
from tpufem.workloads import stokes

# f32 products at full precision (the GPU default rounds operands to TF32)
_HI = jax.lax.Precision.HIGHEST


def build_device_mesh(n_devices: int | None = None, data: int | None = None):
    """A ("data", "space") device mesh over the available devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = np.asarray(devices[:n])
    if data is None:
        data = 2 if n % 2 == 0 and n > 1 else 1
    space = n // data
    return DeviceMesh(devices.reshape(data, space), ("data", "space"))


def _pad_rows(A: np.ndarray, mult: int) -> np.ndarray:
    """Pad a matrix with zero rows to a row-count divisible by ``mult``."""
    n = A.shape[0]
    pad = (-n) % mult
    if pad:
        A = np.concatenate([A, np.zeros((pad,) + A.shape[1:], dtype=A.dtype)], axis=0)
    return A


@dataclasses.dataclass(frozen=True)
class ShardedEnsemble:
    """A batch of squirmer simulations prepared for a (data, space) mesh.

    The per-simulation physics is identical to
    :func:`tpufem.workloads.stokes.projection_step`; what differs is the
    execution layout: batched state, row-sharded inverse operators,
    element-sharded div/grad.
    """

    problem: stokes.StokesProblem
    device_mesh: DeviceMesh
    inner_values: jnp.ndarray  # (B, k, 2) per-simulation surface velocities
    visc_inv: jnp.ndarray  # (N_pad, N) row-shardable
    pressure_inv: jnp.ndarray  # (N_pad, N)
    n_pad: int
    smooth_inv: Any = None  # (N_pad, N) pressure-smoothing inverse (report)

    @classmethod
    def build(
        cls,
        mesh: Mesh,
        device_mesh: DeviceMesh,
        b1s: np.ndarray | None = None,
        b2s: np.ndarray | None = None,
        config: stokes.StokesConfig | None = None,
        omegas: np.ndarray | None = None,
    ) -> "ShardedEnsemble":
        """Squirmer ensembles sweep (b1s, b2s); rotating-cylinder ensembles
        (``config.bc_kind='rotating'``, e.g. the "report" variant) sweep
        ``omegas``.  Any ``config.variant`` is supported — the step builder
        mirrors the matching single-device projection."""
        config = config or stokes.StokesConfig(solver="inverse")
        assert config.solver == "inverse", "sharded path requires matvec solvers"
        problem = stokes.StokesProblem.build(mesh, config)
        inner = problem.boundary.inner
        if config.bc_kind == "rotating":
            assert omegas is not None, "rotating ensembles sweep omegas"
            vals = np.stack(
                [
                    bc.rotating_cylinder_values(mesh.coords, inner, config.center, om)
                    for om in omegas
                ]
            )
        else:
            vals = np.stack(
                [
                    bc.squirmer_values(mesh.coords, inner, config.center, b1, b2)
                    for b1, b2 in zip(b1s, b2s)
                ]
            )
        space = device_mesh.shape["space"]
        visc_inv = _pad_rows(np.asarray(problem.visc_solver.inv), space)
        pressure_inv = _pad_rows(np.asarray(problem.pressure_solver.inv), space)
        smooth_inv = None
        if problem.smooth_solver is not None:
            smooth_inv = jnp.asarray(
                _pad_rows(np.asarray(problem.smooth_solver.inv), space)
            )
        return cls(
            problem=problem,
            device_mesh=device_mesh,
            inner_values=jnp.asarray(vals),
            visc_inv=jnp.asarray(visc_inv),
            pressure_inv=jnp.asarray(pressure_inv),
            n_pad=visc_inv.shape[0],
            smooth_inv=smooth_inv,
        )

    @property
    def transport(self) -> str:
        t = self.problem.config.transport
        return t if t in ("dye", "tracers") else "dye"

    def initial_state(self) -> dict:
        b = self.inner_values.shape[0]
        n = self.problem.mesh.n_nodes
        dtype = self.inner_values.dtype
        u = jnp.zeros((b, n, 2), dtype=dtype)
        problem = self.problem
        u = jax.vmap(lambda uu, vv: _apply_bcs_batched(problem, uu, vv))(
            u, self.inner_values
        )
        state = {"u": u, "step": jnp.zeros(b, dtype=jnp.int32)}
        if self.transport == "tracers":
            pts = jnp.asarray(problem.tracer_init, dtype=dtype)
            state["tracers"] = jnp.tile(pts[None], (b, 1, 1))
            state["tracer_status"] = jnp.zeros(
                (b, pts.shape[0]), dtype=jnp.int32
            )
        else:
            c = jnp.where(
                jnp.asarray(problem.mesh.coords[:, 0]) < problem.config.dye_threshold,
                1.0,
                0.0,
            ).astype(dtype)
            state["c"] = jnp.tile(c[None], (b, 1))
        return state


def _apply_bcs_batched(problem, u, inner_vals):
    b = problem.boundary
    if len(b.masters):
        u = bc.apply_periodic_field(u, b.masters, b.slaves)
    u = u.at[jnp.asarray(b.walls)].set(0.0)
    return u.at[jnp.asarray(b.inner)].set(inner_vals.astype(u.dtype))


# ---------------------------------------------------------------------------
# Per-simulation meshes (geometry ensembles)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiMeshEnsemble:
    """An ensemble where every simulation runs on its OWN mesh (e.g.
    jittered geometry realizations from ``generate_annulus_mesh(jitter=…,
    pad_hole=True, seed=k)`` — same node count and identical boundary
    index sets, different interior geometry).  All per-sim operators
    (viscous/pressure inverses, dense div/grad) are stacked on the batch
    axis and row-sharded over "space"; the batch is sharded over "data".
    Per-sim transport ("dye"/"tracers") rides stacked locator tables
    padded to a common candidate width
    (:class:`tpufem.transport.BatchedGridLocator`)."""

    meshes: tuple
    device_mesh: DeviceMesh
    inner_values: jnp.ndarray  # (B, k, 2)
    visc_inv: jnp.ndarray  # (B, N_pad, N)
    pressure_inv: jnp.ndarray  # (B, N_pad, N)
    div_x: jnp.ndarray  # (B, N_pad, N)
    div_y: jnp.ndarray  # (B, N_pad, N)
    config: stokes.StokesConfig
    locator: Any = None  # BatchedGridLocator when transport != "none"
    tracer_init: Any = None  # (P, 2) shared tracer seed grid

    @classmethod
    def build(
        cls,
        meshes,
        device_mesh: DeviceMesh,
        b1s: np.ndarray,
        b2s: np.ndarray,
        config: stokes.StokesConfig | None = None,
    ) -> "MultiMeshEnsemble":
        config = config or stokes.StokesConfig(
            solver="inverse", pressure_mode="merge", transport="none"
        )
        assert config.solver == "inverse" and config.dense_ops, (
            "per-sim meshes ride stacked dense operators"
        )
        assert config.transport in ("none", "dye", "tracers")
        assert len(meshes) == len(b1s) == len(b2s)
        probs = [stokes.StokesProblem.build(m, config) for m in meshes]
        b0 = probs[0].boundary
        for p in probs[1:]:
            for f in ("walls", "inner", "masters", "slaves", "interior"):
                assert np.array_equal(getattr(p.boundary, f), getattr(b0, f)), (
                    f"per-sim meshes must share boundary index sets ({f}) — "
                    "use the same pad_hole generator parameters"
                )
        space = device_mesh.shape["space"]

        def stack(get):
            return jnp.asarray(
                np.stack([_pad_rows(np.asarray(get(p)), space) for p in probs])
            )

        vals = np.stack(
            [
                bc.squirmer_values(m.coords, b0.inner, config.center, b1, b2)
                for m, b1, b2 in zip(meshes, b1s, b2s)
            ]
        )
        locator = None
        tracer_init = None
        if config.transport != "none":
            locator = transport.BatchedGridLocator.build(meshes)
            tracer_init = probs[0].tracer_init
        return cls(
            meshes=tuple(meshes),
            device_mesh=device_mesh,
            inner_values=jnp.asarray(vals),
            visc_inv=stack(lambda p: p.visc_solver.inv),
            pressure_inv=stack(lambda p: p.pressure_solver.inv),
            div_x=stack(lambda p: p.div_x),
            div_y=stack(lambda p: p.div_y),
            config=config,
            locator=locator,
            tracer_init=tracer_init,
        )

    def initial_state(self) -> dict:
        b = self.inner_values.shape[0]
        n = self.meshes[0].n_nodes
        dtype = self.inner_values.dtype
        u = jnp.zeros((b, n, 2), dtype=dtype)
        u = jax.vmap(
            lambda uu, vv: _apply_bcs_shared(
                self.meshes[0], self.config, uu, vv
            )
        )(u, self.inner_values)
        state = {"u": u, "step": jnp.zeros(b, dtype=jnp.int32)}
        cfg = self.config
        if cfg.transport == "tracers":
            pts = jnp.asarray(self.tracer_init, dtype=dtype)
            state["tracers"] = jnp.tile(pts[None], (b, 1, 1))
            state["tracer_status"] = jnp.zeros((b, pts.shape[0]), dtype=jnp.int32)
        elif cfg.transport == "dye":
            # per-sim initial dye: the threshold cut rides per-sim coords
            coords_x = jnp.asarray(self.locator.coords[:, :, 0])
            state["c"] = jnp.where(
                coords_x < cfg.dye_threshold, 1.0, 0.0
            ).astype(dtype)
        return state


def _apply_bcs_shared(mesh0, config, u, inner_vals):
    from tpufem import bc as bc_mod

    boundary = bc_mod.ChannelBoundary.build(
        mesh0, inner_marker=config.inner_marker, L=config.L, H=config.H,
        tol=config.tol, all_walls=config.all_walls,
    )
    if len(boundary.masters):
        u = bc_mod.apply_periodic_field(u, boundary.masters, boundary.slaves)
    u = u.at[jnp.asarray(boundary.walls)].set(
        jnp.asarray(config.outer_value, dtype=u.dtype)
    )
    return u.at[jnp.asarray(boundary.inner)].set(inner_vals.astype(u.dtype))


def make_multimesh_step(ensemble: MultiMeshEnsemble, _jit: bool = True):
    """(data, space)-sharded double-projection step with PER-SIM operators:
    every matvec is a batched per-sim row-block einsum + all_gather."""
    cfg = ensemble.config
    dmesh = ensemble.device_mesh
    mesh0 = ensemble.meshes[0]
    n = mesh0.n_nodes
    dt = cfg.dt
    boundary = bc.ChannelBoundary.build(
        mesh0, inner_marker=cfg.inner_marker, L=cfg.L, H=cfg.H,
        tol=cfg.tol, all_walls=cfg.all_walls,
    )
    interior = jnp.asarray(boundary.interior)

    def mv(rows_, x):
        """(Bl, Nl, N) per-sim row blocks @ (Bl, N, ...) → (Bl, N, ...)."""
        part = jnp.einsum("brn,bn...->br...", rows_, x, precision=_HI)
        return jax.lax.all_gather(part, "space", axis=1, tiled=True)[:, :n]

    masters, slaves = boundary.masters, boundary.slaves
    walls = jnp.asarray(boundary.walls)
    inner_idx = jnp.asarray(boundary.inner)
    outer_v = jnp.asarray(cfg.outer_value)

    def apply_bcs(u, inner_vals):
        if len(masters):
            u = jax.vmap(lambda uu: bc.apply_periodic_field(uu, masters, slaves))(u)
        u = u.at[:, walls].set(outer_v.astype(u.dtype))
        return u.at[:, inner_idx].set(inner_vals.astype(u.dtype))

    state_spec = {"u": P("data"), "step": P("data")}
    tr_kind = cfg.transport
    if tr_kind == "dye":
        state_spec["c"] = P("data")
    elif tr_kind == "tracers":
        state_spec["tracers"] = P("data")
        state_spec["tracer_status"] = P("data")
    op_spec = P("data", "space", None)
    n_tr = 4 if tr_kind != "none" else 0
    tr_specs = (P("data"),) * n_tr
    g = ensemble.locator.g if ensemble.locator is not None else 0

    @partial(
        shard_map,
        mesh=dmesh,
        in_specs=(state_spec, op_spec, op_spec, op_spec, op_spec, P("data"))
        + tr_specs,
        out_specs=(state_spec, P("data")),
        check_vma=False,
    )
    def step(state, visc, press, dxr, dyr, inner_vals, *tr_tables):
        def div(u):
            return mv(dxr, u[..., 0]) + mv(dyr, u[..., 1])

        def grad(p):
            return jnp.stack([mv(dxr, p), mv(dyr, p)], axis=-1)

        u = state["u"]
        u_star = apply_bcs(mv(visc, u), inner_vals)
        p = mv(press, -div(u_star) / dt)
        u_new = apply_bcs(u_star - dt * grad(p), inner_vals)
        p2 = mv(press, -div(u_new) / dt)
        g2 = grad(p2)
        u_new = u_new.at[:, interior].add(-dt * g2[:, interior])
        final_div = jnp.max(jnp.abs(div(u_new)), axis=1)
        new_state = {"u": u_new, "step": state["step"] + 1}
        per_sim = final_div
        if tr_kind == "dye":
            rows, origins, extents, coords_b = tr_tables
            new_state["c"] = transport.advect_semilagrange_batched(
                rows, origins, extents, coords_b, g,
                state["c"], u_new, dt, L=cfg.L, H=cfg.H,
            )
        elif tr_kind == "tracers":
            rows, origins, extents, _ = tr_tables
            pts = transport.tracer_step_batched(
                rows, origins, extents, g,
                state["tracers"], u_new, dt, L=cfg.L,
                method=cfg.tracer_method,
            )
            status = jax.vmap(
                lambda pi, si: transport.capture_update(
                    pi, si, cfg.center, cfg.capture_radius
                )
            )(pts, state["tracer_status"])
            new_state["tracers"] = pts
            new_state["tracer_status"] = status
            per_sim = jnp.sum(status, axis=1).astype(u_new.dtype)
        return new_state, per_sim

    def raw(state):
        tr_tables = ()
        if tr_kind != "none":
            tr_tables = ensemble.locator.tables(state["u"].dtype)
        return step(
            state, ensemble.visc_inv, ensemble.pressure_inv,
            ensemble.div_x, ensemble.div_y, ensemble.inner_values,
            *tr_tables,
        )

    return jax.jit(raw) if _jit else raw


# ---------------------------------------------------------------------------
# Element-sharded divergence / gradient (psum-assembled)
# ---------------------------------------------------------------------------


def _shard_elements(mesh: Mesh, n_shards: int):
    """Pad element arrays to a multiple of n_shards (pad entries invalid)."""
    t = mesh.n_tris
    pad = (-t) % n_shards
    tris = np.concatenate([mesh.tris, np.zeros((pad, 3), np.int32)])
    grads = np.concatenate([mesh.grads, np.zeros((pad, 3, 2))])
    area = np.concatenate([mesh.area, np.zeros(pad)])
    valid = np.concatenate([mesh.valid, np.zeros(pad, bool)])
    return tris, grads, area, valid


def _div_local(tris, grads, area, valid, u, n_nodes):
    """Local partial sums of the lumped divergence (no normalization)."""
    u_loc = u[:, tris]  # (B, Tl, 3, 2)
    div_e = jnp.einsum("btic,tic->bt", u_loc, grads, precision=_HI)
    w = jnp.where(valid, area / 3.0, 0.0)
    seg = tris.reshape(-1)
    contrib = jnp.broadcast_to((div_e * w)[..., None], div_e.shape + (3,)).reshape(
        div_e.shape[0], -1
    )
    num = jax.vmap(lambda v: jax.ops.segment_sum(v, seg, num_segments=n_nodes))(contrib)
    den = jax.ops.segment_sum(
        jnp.broadcast_to(w[:, None], (w.shape[0], 3)).reshape(-1), seg, num_segments=n_nodes
    )
    return num, den


def _grad_local(tris, grads, area, valid, p, n_nodes):
    p_loc = p[:, tris]  # (B, Tl, 3)
    g_e = jnp.einsum("bti,tid->btd", p_loc, grads, precision=_HI)  # (B, Tl, 2)
    w = jnp.where(valid, area / 3.0, 0.0)
    seg = tris.reshape(-1)
    contrib = (g_e * w[None, :, None])[:, :, None, :] * jnp.ones((1, 1, 3, 1))
    contrib = contrib.reshape(p.shape[0], -1, 2)
    num = jax.vmap(
        lambda v: jax.ops.segment_sum(v, seg, num_segments=n_nodes)
    )(contrib)
    den = jax.ops.segment_sum(
        jnp.broadcast_to(w[:, None], (w.shape[0], 3)).reshape(-1), seg, num_segments=n_nodes
    )
    return num, den


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------


def run_sharded(ensemble: "ShardedEnsemble", steps: int, state: dict | None = None):
    """Scan ``steps`` sharded ensemble steps in ONE jitted program.

    Returns (final_state, per-step per-sim metric array (steps, B)) —
    eaten counts for tracer ensembles, max-divergence for dye ensembles.
    """
    if state is None:
        state = ensemble.initial_state()
    raw_step = make_sharded_step(ensemble, _jit=False)

    @jax.jit
    def scan_all(state):
        return jax.lax.scan(lambda s, _: raw_step(s), state, None, length=steps)

    return scan_all(state)


def make_sharded_step(ensemble: ShardedEnsemble, _jit: bool = True):
    """Build the jitted (data, space)-sharded full step: viscous solve →
    double pressure projection → BC re-application → dye advection or
    tracer transport.

    Collectives: ``all_gather`` ("space") after each row-sharded matvec,
    ``psum`` ("space") to assemble element-sharded div/grad sums.
    ``_jit=False`` returns the raw state→(state, metric) callable for
    embedding in ``lax.scan`` (see :func:`run_sharded`).
    """
    problem = ensemble.problem
    mesh = problem.mesh
    cfg = problem.config
    dmesh = ensemble.device_mesh
    n = mesh.n_nodes
    space = dmesh.shape["space"]
    tris_sh, grads_sh, area_sh, valid_sh = _shard_elements(mesh, space)
    interior = jnp.asarray(problem.boundary.interior)
    cent = jnp.asarray(mesh.centroids())
    dt = cfg.dt

    def matvec(inv_rows, x):
        """Row-sharded inverse application: (Nl, N) @ (B, N, ...) →
        all_gather → (B, N_pad, ...)[:, :n]."""
        part = jnp.einsum("rn,bn...->br...", inv_rows, x, precision=_HI)
        full = jax.lax.all_gather(part, "space", axis=1, tiled=True)
        return full[:, :n]

    def div(u):
        num, den = _div_local(
            jnp.asarray(tris_sh), jnp.asarray(grads_sh), jnp.asarray(area_sh),
            jnp.asarray(valid_sh), u, n,
        )
        num = jax.lax.psum(num, "space")
        den = jax.lax.psum(den, "space")
        return num / (den + 1e-12)

    def grad(p):
        num, den = _grad_local(
            jnp.asarray(tris_sh), jnp.asarray(grads_sh), jnp.asarray(area_sh),
            jnp.asarray(valid_sh), p, n,
        )
        num = jax.lax.psum(num, "space")
        den = jax.lax.psum(den, "space")
        return num / (den[..., None] + 1e-12)

    def apply_bcs(u, inner_vals):
        return jax.vmap(lambda uu, vv: _apply_bcs_batched(problem, uu, vv))(u, inner_vals)

    def advect(c, u):
        return jax.vmap(
            lambda ci, ui: transport.advect_semilagrange(
                mesh, problem.get_locator(), ci, ui, dt, L=cfg.L, H=cfg.H
            )
        )(c, u)

    def tracers_step(pts, status, u):
        new_pts = jax.vmap(
            lambda pi, ui: transport.tracer_step(
                mesh, problem.get_locator(), pi, ui, dt, L=cfg.L, method=cfg.tracer_method
            )
        )(pts, u)
        new_status = jax.vmap(
            lambda pi, si: transport.capture_update(
                pi, si, cfg.center, cfg.capture_radius
            )
        )(new_pts, status)
        return new_pts, new_status

    uses_tracers = ensemble.transport == "tracers"
    base_spec = {"u": P("data"), "step": P("data")}
    state_spec = dict(
        base_spec,
        **(
            {"tracers": P("data"), "tracer_status": P("data")}
            if uses_tracers
            else {"c": P("data")}
        ),
    )
    is_report = cfg.variant == "report"
    has_smooth = ensemble.smooth_inv is not None
    walls = jnp.asarray(problem.boundary.walls)
    inner_idx = jnp.asarray(problem.boundary.inner)
    masters, slaves = problem.boundary.masters, problem.boundary.slaves
    pin = problem.pressure_pin

    def transport_update(state, u_new):
        new = {}
        if uses_tracers:
            new["tracers"], new["tracer_status"] = tracers_step(
                state["tracers"], state["tracer_status"], u_new
            )
            per_sim = jnp.sum(new["tracer_status"], axis=1).astype(u_new.dtype)
        else:
            new["c"] = advect(state["c"], u_new)
            per_sim = None
        return new, per_sim

    def color_step(state, visc_inv_rows, press_inv_rows, inner_vals):
        """The StokesColor double projection (per-sim squirmer values)."""
        u = state["u"]
        u_star = apply_bcs(matvec(visc_inv_rows, u), inner_vals)
        p = matvec(press_inv_rows, -div(u_star) / dt)
        u_new = apply_bcs(u_star - dt * grad(p), inner_vals)
        p2 = matvec(press_inv_rows, -div(u_new) / dt)
        g2 = grad(p2)
        u_new = u_new.at[:, interior].add(-dt * g2[:, interior])
        new_state = {"u": u_new, "step": state["step"] + 1}
        tr, per_sim = transport_update(state, u_new)
        new_state.update(tr)
        if per_sim is None:
            per_sim = jnp.max(jnp.abs(div(u_new)), axis=1)
        return new_state, per_sim

    def report_step(state, visc_inv_rows, press_inv_rows, smooth_inv_rows,
                    inner_vals):
        """The 'report' step, batched — mirrors
        :func:`stokes._report_projection_step` (RHS-overwrite BCs, pinned +
        de-meaned pressure, optional smoothing, single projection) with a
        per-sim BC ramp."""
        u = state["u"]
        if cfg.ramp_steps > 0:
            scale = jnp.minimum(
                (state["step"] + 1).astype(u.dtype) / cfg.ramp_steps, 1.0
            )
        else:
            scale = jnp.ones(u.shape[0], dtype=u.dtype)
        vals = inner_vals.astype(u.dtype) * scale[:, None, None]
        outer_v = jnp.asarray(cfg.outer_value, dtype=u.dtype)
        f = jnp.asarray(cfg.body_force, dtype=u.dtype)

        rhs = u + dt * f
        rhs = rhs.at[:, walls].set(outer_v)
        rhs = rhs.at[:, inner_idx].set(vals)
        u_star = matvec(visc_inv_rows, rhs)
        if len(masters):
            u_star = jax.vmap(
                lambda uu: bc.apply_periodic_field(uu, masters, slaves)
            )(u_star)

        b_p = -div(u_star) / dt
        b_p = b_p - jnp.mean(b_p, axis=1, keepdims=True)
        b_p = b_p.at[:, pin].set(0.0)
        p = matvec(press_inv_rows, b_p)
        if smooth_inv_rows is not None:
            p = p.at[:, pin].set(0.0)
            p = matvec(smooth_inv_rows, p)
            p = p - jnp.mean(p, axis=1, keepdims=True)

        u_new = u_star - dt * grad(p)
        final_div = div(u_new)  # measured before BC re-application
        u_new = u_new.at[:, walls].set(outer_v)
        if len(masters):
            u_new = jax.vmap(
                lambda uu: bc.apply_periodic_field(uu, masters, slaves)
            )(u_new)
        u_new = u_new.at[:, inner_idx].set(vals)
        new_state = {"u": u_new, "step": state["step"] + 1}
        tr, per_sim = transport_update(state, u_new)
        new_state.update(tr)
        if per_sim is None:
            per_sim = jnp.max(jnp.abs(final_div), axis=1)
        return new_state, per_sim

    op_specs = (P("space", None), P("space", None)) + (
        (P("space", None),) if (is_report and has_smooth) else ()
    )

    @partial(
        shard_map,
        mesh=dmesh,
        in_specs=(state_spec,) + op_specs + (P("data"),),
        out_specs=(state_spec, P("data")),
        check_vma=False,
    )
    def step(state, visc_inv_rows, press_inv_rows, *rest):
        if is_report:
            smooth_rows = rest[0] if has_smooth else None
            inner_vals = rest[-1]
            return report_step(
                state, visc_inv_rows, press_inv_rows, smooth_rows, inner_vals
            )
        (inner_vals,) = rest
        return color_step(state, visc_inv_rows, press_inv_rows, inner_vals)

    def raw(state):
        ops = (ensemble.visc_inv, ensemble.pressure_inv) + (
            (ensemble.smooth_inv,) if (is_report and has_smooth) else ()
        )
        return step(state, *ops, ensemble.inner_values)

    return jax.jit(raw) if _jit else raw
