"""Structured-grid "stable fluids" solver — parity workload for
``scripts/simple_fluid.py``.

The reference's second capability family: a 200×200 Stam-style solver with
a pulsating circular obstacle, dye inflow jet, vectorized Jacobi iteration
(the reference calls it Gauss–Seidel but reads all neighbors before
writing — ``simple_fluid.py:53-65``), semi-Lagrangian advection via
bilinear back-trace interpolation (``:97-122``), and the quirky boundary
treatment of ``set_boundaries`` (``:30-51``): sign-flipped walls per
component, zero-gradient outflow on the right wall, averaged corners.

This maps directly onto an accelerator: the whole step is dense (G, G) array
arithmetic, jitted as one program with ``lax.scan`` over frames.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class StamConfig:
    size: int = 200
    dt: float = 0.1
    viscosity: float = 1e-4
    diffusion: float = 1e-4
    inflow_radius: int = 100
    inflow_speed: float = 5.0
    obstacle_center: tuple[int, int] | None = None  # default: grid center
    obstacle_base_radius: float = 20.0
    obstacle_squirm_amplitude: float = 2.0
    obstacle_squirm_speed: float = 0.1
    solver_iters: int = 20
    precision: str = "f32"  # device dtype of the grid solver


def set_boundaries(b: int, x: jnp.ndarray) -> jnp.ndarray:
    """The reference's boundary treatment (simple_fluid.py:30-51), applied
    in the same sequential order (later writes see earlier ones)."""
    x = x.at[0, :].set(-x[1, :] if b == 2 else x[1, :])
    x = x.at[-1, :].set(-x[-2, :] if b == 2 else x[-2, :])
    x = x.at[:, 0].set(-x[:, 1] if b == 1 else x[:, 1])
    x = x.at[:, -1].set(x[:, -2])  # zero-gradient outflow (right wall)
    x = x.at[0, 0].set(0.5 * (x[1, 0] + x[0, 1]))
    x = x.at[0, -1].set(0.5 * (x[1, -1] + x[0, -2]))
    x = x.at[-1, 0].set(0.5 * (x[-2, 0] + x[-1, 1]))
    x = x.at[-1, -1].set(0.5 * (x[-2, -1] + x[-1, -2]))
    return x


def linear_solve(b: int, x: jnp.ndarray, x0: jnp.ndarray, a: float, c: float, iters: int):
    """Fixed-iteration Jacobi relaxation of x = (x0 + a·Σneighbors)/c."""

    def body(x, _):
        nb = x[1:-1, :-2] + x[1:-1, 2:] + x[:-2, 1:-1] + x[2:, 1:-1]
        x = x.at[1:-1, 1:-1].set((x0[1:-1, 1:-1] + a * nb) / c)
        return set_boundaries(b, x), None

    x, _ = jax.lax.scan(body, x, None, length=iters)
    return x


def diffuse(b: int, x0: jnp.ndarray, diff: float, dt: float, size: int, iters: int):
    a = dt * diff * (size - 2) * (size - 2)
    return linear_solve(b, x0, x0, a, 1.0 + 4.0 * a, iters)


def project(vx: jnp.ndarray, vy: jnp.ndarray, size: int, iters: int):
    div = jnp.zeros_like(vx)
    div = div.at[1:-1, 1:-1].set(
        -0.5
        * (vx[1:-1, 2:] - vx[1:-1, :-2] + vy[2:, 1:-1] - vy[:-2, 1:-1])
        / size
    )
    div = set_boundaries(0, div)
    p = set_boundaries(0, jnp.zeros_like(vx))
    p = linear_solve(0, p, div, 1.0, 4.0, iters)
    vx = vx.at[1:-1, 1:-1].add(-0.5 * (p[1:-1, 2:] - p[1:-1, :-2]) * size)
    vy = vy.at[1:-1, 1:-1].add(-0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) * size)
    return set_boundaries(1, vx), set_boundaries(2, vy)


def _bilinear(d0: jnp.ndarray, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of d0 at (row=y, col=x) — the order-1
    ``map_coordinates`` equivalent (coordinates pre-clamped)."""
    size = d0.shape[0]
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    y1 = jnp.clip(y0 + 1, 0, size - 1)
    x1 = jnp.clip(x0 + 1, 0, size - 1)
    wy = y - y0
    wx = x - x0
    return (
        d0[y0, x0] * (1 - wy) * (1 - wx)
        + d0[y0, x1] * (1 - wy) * wx
        + d0[y1, x0] * wy * (1 - wx)
        + d0[y1, x1] * wy * wx
    )


def advect(b: int, d0: jnp.ndarray, vx: jnp.ndarray, vy: jnp.ndarray, dt: float):
    size = d0.shape[0]
    scale = dt * (size - 2)
    iy, ix = jnp.meshgrid(jnp.arange(size, dtype=d0.dtype),
                          jnp.arange(size, dtype=d0.dtype), indexing="ij")
    x = jnp.clip(ix - scale * vx, 0.5, size - 1.5)
    y = jnp.clip(iy - scale * vy, 0.5, size - 1.5)
    return set_boundaries(b, _bilinear(d0, y, x))


def obstacle_mask(config: StamConfig, t: jnp.ndarray) -> jnp.ndarray:
    size = config.size
    cx, cy = config.obstacle_center or (size // 2, size // 2)
    radius = config.obstacle_base_radius + config.obstacle_squirm_amplitude * jnp.sin(
        t * config.obstacle_squirm_speed
    )
    yy = jax.lax.broadcasted_iota(jnp.float32, (size, size), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (size, size), 1)
    return jnp.hypot(xx - cx, yy - cy) <= radius


def initial_state(config: StamConfig = StamConfig()) -> dict:
    dtype = jnp.float32 if config.precision == "f32" else jnp.float64
    z = jnp.zeros((config.size, config.size), dtype=dtype)
    return {"vx": z, "vy": z, "density": z, "t": jnp.asarray(0.0, dtype=dtype)}


def step(config: StamConfig, state: dict):
    """One reference-ordered step (simple_fluid.py:162-203)."""
    size, dt, iters = config.size, config.dt, config.solver_iters
    vx, vy, density, t = state["vx"], state["vy"], state["density"], state["t"]

    obstacle = obstacle_mask(config, t)
    vx = jnp.where(obstacle, 0.0, vx)
    vy = jnp.where(obstacle, 0.0, vy)

    vx0 = diffuse(1, vx, config.viscosity, dt, size, iters)
    vy0 = diffuse(2, vy, config.viscosity, dt, size, iters)
    vx0, vy0 = project(vx0, vy0, size, iters)
    vx = advect(1, vx0, vx0, vy0, dt)
    vy = advect(2, vy0, vx0, vy0, dt)
    vx, vy = project(vx, vy, size, iters)

    # dye + velocity inflow jet (add_source, simple_fluid.py:152-160)
    cy = size // 2
    s, e = cy - config.inflow_radius, cy + config.inflow_radius
    s = max(s, 0)
    vx = vx.at[s:e, 1:3].set(config.inflow_speed)
    density = density.at[s:e, 1:3].set(1.0)

    density0 = diffuse(0, density, config.diffusion, dt, size, iters)
    density = advect(0, density0, vx, vy, dt)
    density = jnp.where(obstacle, 0.1, density)

    return {"vx": vx, "vy": vy, "density": density, "t": t + dt}


_RUN_CACHE: dict[tuple, Any] = {}


def run(config: StamConfig = StamConfig(), frames: int = 400, state: dict | None = None):
    """Scan `frames` steps; returns (state, per-frame max speed)."""
    if state is None:
        state = initial_state(config)
    key = (dataclasses.astuple(config), frames)
    scan_all = _RUN_CACHE.get(key)
    if scan_all is None:

        @jax.jit
        def scan_all(state):
            def body(s, _):
                s = step(config, s)
                return s, jnp.max(jnp.hypot(s["vx"], s["vy"]))

            return jax.lax.scan(body, state, None, length=frames)

        _RUN_CACHE[key] = scan_all
    return scan_all(state)
