"""Faithful NumPy re-implementation of the reference algorithms.

Purpose: the reference publishes no wall-clock numbers,
so this module reproduces its *algorithms and cost profile* — Python
element loops for every operator evaluation and un-cached dense
``np.linalg.solve`` calls every step (4 per Stokes step) — to serve as

1. the **golden oracle** for parity tests of the tpufem framework, and
2. the **timing denominator** for the ≥100× speedup target.

The math follows the canonical reference copies cited in SURVEY.md §2.3
(stiffness ``code/StokesColor.py:98-128``, divergence ``:130-165``,
gradient ``:224-263``, lumped mass ``:266-284``, projection loop
``:537-575``) re-expressed independently; no reference code is copied.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Assembly (Python element loops, like the reference)
# ---------------------------------------------------------------------------


def build_stiffness(coords, tris, signed=False):
    n = coords.shape[0]
    A = np.zeros((n, n))
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if abs(det) < 1e-14:
            continue
        yd = (y2 - y3, y3 - y1, y1 - y2)
        xd = (x3 - x2, x1 - x3, x2 - x1)
        denom = 2.0 * (det if signed else abs(det))
        for i in range(3):
            for j in range(3):
                A[t[i], t[j]] += (yd[i] * yd[j] + xd[i] * xd[j]) / denom
    return A


def build_load(coords, tris, g_source, signed_area=True):
    n = coords.shape[0]
    b = np.zeros(n)
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if abs(det) < 1e-14:
            continue
        area = 0.5 * (det if signed_area else abs(det))
        g = (
            g_source((x1 + x2 + x3) / 3.0, (y1 + y2 + y3) / 3.0)
            if callable(g_source)
            else g_source
        )
        for p in t:
            b[p] += g * area / 3.0
    return -b


def lumped_mass(coords, tris):
    n = coords.shape[0]
    m = np.zeros(n)
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        area = 0.5 * abs(det)
        for p in t:
            m[p] += area / 3.0
    return m


def divergence(coords, tris, u):
    n = coords.shape[0]
    acc = np.zeros(n)
    w = np.zeros(n)
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if abs(det) < 1e-14:
            continue
        area = 0.5 * abs(det)
        dudx = (u[t[0], 0] * (y2 - y3) + u[t[1], 0] * (y3 - y1) + u[t[2], 0] * (y1 - y2)) / det
        dvdy = (u[t[0], 1] * (x3 - x2) + u[t[1], 1] * (x1 - x3) + u[t[2], 1] * (x2 - x1)) / det
        lump = (dudx + dvdy) * area / 3.0
        for p in t:
            acc[p] += lump
            w[p] += area / 3.0
    return acc / (w + 1e-12)


def gradient(coords, tris, p_scalar):
    n = coords.shape[0]
    gx = np.zeros(n)
    gy = np.zeros(n)
    w = np.zeros(n)
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if abs(det) < 1e-14:
            continue
        area = 0.5 * abs(det)
        gxe = (
            p_scalar[t[0]] * (y2 - y3)
            + p_scalar[t[1]] * (y3 - y1)
            + p_scalar[t[2]] * (y1 - y2)
        ) / det
        gye = (
            p_scalar[t[0]] * (x3 - x2)
            + p_scalar[t[1]] * (x1 - x3)
            + p_scalar[t[2]] * (x2 - x1)
        ) / det
        for p in t:
            gx[p] += gxe * area / 3.0
            gy[p] += gye * area / 3.0
            w[p] += area / 3.0
    return gx / (w + 1e-12), gy / (w + 1e-12)


def build_consistent_mass(coords, tris):
    n = coords.shape[0]
    M = np.zeros((n, n))
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if abs(det) < 1e-14:
            continue
        area = 0.5 * abs(det)
        for i in range(3):
            for j in range(3):
                M[t[i], t[j]] += (area / 12.0) * (2.0 if i == j else 1.0)
    return M


def build_convection(coords, tris, u, variant="stokescolor"):
    """Element-centroid convection matrix; both reference scalings
    (StokesColor 1/(2|det|) form vs op-split signed-det form)."""
    n = coords.shape[0]
    C = np.zeros((n, n))
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if abs(det) < 1e-14:
            continue
        u_c = u[t].mean(axis=0)
        yd = np.array([y2 - y3, y3 - y1, y1 - y2])
        xd = np.array([x3 - x2, x1 - x3, x2 - x1])
        if variant == "stokescolor":
            grads = np.stack([yd, xd], axis=1) / (2 * abs(det))
            row = 0.5 * abs(det) / 3.0
        else:  # opsplit
            grads = np.stack([yd, xd], axis=1) / det
            row = 0.5 * det / 3.0
        for i in range(3):
            for j in range(3):
                C[t[i], t[j]] += row * (u_c @ grads[j])
    return C


def eulerian_dye_step(coords, tris, markers, pairs, m_lumped, M, K, c, u, dt, D):
    """Implicit Eulerian dye step (visualize_stokes_flow.py:1344-1366)."""
    C = build_convection(coords, tris, u, "stokescolor")
    div_u = divergence(coords, tris, u)
    g = dt * (m_lumped * div_u)
    for m, s in pairs:
        g[s] = g[m]
    A_c = M + dt * (C + D * K) + np.diag(g)
    A_c = periodic_penalty(A_c, pairs)
    c_new = np.linalg.solve(A_c, M @ c)
    np.clip(c_new, 0.0, 1.0, out=c_new)
    for m, s in pairs:
        c_new[s] = c_new[m]
    return c_new


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------


def find_pairs(coords, L=1.0, H=1.0, tol=1e-6, exclude_walls=True):
    left = np.nonzero(np.abs(coords[:, 0]) < tol)[0]
    right = np.nonzero(np.abs(coords[:, 0] - L) < tol)[0]
    pairs = []
    for m in left:
        s = right[np.argmin(np.abs(coords[right, 1] - coords[m, 1]))]
        my = coords[m, 1]
        if exclude_walls and (abs(my) < tol or abs(my - H) < tol):
            continue
        pairs.append((int(m), int(s)))
    return pairs


def periodic_elimination(A, b, pairs):
    for m, s in pairs:
        A[m, :] += A[s, :]
        b[m] += b[s]
        A[s, :] = 0.0
        A[s, s] = 1.0
        A[s, m] = -1.0
        b[s] = 0.0
    return A, b


def periodic_penalty(A, pairs, penalty=1.0e10):
    for m, s in pairs:
        A[m, m] += penalty
        A[s, s] += penalty
        A[m, s] -= penalty
        A[s, m] -= penalty
    return A


def squirmer_velocity(coords, idx, center=(0.5, 0.5), B1=-2.0, B2=0.0):
    out = np.zeros((len(idx), 2))
    for k, i in enumerate(idx):
        th = np.arctan2(coords[i, 1] - center[1], coords[i, 0] - center[0])
        vt = B1 * np.sin(th) + B2 * np.sin(2 * th)
        out[k] = (-vt * np.sin(th), vt * np.cos(th))
    return out


# ---------------------------------------------------------------------------
# Poisson / heat pipelines (golden oracles)
# ---------------------------------------------------------------------------


def poisson_solve(coords, tris, markers, inner_marker=2, outer_value=1.0,
                  inner_value=0.0, L=1.0, H=1.0, tol=1e-6,
                  g_source=lambda x, y: 50.0 * np.sin(3.0 * y)):
    A = build_stiffness(coords, tris, signed=True)
    b = build_load(coords, tris, g_source, signed_area=True)
    pairs = find_pairs(coords, L=L, H=H, tol=tol)
    A, b = periodic_elimination(A, b, pairs)
    n = coords.shape[0]
    for i in range(n):
        is_wall = abs(coords[i, 1]) < tol or abs(coords[i, 1] - H) < tol
        is_inner = markers[i] == inner_marker
        if is_wall or is_inner:
            A[i, :] = 0.0
            A[i, i] = 1.0
            b[i] = inner_value if is_inner else outer_value
    return np.linalg.solve(A, b), A, b


def heat_run(coords, tris, markers, steps=600, dt=0.02, **kw):
    _, K, _ = poisson_solve(coords, tris, markers, **kw)
    n = coords.shape[0]
    A = np.eye(n) + dt * K
    tol = kw.get("tol", 1e-6)
    H = kw.get("H", 1.0)
    inner_marker = kw.get("inner_marker", 2)
    outer_value = kw.get("outer_value", 1.0)
    inner_value = kw.get("inner_value", 0.0)
    pairs = find_pairs(coords, L=kw.get("L", 1.0), H=H, tol=tol)

    def apply_bcs(u):
        for m, s in pairs:
            u[s] = u[m]
        for i in range(n):
            is_wall = abs(coords[i, 1]) < tol or abs(coords[i, 1] - H) < tol
            if markers[i] == inner_marker:
                u[i] = inner_value
            elif is_wall:
                u[i] = outer_value
        return u

    u = apply_bcs(np.zeros(n))
    for _ in range(steps):
        u = np.linalg.solve(A, u)  # same matrix re-solved, like heatEq.py:323
        u = apply_bcs(u)
    return u


# ---------------------------------------------------------------------------
# Monolithic saddle-point Stokes (scripts/navier_stokes.py oracle)
# ---------------------------------------------------------------------------


def monolithic_stokes_system(coords, tris, markers, nu=1.0, U0=1.0,
                             outer_marker=1, inner_marker=2):
    n = coords.shape[0]
    total = 3 * n
    A = np.zeros((total, total))
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        det = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if det == 0:
            continue
        yd = (y2 - y3, y3 - y1, y1 - y2)
        xd = (x3 - x2, x1 - x3, x2 - x1)
        for i in range(3):
            for j in range(3):
                visc = nu * (yd[i] * yd[j] + xd[i] * xd[j]) / (2.0 * det)
                A[t[i], t[j]] += visc
                A[n + t[i], n + t[j]] += visc
    for t in tris:
        (x1, y1), (x2, y2), (x3, y3) = coords[t]
        yd = (y2 - y3, y3 - y1, y1 - y2)
        xd = (x3 - x2, x1 - x3, x2 - x1)
        for i in range(3):
            for j in range(3):
                bx = -yd[j] / 6.0
                by = -xd[j] / 6.0
                A[2 * n + t[i], t[j]] += bx
                A[2 * n + t[i], n + t[j]] += by
                A[t[j], 2 * n + t[i]] += bx
                A[n + t[j], 2 * n + t[i]] += by
    b = np.zeros(total)
    for i in np.nonzero(markers == outer_marker)[0]:
        for dof in (i, n + i):
            A[dof, :] = 0.0
            A[dof, dof] = 1.0
            b[dof] = 0.0
    for i in np.nonzero(markers == inner_marker)[0]:
        px, py = coords[i]
        r = np.sqrt(px * px + py * py)
        if r == 0:
            r = 1.0
        for dof, val in ((i, -U0 * py / r), (n + i, U0 * px / r)):
            A[dof, :] = 0.0
            A[dof, dof] = 1.0
            b[dof] = val
    A[2 * n, :] = 0.0
    A[2 * n, 2 * n] = 1.0
    b[2 * n] = 0.0
    return A, b


# ---------------------------------------------------------------------------
# Stokes projection pipeline (golden oracle + timing target)
# ---------------------------------------------------------------------------


class StokesRef:
    """The StokesColor/StokesFood solver with the reference's exact
    per-step structure and cost profile (4 dense solves, 5+ element loops)."""

    def __init__(self, coords, tris, markers, dt=0.05, nu=0.1,
                 inner_marker=2, B1=-2.0, B2=0.0, center=(0.5, 0.5),
                 L=1.0, H=1.0, tol=1e-6):
        self.coords, self.tris, self.dt = coords, tris, dt
        self.L, self.H = L, H
        n = coords.shape[0]
        self.n = n
        self.pairs = find_pairs(coords, L=L, H=H, tol=tol)
        walls = np.nonzero(
            np.isclose(coords[:, 1], 0.0, atol=tol) | np.isclose(coords[:, 1], H, atol=tol)
        )[0]
        self.inner = np.nonzero(markers == inner_marker)[0]
        self.dirichlet = np.union1d(walls, self.inner)
        self.interior = np.setdiff1d(np.arange(n), self.dirichlet)
        self.walls = walls

        K = build_stiffness(coords, tris, signed=False)
        self.m_lumped = lumped_mass(coords, tris)
        A_visc = np.eye(n) + dt * nu * K
        A_visc[self.dirichlet, :] = 0.0
        A_visc[:, self.dirichlet] = 0.0
        A_visc[self.dirichlet, self.dirichlet] = 1.0
        self.A_visc = A_visc
        A_p = K / (self.m_lumped[:, None] + 1e-12)
        self.A_pressure = periodic_penalty(A_p, self.pairs)
        self.squirmer = squirmer_velocity(coords, self.inner, center, B1, B2)

    def apply_field_bcs(self, u):
        for m, s in self.pairs:
            u[s] = u[m]
        u[self.walls] = 0.0
        u[self.inner] = self.squirmer
        return u

    def initial_state(self):
        return self.apply_field_bcs(np.zeros((self.n, 2)))

    def step(self, u, b_force=None):
        dt = self.dt
        rhs_x = u[:, 0] + (dt * b_force[:, 0] if b_force is not None else 0.0)
        rhs_y = u[:, 1] + (dt * b_force[:, 1] if b_force is not None else 0.0)
        u_star = np.stack(
            [np.linalg.solve(self.A_visc, rhs_x), np.linalg.solve(self.A_visc, rhs_y)],
            axis=1,
        )
        u_star = self.apply_field_bcs(u_star)

        div_star = divergence(self.coords, self.tris, u_star)
        p = np.linalg.solve(self.A_pressure, -div_star / dt)
        gx, gy = gradient(self.coords, self.tris, p)
        u = u_star - dt * np.stack([gx, gy], axis=1)
        u = self.apply_field_bcs(u)

        div_u = divergence(self.coords, self.tris, u)
        p2 = np.linalg.solve(self.A_pressure, -div_u / dt)
        g2x, g2y = gradient(self.coords, self.tris, p2)
        u[self.interior, 0] -= dt * g2x[self.interior]
        u[self.interior, 1] -= dt * g2y[self.interior]

        final_div = divergence(self.coords, self.tris, u)
        return u, {"div_star": np.max(np.abs(div_star)),
                   "final_div": np.max(np.abs(final_div))}
