"""Pressure-Poisson operators: penalty (parity) and merged (fast/f32-safe).

The reference enforces periodicity on the pressure operator with a ±1e10
penalty (``/root/reference/code/StokesColor.py:206-221``), which works
under per-step f64 dense solves but is hostile to f32 and to iterative
solvers (κ ≳ 1e10 — SURVEY.md §7.3).  The *merged* operator implements the
constraint exactly by DOF-merging (slave pressure dofs share their
master's column), regularizes the constant nullspace, and bakes the whole
solve — M_L scaling, merge, deflation, inverse, scatter-back — into ONE
precomputed (N, N) matrix applied per step as a single matvec:

    p = A_eff @ b,   A_eff = M_g Π (K_act + α 𝟙𝟙ᵀ/n)⁻¹ Π M_gᵀ diag(M_L)

where b = −div(u*)/Δt, matching the reference's row-scaled system
``(K / M_L) p = b`` (StokesColor.py:478) up to the irrelevant constant
mode and the O(1/penalty) constraint error.
"""

from __future__ import annotations

import numpy as np

from tpufem.mesh.core import Mesh
from tpufem.ops import assembly


def owner_map(n: int, masters: np.ndarray, slaves: np.ndarray) -> np.ndarray:
    """(N,) node → owning node (master for slaves, itself otherwise).

    Non-injective pairings resolve like the reference's sequential
    elimination (last pair wins); ownership chains are collapsed.
    """
    owner = np.arange(n)
    for m, s in zip(np.asarray(masters), np.asarray(slaves)):
        owner[s] = m
    for _ in range(4):  # resolve chains
        owner = owner[owner]
    return owner


def merge_map(n: int, masters: np.ndarray, slaves: np.ndarray) -> np.ndarray:
    """(N, n_act) periodic DOF-merge matrix M_g with x_full = M_g x_act."""
    owner = owner_map(n, masters, slaves)
    active = np.nonzero(owner == np.arange(n))[0]
    col_of = -np.ones(n, dtype=np.int64)
    col_of[active] = np.arange(len(active))
    col = col_of[owner]
    mg = np.zeros((n, len(active)))
    mg[np.arange(n), col] = 1.0
    return mg


def merged_pressure_apply_matrix(
    mesh: Mesh,
    m_lumped: np.ndarray,
    masters: np.ndarray,
    slaves: np.ndarray,
) -> np.ndarray:
    """Host-precomputed (N, N) matrix solving the periodic pressure Poisson.

    Non-injective pairings (two masters sharing a slave — happens on
    mesh2.1) resolve like the reference's sequential elimination: the last
    pair wins.
    """
    n = mesh.n_nodes
    K = np.asarray(assembly.assemble_dense(mesh, assembly.element_stiffness(mesh)))
    m_lumped = np.asarray(m_lumped)

    mg = merge_map(n, masters, slaves)  # p_full = M_g p_act
    a_p = K / (m_lumped[:, None] + 1e-12)  # reference row scaling
    a_act = mg.T @ a_p @ mg
    return mg @ np.linalg.pinv(a_act) @ mg.T
