"""Halo-exchange distributed SpMV/CG over stencil-offset operators.

``parallel/halo.py`` exchanges O(bandwidth) boundary strips of RCM-banded
operators — but reads the whole O(bw·N) band envelope per local matvec.
:class:`tpufem.ops.stencil.StencilOperator` (the O(nnz) single-chip SpMV,
ops/stencil.py) decomposes A = Σ_k diag(d_k)·Shift(o_k) + R; distributing
it keeps the multi-chip SpMV O(nnz) too:

* the **stencil part** only reads x within ``max|o_k|`` rows of the local
  block, so the halo is the same two ``ppermute`` strips as the banded
  path — just ``max|offset|`` wide instead of ``bandwidth`` wide;
* the **COO remainder** R is split by block ownership: entries whose row
  and column live on the same device apply locally; the few cross-block
  couplings (O(perimeter) on grid-numbered pad_hole meshes) ride ONE
  small ``all_gather`` of a compacted send buffer — each device
  contributes only the x-values some other device's remainder rows
  actually reference.

Correctness is validated against the single-device step on a virtual
8-device CPU mesh (tests/test_parallel.py) and on four GPUs by
``chip_smoke.py --four``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P

from tpufem.ops.stencil import StencilOperator


@dataclasses.dataclass(frozen=True)
class _StencilLayout:
    """Host-precomputed per-device tables for the distributed stencil SpMV.

    All arrays carry a leading (s,) device axis and equal per-device
    padded lengths (pad slots have data 0 / index 0 — inert adds)."""

    offsets: tuple
    bw: int  # halo strip width = max |offset|
    rows: int  # rows per device block
    n_pad: int
    diags: np.ndarray  # (s, n_off, rows)
    lrows: np.ndarray  # (s, L_loc) local-remainder target rows (block-local)
    lcols: np.ndarray  # (s, L_loc) block-local source cols
    ldata: np.ndarray  # (s, L_loc)
    send_idx: np.ndarray  # (s, L_send) block-local x indices to contribute
    crows: np.ndarray  # (s, L_cross) cross-remainder target rows
    cpos: np.ndarray  # (s, L_cross) positions into the gathered buffer
    cdata: np.ndarray  # (s, L_cross)
    has_local: bool
    has_cross: bool


def _pad_by_device(dev: np.ndarray, arrays, s: int):
    """Scatter per-entry arrays into (s, L) tables ordered by device."""
    counts = np.bincount(dev, minlength=s)
    L = max(1, int(counts.max()) if len(dev) else 0)
    order = np.argsort(dev, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(dev)) - np.repeat(starts, counts)
    out = []
    for a in arrays:
        t = np.zeros((s, L), dtype=a.dtype)
        t[dev[order], slot] = a[order]
        out.append(t)
    return out


def build_stencil_layout(op: StencilOperator, s: int) -> _StencilLayout:
    n = op.n
    rows = -(-n // s)
    # offsets wider than the block cannot ride a nearest-neighbor halo —
    # demote their (sparse) diagonal entries into the COO remainder.  The
    # single-chip picker keeps the 16 most FREQUENT offsets, which on
    # annulus meshes includes a few long ring↔grid couplings; the 9 true
    # grid-stencil offsets (|o| ≤ n_side+1) always stay diagonal.
    near = [o for o in op.offsets if abs(o) < rows]
    far = [o for o in op.offsets if abs(o) >= rows]
    assert near and 0 in near, (
        f"no stencil offset fits a {rows}-row block — use fewer shards"
    )
    bw = max(abs(o) for o in near)
    offsets = tuple(near)
    n_pad = rows * s

    all_diags = np.asarray(op.diags, dtype=np.float64)
    diags = np.zeros((len(offsets), n_pad))
    for j, o in enumerate(offsets):
        diags[j, :n] = all_diags[op.offsets.index(o)]
    diags_sh = diags.reshape(len(offsets), s, rows).transpose(1, 0, 2)

    r = np.asarray(op.rest_rows, dtype=np.int64)
    c = np.asarray(op.rest_cols_j, dtype=np.int64)
    d = np.asarray(op.rest_data, dtype=np.float64)
    for o in far:
        dk = all_diags[op.offsets.index(o)]
        rr = np.nonzero(dk)[0]
        rr = rr[(rr + o >= 0) & (rr + o < n)]
        r = np.concatenate([r, rr])
        c = np.concatenate([c, rr + o])
        d = np.concatenate([d, dk[rr]])
    row_dev = r // rows
    col_dev = c // rows
    local = row_dev == col_dev

    lrows, lcols, ldata = _pad_by_device(
        row_dev[local],
        [(r[local] % rows).astype(np.int32), (c[local] % rows).astype(np.int32),
         d[local]],
        s,
    )

    cross = ~local
    rc, cc, dc_ = r[cross], c[cross], d[cross]
    if len(rc):
        uc = np.unique(cc)  # sorted → owners sorted too
        owner = uc // rows
        counts = np.bincount(owner, minlength=s)
        L_send = max(1, int(counts.max()))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(uc)) - np.repeat(starts, counts)
        send_idx = np.zeros((s, L_send), np.int32)
        send_idx[owner, slot] = (uc % rows).astype(np.int32)
        buf_pos_of = owner * L_send + slot  # position in flattened gather
        pos = buf_pos_of[np.searchsorted(uc, cc)].astype(np.int32)
        crows, cpos, cdata = _pad_by_device(
            row_dev[cross], [(rc % rows).astype(np.int32), pos, dc_], s
        )
    else:
        send_idx = np.zeros((s, 1), np.int32)
        crows, cpos, cdata = (
            np.zeros((s, 1), np.int32),
            np.zeros((s, 1), np.int32),
            np.zeros((s, 1)),
        )

    return _StencilLayout(
        offsets=offsets, bw=bw, rows=rows, n_pad=n_pad, diags=diags_sh,
        lrows=lrows, lcols=lcols, ldata=ldata, send_idx=send_idx,
        crows=crows, cpos=cpos, cdata=cdata,
        has_local=bool(local.any()), has_cross=bool(len(rc)),
    )


def _make_stencil_mv(layout: _StencilLayout, axis: str, s: int):
    """Shard-local A@x given the per-device layout slices (call inside
    shard_map; every table argument is the device's own (…,) slice)."""
    bw, rows, offsets = layout.bw, layout.rows, layout.offsets
    fwd = [(i, (i + 1) % s) for i in range(s)]
    bwd = [(i, (i - 1) % s) for i in range(s)]

    def halo_extend(x):  # (rows, k) → (rows + 2bw, k)
        if bw == 0:
            return x
        idx = jax.lax.axis_index(axis)
        from_left = jax.lax.ppermute(x[-bw:], axis, fwd)
        from_right = jax.lax.ppermute(x[:bw], axis, bwd)
        from_left = jnp.where(idx == 0, 0.0, from_left)
        from_right = jnp.where(idx == s - 1, 0.0, from_right)
        return jnp.concatenate([from_left, x, from_right], axis=0)

    def mv(tables, x):  # x: (rows, k)
        diags_l, lrows, lcols, ldata, send_idx, crows, cpos, cdata = tables
        k = x.shape[1]
        xe = halo_extend(x)
        y = jnp.zeros_like(x)
        for j, o in enumerate(offsets):
            y = y + diags_l[j][:, None] * jax.lax.dynamic_slice(
                xe, (bw + o, 0), (rows, k)
            )
        if layout.has_local:
            y = y.at[lrows].add(ldata[:, None] * x[lcols])
        if layout.has_cross:
            buf = jax.lax.all_gather(x[send_idx], axis)  # (s, L_send, k)
            buf = buf.reshape(-1, k)
            y = y.at[crows].add(cdata[:, None] * buf[cpos])
        return y

    return mv


def _table_specs(axis):
    return (P(axis),) * 8


def _device_tables(layout: _StencilLayout):
    return (
        jnp.asarray(layout.diags),
        jnp.asarray(layout.lrows), jnp.asarray(layout.lcols),
        jnp.asarray(layout.ldata),
        jnp.asarray(layout.send_idx),
        jnp.asarray(layout.crows), jnp.asarray(layout.cpos),
        jnp.asarray(layout.cdata),
    )


def _local_tables(tables):
    """Strip the leading shard axis shard_map leaves on each table."""
    return tuple(t[0] for t in tables)


def make_stencil_halo_viscous_solver(
    device_mesh: DeviceMesh,
    op: StencilOperator,
    interior_mask: np.ndarray,
    dt_nu: float,
    iters: int,
    axis: str = "space",
):
    """Distributed (I + Δt·ν·K_masked) CG over stencil storage.

    Same Jacobi-PCG iteration as ``halo.make_halo_viscous_solver`` (and the
    single-device ``solve/matfree.ViscousCG``); only the SpMV differs.
    Returns ``solve(b (N,) or (N,k)) -> same shape`` in natural node order
    (stencil operators are built un-permuted)."""
    s = device_mesh.shape[axis]
    n = op.n
    layout = build_stencil_layout(op, s)
    rows, n_pad = layout.rows, layout.n_pad

    mask_p = np.zeros(n_pad)
    mask_p[:n] = np.asarray(interior_mask)
    diag_main = np.zeros(n_pad)
    diag_main[:n] = np.asarray(op.diag(), dtype=np.float64)
    inv_diag = np.where(mask_p > 0, 1.0 / (1.0 + dt_nu * diag_main), 1.0)
    mask_sh = jnp.asarray(mask_p.reshape(s, rows))
    invd_sh = jnp.asarray(inv_diag.reshape(s, rows))
    tables = _device_tables(layout)
    mv = _make_stencil_mv(layout, axis, s)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=_table_specs(axis) + (P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def solve_sm(*args):
        tabs = _local_tables(args[:8])
        mask_l, invd_l, b_l = args[8][0], args[9][0], args[10]

        def full_op(x):
            m = mask_l[:, None]
            return m * (x + dt_nu * mv(tabs, m * x)) + (1.0 - m) * x

        def dot(a, c):
            return jax.lax.psum(jnp.sum(a * c, axis=0), axis)

        x = jnp.zeros_like(b_l)
        r = b_l - full_op(x)
        z = invd_l[:, None] * r
        p = z
        rz = dot(r, z)

        def body(state, _):
            x, r, p, rz = state
            ap = full_op(p)
            denom = dot(p, ap)
            alpha = jnp.where(denom != 0, rz / denom, 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            z = invd_l[:, None] * r
            rz_new = dot(r, z)
            beta = jnp.where(rz != 0, rz_new / rz, 0.0)
            p = z + beta * p
            return (x, r, p, rz_new), None

        (x, _, _, _), _ = jax.lax.scan(body, (x, r, p, rz), None, length=iters)
        return x

    @jax.jit
    def solve(b):
        b2 = b.reshape(n, -1)
        pad = jnp.zeros((n_pad, b2.shape[1]), dtype=b2.dtype).at[:n].set(b2)
        cast = tuple(
            t.astype(b.dtype) if jnp.issubdtype(t.dtype, jnp.floating) else t
            for t in tables
        )
        x = solve_sm(*cast, mask_sh.astype(b.dtype), invd_sh.astype(b.dtype),
                     pad)
        return x[:n].reshape(b.shape)

    return solve


def make_stencil_halo_pressure_solver(
    device_mesh: DeviceMesh,
    op_merged: StencilOperator,
    m_lumped,
    masters: np.ndarray,
    slaves: np.ndarray,
    active_mask: np.ndarray,
    iters: int,
    axis: str = "space",
):
    """Distributed merged-periodic pressure Poisson, stencil storage.

    Mirrors ``halo.make_halo_pressure_solver`` (deflated Jacobi-PCG on
    K_merged p = merge(M_L ∘ b)) with the O(nnz) stencil SpMV and natural
    node order (no RCM permutation)."""
    s = device_mesh.shape[axis]
    n = op_merged.n
    layout = build_stencil_layout(op_merged, s)
    rows, n_pad = layout.rows, layout.n_pad

    act_p = np.zeros(n_pad)
    act_p[:n] = np.asarray(active_mask)
    diag_main = np.zeros(n_pad)
    diag_main[:n] = np.asarray(op_merged.diag(), dtype=np.float64)
    inv_diag = np.where(diag_main > 0, 1.0 / np.where(diag_main > 0, diag_main, 1.0), 1.0)
    act_sh = jnp.asarray(act_p.reshape(s, rows))
    invd_sh = jnp.asarray(inv_diag.reshape(s, rows))
    tables = _device_tables(layout)
    mv = _make_stencil_mv(layout, axis, s)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=_table_specs(axis) + (P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def solve_sm(*args):
        tabs = _local_tables(args[:8])
        act_l, invd_l, b_l = args[8][0], args[9][0], args[10]
        w = act_l[:, None]
        invd = invd_l[:, None]

        def dot(a, c):
            return jax.lax.psum(jnp.sum(a * c, axis=0), axis)

        ww = dot(w, w)

        def project(v):
            return v - (dot(w, v) / ww) * w

        b_l = project(b_l)
        x = jnp.zeros_like(b_l)
        r = b_l
        z = project(invd * r)
        p = z
        rz = dot(r, z)

        def body(state, _):
            x, r, p, rz = state
            ap = project(mv(tabs, p))
            denom = dot(p, ap)
            alpha = jnp.where(denom != 0, rz / denom, 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            z = project(invd * r)
            rz_new = dot(r, z)
            beta = jnp.where(rz != 0, rz_new / rz, 0.0)
            p = z + beta * p
            return (x, r, p, rz_new), None

        (x, _, _, _), _ = jax.lax.scan(body, (x, r, p, rz), None, length=iters)
        return x

    ml = jnp.asarray(np.asarray(m_lumped))
    m_idx = jnp.asarray(masters) if len(masters) else None
    s_idx = jnp.asarray(slaves) if len(slaves) else None
    act = jnp.asarray(np.asarray(active_mask))

    @jax.jit
    def solve(b):
        rhs = ml.astype(b.dtype) * b
        if m_idx is not None:
            rhs = rhs.at[m_idx].add(rhs[s_idx])
            rhs = rhs * act.astype(b.dtype)
        pad = jnp.zeros((n_pad, 1), dtype=b.dtype).at[:n, 0].set(rhs)
        cast = tuple(
            t.astype(b.dtype) if jnp.issubdtype(t.dtype, jnp.floating) else t
            for t in tables
        )
        x = solve_sm(*cast, act_sh.astype(b.dtype), invd_sh.astype(b.dtype),
                     pad)
        p_out = x[:n, 0]
        if m_idx is not None:
            p_out = p_out.at[s_idx].set(p_out[m_idx])
        return p_out

    return solve
