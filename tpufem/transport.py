"""Transport on the flow: point location, dye advection, tracers, mixing.

Replaces the reference's per-node Python loops and SciPy KDTree machinery
(``/root/reference/code/StokesColor.py:314-403``, ``code/StokesFood.py:
420-504``) with fully vectorized, jittable device programs:

* point location — a static top-k-centroid candidate search (exact
  semantics of ``PointLocator.find``: test the k nearest triangles by
  centroid distance in order, return the first containing one) and a
  scalable uniform-grid binned locator with padded candidate lists,
* semi-Lagrangian dye advection with periodic-x barycentric weights,
* passive tracer advection (Euler, like the reference, or RK2) with
  food-capture statistics,
* the Danckwerts mixing index.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.mesh.core import Mesh

# f32 products at full precision (the GPU default rounds operands to TF32)
_HI = jax.lax.Precision.HIGHEST

_DEG_TOL = 1e-14


def _barycentric(tri_xy: jnp.ndarray, p: jnp.ndarray):
    """Barycentric weights of points p (..., 2) in triangles (..., 3, 2).

    Same formulation as ``PointLocator.find`` (StokesColor.py:334-342):
        det = (x2−x1)(y3−y1) − (x3−x1)(y2−y1)
        w1  = ((x2−x)(y3−y) − (x3−x)(y2−y)) / det, etc.
    Returns (w (..., 3), det (...,)).
    """
    x1, y1 = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    x2, y2 = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    x3, y3 = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    x, y = p[..., 0], p[..., 1]
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    safe = jnp.where(jnp.abs(det) < _DEG_TOL, 1.0, det)
    w1 = ((x2 - x) * (y3 - y) - (x3 - x) * (y2 - y)) / safe
    w2 = ((x3 - x) * (y1 - y) - (x1 - x) * (y3 - y)) / safe
    w3 = 1.0 - w1 - w2
    return jnp.stack([w1, w2, w3], axis=-1), det


def _select_slot(arr: jnp.ndarray, slot: jnp.ndarray) -> jnp.ndarray:
    """``arr[p, slot[p]]`` over a small candidate axis WITHOUT a gather.

    ``take_along_axis`` lowers to a separate gather kernel.  A one-hot
    compare + masked sum over the C≤16 candidate axis is pure
    elementwise+reduce work that XLA fuses into the surrounding
    containment-test kernel — removing two kernels per locate."""
    p, c = arr.shape[:2]
    sel = (
        jax.lax.broadcasted_iota(jnp.int32, (p, c), 1) == slot[:, None]
    ).reshape((p, c) + (1,) * (arr.ndim - 2))
    return jnp.sum(jnp.where(sel, arr, jnp.zeros((), arr.dtype)), axis=1)


@dataclasses.dataclass(frozen=True)
class TopKLocator:
    """Reference-parity point locator: k nearest centroids, first hit wins.

    All P query points are processed at once: a (P, T) distance matrix,
    ``lax.top_k`` for candidates, vmapped containment tests.  Exactly the
    candidate semantics of StokesColor.py:324-345 — may "miss" points whose
    true host triangle is not among the k nearest centroids, in which case
    callers fall back like the reference does.  O(P·T) work: ideal below
    ~10k triangles; use :class:`GridLocator` beyond.
    """

    mesh: Mesh
    k: int = 10

    def centroids(self) -> np.ndarray:
        return self.mesh.centroids()

    def find(self, points: jnp.ndarray):
        """→ (tri_ids (P,), found (P,) bool)."""
        # the (P, T) distance matrix makes this O(P·T) memory — on a
        # 100k-triangle mesh with 10k tracers that is 4–8 GB per locate.
        # Fail loudly instead of OOM-ing mid-run; the auto path already
        # selects GridLocator, so only explicit locator="topk" hits this
        assert self.mesh.n_tris <= 50_000, (
            f"TopKLocator materializes a (P, {self.mesh.n_tris}) distance "
            "matrix — beyond ~50k triangles use locator='grid' "
            "(GridLocator: same answers, O(P·C) work)"
        )
        cent = jnp.asarray(self.centroids(), dtype=points.dtype)  # (T,2)
        d2 = jnp.sum((points[:, None, :] - cent[None, :, :]) ** 2, axis=-1)
        _, cand = jax.lax.top_k(-d2, self.k)  # (P,k) nearest first
        return _first_containing(self.mesh, cand, points)


@dataclasses.dataclass(frozen=True)
class GridLocator:
    """Uniform-grid binned locator with static padded candidate lists.

    Host-side precompute: each cell of a G×G grid over the bounding box
    stores the triangles whose exact overlap (separating-axis test) hits
    it (padded with -1).  Everything the hot query needs — candidate
    corner coordinates, triangle ids, corner node ids — is packed into
    ONE flat float row per cell (``rows``: (G², 10·C_max)), so the whole
    locate is a single 2-D row gather (one row per point instead of a
    multi-dimensional-result gather).  Ids ride as floats (exact up to
    2²⁴ in f32).  O(P·C_max).
    """

    mesh: Mesh
    cells: np.ndarray  # (G*G, C_max) int32, -1 padded
    rows: np.ndarray  # (G*G, 10*C_max): [6C coords | C tri ids | 3C corners]
    origin: tuple[float, float]
    extent: tuple[float, float]
    g: int

    @classmethod
    def build(cls, mesh: Mesh, g: int = 16, exact: bool = True) -> "GridLocator":
        """``exact=True`` prunes bbox candidates with a triangle-vs-cell
        separating-axis test — roughly halves C_max on thin triangles.
        Fully vectorized over (triangle, bbox-cell-offset) pairs: build is
        O(T · span²) NumPy, not a Python double loop."""
        lo = mesh.coords.min(axis=0)
        hi = mesh.coords.max(axis=0)
        extent = np.maximum(hi - lo, 1e-12)
        pc = mesh.coords[mesh.tris]  # (T,3,2)
        tmin = ((pc.min(axis=1) - lo) / extent * g).astype(int).clip(0, g - 1)
        tmax = ((pc.max(axis=1) - lo) / extent * g).astype(int).clip(0, g - 1)
        cell_w = extent / g

        pair_cells = []
        pair_tris = []
        max_dx = int((tmax[:, 0] - tmin[:, 0]).max()) + 1
        max_dy = int((tmax[:, 1] - tmin[:, 1]).max()) + 1
        tri_ids = np.arange(mesh.n_tris)
        for dx in range(max_dx):
            for dy in range(max_dy):
                cx = tmin[:, 0] + dx
                cy = tmin[:, 1] + dy
                sel = (cx <= tmax[:, 0]) & (cy <= tmax[:, 1])
                if not sel.any():
                    continue
                t_sel = tri_ids[sel]
                if exact:
                    c0 = lo + np.stack([cx[sel], cy[sel]], axis=1) * cell_w
                    keep = _tri_aabb_overlap_batch(pc[t_sel], c0, c0 + cell_w)
                    t_sel = t_sel[keep]
                    cx_k, cy_k = cx[sel][keep], cy[sel][keep]
                else:
                    cx_k, cy_k = cx[sel], cy[sel]
                pair_cells.append(cx_k * g + cy_k)
                pair_tris.append(t_sel)
        cell_ids = np.concatenate(pair_cells)
        tri_of = np.concatenate(pair_tris)
        order = np.lexsort((tri_of, cell_ids))  # ascending tri within cell
        cell_ids, tri_of = cell_ids[order], tri_of[order]
        counts = np.bincount(cell_ids, minlength=g * g)
        cmax = max(1, int(counts.max()))
        cells = np.full((g * g, cmax), -1, dtype=np.int32)
        slot = np.arange(len(cell_ids)) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        cells[cell_ids, slot] = tri_of
        rows = _pack_candidate_rows(mesh, cells)
        return cls(
            mesh=mesh, cells=cells, rows=rows,
            origin=tuple(lo), extent=tuple(extent), g=g,
        )

    def with_cmax(self, c_max: int) -> "GridLocator":
        """Same locator with candidate tables padded to ``c_max`` slots.

        Per-simulation-mesh ensembles stack locator tables on a batch
        axis, which requires a COMMON candidate width across meshes —
        pad every per-sim locator to the fleet-wide maximum.  Padding
        slots are -1 (never match the containment test)."""
        cur = self.cells.shape[1]
        assert c_max >= cur, (c_max, cur)
        if c_max == cur:
            return self
        cells = np.concatenate(
            [self.cells, np.full((self.cells.shape[0], c_max - cur), -1,
                                 dtype=np.int32)],
            axis=1,
        )
        return dataclasses.replace(
            self, cells=cells, rows=_pack_candidate_rows(self.mesh, cells)
        )

    def _gather_rows(self, points: jnp.ndarray):
        """(cand (P,C), tri_xy (P,C,3,2), corners (P,C,3)) via ONE gather."""
        return _gather_candidate_rows(
            jnp.asarray(self.rows, dtype=points.dtype),
            jnp.asarray(self.origin, dtype=points.dtype),
            jnp.asarray(self.extent, dtype=points.dtype),
            self.g,
            points,
        )

    def find(self, points: jnp.ndarray, return_weights: bool = False):
        row, c = _gather_flat_rows(
            jnp.asarray(self.rows, dtype=points.dtype),
            jnp.asarray(self.origin, dtype=points.dtype),
            jnp.asarray(self.extent, dtype=points.dtype),
            self.g,
            points,
        )
        cand, found, w, first, sel = _containment_flat(row, c, points)
        tri_ids = jnp.where(
            found, jnp.sum(jnp.where(sel, cand, 0), axis=1), 0
        )
        if return_weights:
            return tri_ids, found, w
        return tri_ids, found

    def find_full(self, points: jnp.ndarray):
        """→ (tri_ids, found, weights, corner node ids (P,3)) — everything
        the interpolation needs with no further geometry gathers."""
        row, c = _gather_flat_rows(
            jnp.asarray(self.rows, dtype=points.dtype),
            jnp.asarray(self.origin, dtype=points.dtype),
            jnp.asarray(self.extent, dtype=points.dtype),
            self.g,
            points,
        )
        cand, found, w, first, sel = _containment_flat(row, c, points)
        tri_ids = jnp.where(
            found, jnp.sum(jnp.where(sel, cand, 0), axis=1), 0
        )
        win = _select_corners_flat(row, c, sel)
        return tri_ids, found, w, win


def _section(row: jnp.ndarray, k: int, cmax: int) -> jnp.ndarray:
    """Section ``k`` of a section-major packed row → (P, C) contiguous
    block slice.  Contiguous slices stay fusible views, unlike an
    interleaved ``(P,C,3,2)`` reshape or stride-6 slices."""
    return row[:, k * cmax : (k + 1) * cmax]


def _containment_flat(row: jnp.ndarray, cmax: int, points: jnp.ndarray):
    """Containment test straight off the flat packed row (no reshapes).

    ``row`` is (P, 10·C) section-major as packed by
    :func:`_pack_candidate_rows` ([x1|y1|x2|y2|x3|y3|ids|c1|c2|c3]);
    returns (cand (P,C), found (P,), w_sel (P,3), first (P,), sel (P,C))
    with semantics identical to :func:`_first_containing` over the same
    candidates (same barycentric formulation, StokesColor.py:334-342)."""
    x1, y1 = _section(row, 0, cmax), _section(row, 1, cmax)
    x2, y2 = _section(row, 2, cmax), _section(row, 3, cmax)
    x3, y3 = _section(row, 4, cmax), _section(row, 5, cmax)
    x, y = points[:, 0:1], points[:, 1:2]
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    safe = jnp.where(jnp.abs(det) < _DEG_TOL, 1.0, det)
    w1 = ((x2 - x) * (y3 - y) - (x3 - x) * (y2 - y)) / safe
    w2 = ((x3 - x) * (y1 - y) - (x1 - x) * (y3 - y)) / safe
    w3 = 1.0 - w1 - w2
    cand = _section(row, 6, cmax).astype(jnp.int32)
    inside = (
        (w1 >= 0.0) & (w2 >= 0.0) & (w3 >= 0.0)
        & (jnp.abs(det) >= _DEG_TOL) & (cand >= 0)
    )
    first = jnp.argmax(inside, axis=1)
    found = jnp.any(inside, axis=1)
    sel = (
        jax.lax.broadcasted_iota(jnp.int32, inside.shape, 1) == first[:, None]
    )
    zero = jnp.zeros((), w1.dtype)
    w_sel = jnp.stack(
        [jnp.sum(jnp.where(sel, wk, zero), axis=1) for wk in (w1, w2, w3)],
        axis=-1,
    )
    return cand, found, w_sel, first, sel


def _gather_candidate_rows(rows, origin, extent, g: int, points):
    """Pure-array core of the packed-row candidate gather — usable under
    ``vmap`` with stacked per-simulation tables (``rows`` (G², 10·C),
    traced ``origin``/``extent``).  Returns (cand (P,C), tri_xy (P,C,3,2),
    corner node ids (P,C,3))."""
    row, c = _gather_flat_rows(rows, origin, extent, g, points)
    tri_xy = jnp.stack(
        [
            jnp.stack([_section(row, 2 * j, c), _section(row, 2 * j + 1, c)],
                      axis=-1)
            for j in range(3)
        ],
        axis=2,
    )  # (P, C, 3, 2)
    cand = _section(row, 6, c).astype(jnp.int32)
    corners = jnp.stack(
        [_section(row, 7 + j, c) for j in range(3)], axis=-1
    ).astype(jnp.int32)  # (P, C, 3)
    return cand, tri_xy, corners


def _gather_flat_rows(rows, origin, extent, g: int, points):
    """ONE flat row gather per query batch → ((P, 10·C) rows, C)."""
    c = rows.shape[1] // 10
    ij = jnp.clip(((points - origin) / extent * g).astype(jnp.int32), 0, g - 1)
    cell = ij[:, 0] * g + ij[:, 1]
    return rows[cell], c


def _select_corners_flat(row, cmax: int, sel: jnp.ndarray) -> jnp.ndarray:
    """Winning candidate's corner node ids (P,3) from the flat row."""
    zero = jnp.zeros((), row.dtype)
    return jnp.stack(
        [
            jnp.sum(jnp.where(sel, _section(row, 7 + j, cmax), zero), axis=1)
            for j in range(3)
        ],
        axis=-1,
    ).astype(jnp.int32)


def _pack_candidate_rows(mesh: Mesh, cells: np.ndarray) -> np.ndarray:
    """Pack per-cell candidate data into flat rows (G², 10·C),
    SECTION-major: [x1|y1|x2|y2|x3|y3|tri ids|c1|c2|c3], each section C
    wide — so every hot-path access (:func:`_containment_flat`) is a
    contiguous column-block slice of the gathered row."""
    n_cells, cmax = cells.shape
    # id sections ride in the float row and are cast to the query dtype at
    # gather time — under f32 integers are exact only below 2^24, beyond
    # which ids would silently corrupt: fail loudly instead
    assert max(mesh.n_tris, mesh.n_nodes) < 2**24, (
        f"packed locator rows store ids as floats: n_tris={mesh.n_tris}, "
        f"n_nodes={mesh.n_nodes} exceed the 2^24 f32-exact integer range"
    )
    pc = mesh.coords[mesh.tris]  # (T,3,2)
    cell_xy = np.zeros((n_cells, cmax, 3, 2))
    valid = cells >= 0
    cell_xy[valid] = pc[cells[valid]]
    corners = np.zeros((n_cells, cmax, 3))
    corners[valid] = mesh.tris[cells[valid]]
    sections = [cell_xy[:, :, j, d] for j in range(3) for d in range(2)]
    sections.append(cells.astype(np.float64))
    sections.extend(corners[:, :, j] for j in range(3))
    return np.concatenate(sections, axis=1)


@dataclasses.dataclass(frozen=True)
class BatchedGridLocator:
    """Stacked per-simulation :class:`GridLocator` tables.

    Per-simulation-mesh ensembles (``parallel.spmd.MultiMeshEnsemble``)
    carry one mesh per batch entry; their locator tables natively have
    per-mesh candidate widths and grid resolutions.  ``build`` forces one
    grid resolution across the fleet and pads every candidate table to the
    fleet-wide C_max (:meth:`GridLocator.with_cmax`), so all hot-path
    tables stack on a leading batch axis and the batched transport
    functions below are plain ``vmap``s.

    The packed rows already carry everything transport needs per candidate
    (corner coords, tri ids, corner node ids), so no per-sim triangle
    table is required — triangle counts may differ across sims.
    """

    rows: np.ndarray  # (B, G², 10·C_max)
    origins: np.ndarray  # (B, 2)
    extents: np.ndarray  # (B, 2)
    coords: np.ndarray  # (B, N, 2) per-sim node coordinates (common N)
    g: int

    @classmethod
    def build(cls, meshes, g: int = 0, exact: bool = True) -> "BatchedGridLocator":
        if not g:
            g = int(np.clip(2 * np.sqrt(max(m.n_tris for m in meshes)), 8, 128))
        locs = [GridLocator.build(m, g=g, exact=exact) for m in meshes]
        c_max = max(loc.cells.shape[1] for loc in locs)
        locs = [loc.with_cmax(c_max) for loc in locs]
        return cls(
            rows=np.stack([loc.rows for loc in locs]),
            origins=np.stack([loc.origin for loc in locs]),
            extents=np.stack([loc.extent for loc in locs]),
            coords=np.stack([m.coords for m in meshes]),
            g=g,
        )

    def tables(self, dtype) -> tuple:
        """(rows, origins, extents, coords) as device arrays of ``dtype`` —
        the argument pack of the batched transport functions (pass these
        through ``shard_map`` with a ``P("data")`` spec)."""
        return (
            jnp.asarray(self.rows, dtype=dtype),
            jnp.asarray(self.origins, dtype=dtype),
            jnp.asarray(self.extents, dtype=dtype),
            jnp.asarray(self.coords, dtype=dtype),
        )


def _locate_winner(rows, origin, extent, g: int, pts):
    """Locate pts in one sim's packed tables → (found (P,), w (P,3),
    win_xy (P,3,2), corner node ids (P,3)) — winner data straight from the
    candidate rows, no triangle-table gathers."""
    row, c = _gather_flat_rows(rows, origin, extent, g, pts)
    _, found, w, _, sel = _containment_flat(row, c, pts)
    zero = jnp.zeros((), row.dtype)
    win_xy = jnp.stack(
        [
            jnp.stack(
                [
                    jnp.sum(
                        jnp.where(sel, _section(row, 2 * j + d, c), zero),
                        axis=1,
                    )
                    for d in range(2)
                ],
                axis=-1,
            )
            for j in range(3)
        ],
        axis=1,
    )  # (P,3,2)
    corner = _select_corners_flat(row, c, sel)
    return found, w, win_xy, corner


def advect_semilagrange_batched(
    rows, origins, extents, coords, g: int, c, u, dt: float,
    L: float = 1.0, H: float = 1.0,
):
    """Batched :func:`advect_semilagrange` over per-sim meshes/locators.

    All tables carry a leading batch axis (see
    :meth:`BatchedGridLocator.tables`); ``c`` is (B, N), ``u`` (B, N, 2).
    Per-sim semantics identical to the single-mesh path (single Euler
    back-trace, x wrap, y clamp, non-periodic containment test,
    periodic-x barycentric weights, keep-on-miss).
    """
    eps = 1e-12

    def one(rows_i, origin_i, extent_i, coords_i, c_i, u_i):
        xb = jnp.mod(coords_i[:, 0] - dt * u_i[:, 0], L)
        yb = coords_i[:, 1] - dt * u_i[:, 1]
        yb = jnp.where(yb < 0.0, eps, yb)
        yb = jnp.where(yb > H, H - eps, yb)
        pts = jnp.stack([xb, yb], axis=1)
        found, _, win_xy, corner = _locate_winner(
            rows_i, origin_i, extent_i, g, pts
        )
        x1, y1 = win_xy[:, 0, 0], win_xy[:, 0, 1]
        x2, y2 = win_xy[:, 1, 0], win_xy[:, 1, 1]
        x3, y3 = win_xy[:, 2, 0], win_xy[:, 2, 1]
        det = _periodic_dx(x2, x1, L) * (y3 - y1) - _periodic_dx(x3, x1, L) * (
            y2 - y1
        )
        safe = jnp.where(jnp.abs(det) < _DEG_TOL, 1.0, det)
        w1 = (
            _periodic_dx(x2, xb, L) * (y3 - yb)
            - _periodic_dx(x3, xb, L) * (y2 - yb)
        ) / safe
        w2 = (
            _periodic_dx(x3, xb, L) * (y1 - yb)
            - _periodic_dx(x1, xb, L) * (y3 - yb)
        ) / safe
        w3 = 1.0 - w1 - w2
        c_new = (
            w1 * c_i[corner[:, 0]]
            + w2 * c_i[corner[:, 1]]
            + w3 * c_i[corner[:, 2]]
        )
        return jnp.where(found, c_new, c_i)

    return jax.vmap(one)(rows, origins, extents, coords, c, u)


def tracer_step_batched(
    rows, origins, extents, g: int, points, u, dt: float,
    L: float = 1.0, method: str = "euler",
):
    """Batched :func:`tracer_step` over per-sim meshes/locators:
    ``points`` (B, P, 2), ``u`` (B, N, 2) → new points (B, P, 2)."""

    def sample(rows_i, origin_i, extent_i, u_i, pts):
        found, w, _, corner = _locate_winner(rows_i, origin_i, extent_i, g, pts)
        vel = jnp.einsum("pi,pid->pd", w, u_i[corner], precision=_HI)
        return jnp.where(found[:, None], vel, 0.0)

    def one(rows_i, origin_i, extent_i, pts_i, u_i):
        vel = sample(rows_i, origin_i, extent_i, u_i, pts_i)
        if method == "rk2":
            mid = pts_i + 0.5 * dt * vel
            mid = mid.at[:, 0].set(jnp.mod(mid[:, 0], L))
            vel = sample(rows_i, origin_i, extent_i, u_i, mid)
        new = pts_i + dt * vel
        return new.at[:, 0].set(jnp.mod(new[:, 0], L))

    return jax.vmap(one)(rows, origins, extents, points, u)


def _tri_aabb_overlap_batch(tri: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Batched 2D separating-axis test: triangles (B,3,2) vs boxes (B,2).

    Returns (B,) bool.  Axes tested: x, y, and the 3 edge normals of each
    triangle; a pair overlaps iff no axis separates the projections."""
    b = tri.shape[0]
    box = np.stack(
        [
            np.stack([lo[:, 0], lo[:, 1]], axis=1),
            np.stack([hi[:, 0], lo[:, 1]], axis=1),
            np.stack([hi[:, 0], hi[:, 1]], axis=1),
            np.stack([lo[:, 0], hi[:, 1]], axis=1),
        ],
        axis=1,
    )  # (B,4,2)
    edges = tri[:, [1, 2, 0]] - tri  # (B,3,2)
    normals = np.stack([-edges[..., 1], edges[..., 0]], axis=2)  # (B,3,2)
    xy = np.broadcast_to(np.eye(2), (b, 2, 2))
    axes = np.concatenate([xy, normals], axis=1)  # (B,5,2)
    t_proj = np.einsum("bvd,bad->bav", tri, axes)  # (B,5,3)
    b_proj = np.einsum("bvd,bad->bav", box, axes)  # (B,5,4)
    sep = (t_proj.max(axis=2) < b_proj.min(axis=2) - 1e-15) | (
        b_proj.max(axis=2) < t_proj.min(axis=2) - 1e-15
    )
    return ~sep.any(axis=1)


_TRI_XY_CACHE: dict = {}


def _tri_xy_table(mesh: Mesh) -> np.ndarray:
    """(T, 3, 2) corner coordinates, cached — one gather instead of the
    tris[cand] → coords[...] double indirection in the hot locate path."""
    key = id(mesh)
    hit = _TRI_XY_CACHE.get(key)
    if hit is None or hit[0] is not mesh:
        hit = (mesh, mesh.coords[mesh.tris])
        _TRI_XY_CACHE[key] = hit
    return hit[1]


def _first_containing(mesh: Mesh, cand: jnp.ndarray, points: jnp.ndarray,
                      return_weights: bool = False, tri_xy=None,
                      return_slot: bool = False):
    """Among per-point candidate triangle lists, pick the first containing
    triangle (w ≥ 0 on all corners, |det| ≥ 1e-14), like the reference.
    ``return_weights=True`` also returns the winning barycentric weights
    (already computed during the containment test — saves the hot path a
    second gather + recompute).  ``tri_xy`` may supply pre-gathered
    candidate corners (P,k,3,2)."""
    safe_cand = jnp.maximum(cand, 0)
    if tri_xy is None:
        tri_xy = jnp.asarray(_tri_xy_table(mesh), dtype=points.dtype)[safe_cand]
    w, det = _barycentric(tri_xy, points[:, None, :])
    inside = jnp.all(w >= 0.0, axis=-1) & (jnp.abs(det) >= _DEG_TOL) & (cand >= 0)
    first = jnp.argmax(inside, axis=1)  # first True (or 0 if none)
    found = jnp.any(inside, axis=1)
    tri_ids = _select_slot(safe_cand, first)
    tri_ids = jnp.where(found, tri_ids, 0)
    if return_weights:
        w_sel = _select_slot(w, first)
        if return_slot:
            return tri_ids, found, w_sel, first
        return tri_ids, found, w_sel
    return tri_ids, found


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


# triangle-major field re-pack (one (T,3[,D]) gather per interpolate
# call) beats per-point corner gathers only while T is small; above this
# the O(T) re-pack dominates the whole step at XL mesh sizes
_TRI_MAJOR_MAX_TRIS = 65536


def interpolate(mesh: Mesh, field: jnp.ndarray, points: jnp.ndarray, locator):
    """Linear (P1) interpolation of a nodal field at arbitrary points.

    Equivalent of ``mtri.LinearTriInterpolator`` (code/StokesFood.py:482-486)
    but batched on device; returns (values, found) where values are 0 for
    points outside the mesh (the reference's masked array likewise
    contributes nothing to the tracer update).
    """
    if (
        isinstance(locator, GridLocator)
        and mesh.n_tris > _TRI_MAJOR_MAX_TRIS
    ):
        # large-mesh form: the packed row already carries the winner's
        # corner NODE ids (find_full), so the field access is three O(P)
        # row gathers — the triangle-major re-pack below is O(T) *per
        # interpolate call*, which dominates the step at 10⁶ triangles
        _, found, w, corners = locator.find_full(points)
        ci = corners.astype(jnp.int32)
        f2 = field if field.ndim > 1 else field[:, None]
        vals = (
            w[:, 0:1] * f2[ci[:, 0]]
            + w[:, 1:2] * f2[ci[:, 1]]
            + w[:, 2:3] * f2[ci[:, 2]]
        )
        vals = vals if field.ndim > 1 else vals[:, 0]
        mask = found if vals.ndim == 1 else found[:, None]
        return jnp.where(mask, vals, 0.0), found
    if hasattr(locator, "find") and isinstance(locator, GridLocator):
        tri_ids, found, w = locator.find(points, return_weights=True)
    else:
        tri_ids, found = locator.find(points)
        tri_xy = jnp.asarray(_tri_xy_table(mesh), dtype=points.dtype)[tri_ids]
        w, _ = _barycentric(tri_xy, points)
    # gather the field triangle-major: one SMALL (T-row) gather re-packs the
    # nodal field per triangle, then the per-point access is a flat 2-D row
    # gather — avoids the slow multi-dim-result node gather (see GridLocator);
    # right when T is small (the reference-mesh regime), O(T)-wrong when T
    # is millions — the corner-gather branch above takes over there
    tri_field = field[jnp.asarray(mesh.tris)]  # (T,3) or (T,3,D)
    flat = tri_field.reshape(mesh.n_tris, -1)  # (T, 3D)
    per_pt = flat[tri_ids].reshape((points.shape[0],) + tri_field.shape[1:])
    vals = jnp.einsum("pi,pi...->p...", w, per_pt, precision=_HI)
    mask = found if vals.ndim == 1 else found[:, None]
    return jnp.where(mask, vals, 0.0), found


# ---------------------------------------------------------------------------
# Semi-Lagrangian dye advection (periodic in x)
# ---------------------------------------------------------------------------


def _periodic_dx(a, b, L=1.0):
    """Shortest periodic x-distance (StokesColor.py:352-357)."""
    d = a - b
    d = jnp.where(d > 0.5 * L, d - L, d)
    d = jnp.where(d < -0.5 * L, d + L, d)
    return d


def advect_semilagrange(
    mesh: Mesh,
    locator,
    c: jnp.ndarray,
    u: jnp.ndarray,
    dt: float,
    L: float = 1.0,
    H: float = 1.0,
) -> jnp.ndarray:
    """One semi-Lagrangian step of nodal dye c under velocity u.

    Parity with ``advect_semilagrange`` (StokesColor.py:347-389): single
    Euler back-trace, x wrapped mod L, y clamped to (0, H); host triangle
    located with the *non-periodic* containment test; interpolation weights
    computed with periodic-aware x-distances; nodes whose departure point
    is not found keep their old value.
    """
    eps = 1e-12
    coords = jnp.asarray(mesh.coords, dtype=c.dtype)
    xb = jnp.mod(coords[:, 0] - dt * u[:, 0], L)
    yb = coords[:, 1] - dt * u[:, 1]
    yb = jnp.where(yb < 0.0, eps, yb)
    yb = jnp.where(yb > H, H - eps, yb)
    pts = jnp.stack([xb, yb], axis=1)

    if isinstance(locator, GridLocator):
        # winner corners/coords straight off the packed candidate row —
        # avoids two multi-dim table gathers (tris[ids], tri_xy[ids])
        found, _, pxy, corner = _locate_winner(
            jnp.asarray(locator.rows, dtype=c.dtype),
            jnp.asarray(locator.origin, dtype=c.dtype),
            jnp.asarray(locator.extent, dtype=c.dtype),
            locator.g,
            pts,
        )
    else:
        tri_ids, found = locator.find(pts)
        corner = jnp.asarray(mesh.tris)[tri_ids]  # (N,3)
        pxy = jnp.asarray(_tri_xy_table(mesh), dtype=c.dtype)[tri_ids]  # (N,3,2)
    x1, y1 = pxy[:, 0, 0], pxy[:, 0, 1]
    x2, y2 = pxy[:, 1, 0], pxy[:, 1, 1]
    x3, y3 = pxy[:, 2, 0], pxy[:, 2, 1]
    det = _periodic_dx(x2, x1, L) * (y3 - y1) - _periodic_dx(x3, x1, L) * (y2 - y1)
    safe = jnp.where(jnp.abs(det) < _DEG_TOL, 1.0, det)
    w1 = (_periodic_dx(x2, xb, L) * (y3 - yb) - _periodic_dx(x3, xb, L) * (y2 - yb)) / safe
    w2 = (_periodic_dx(x3, xb, L) * (y1 - yb) - _periodic_dx(x1, xb, L) * (y3 - yb)) / safe
    w3 = 1.0 - w1 - w2
    c_new = w1 * c[corner[:, 0]] + w2 * c[corner[:, 1]] + w3 * c[corner[:, 2]]
    return jnp.where(found, c_new, c)


# ---------------------------------------------------------------------------
# Passive tracers + capture (food) statistics
# ---------------------------------------------------------------------------


def init_tracer_grid(
    grid_density: int = 25,
    L: float = 1.0,
    H: float = 1.0,
    margin: float = 0.05,
    exclude_center=(0.5, 0.5),
    exclude_radius: float = 0.25,
) -> np.ndarray:
    """(P, 2) tracer seed grid minus the cylinder interior
    (code/StokesFood.py:420-429)."""
    xx = np.linspace(margin, L - margin, grid_density)
    yy = np.linspace(margin, H - margin, grid_density)
    gx, gy = np.meshgrid(xx, yy)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    d = np.hypot(pts[:, 0] - exclude_center[0], pts[:, 1] - exclude_center[1])
    return pts[d > exclude_radius]


def tracer_step(
    mesh: Mesh,
    locator,
    points: jnp.ndarray,
    u: jnp.ndarray,
    dt: float,
    L: float = 1.0,
    method: str = "euler",
):
    """Advance tracer points one step through nodal velocity u.

    ``euler`` matches the reference (StokesFood.py:482-490): sample u at the
    point, explicit Euler, wrap x.  ``rk2`` is a midpoint upgrade.
    """
    vel, _ = interpolate(mesh, u, points, locator)
    if method == "rk2":
        mid = points + 0.5 * dt * vel
        mid = mid.at[:, 0].set(jnp.mod(mid[:, 0], L))
        vel, _ = interpolate(mesh, u, mid, locator)
    new = points + dt * vel
    return new.at[:, 0].set(jnp.mod(new[:, 0], L))


def capture_update(
    points: jnp.ndarray,
    status: jnp.ndarray,
    center=(0.5, 0.5),
    radius: float = 0.28,
) -> jnp.ndarray:
    """Mark tracers within ``radius`` of ``center`` as eaten (status=1).

    Cf. StokesFood.py:492-499 (CAPTURE_RADIUS = squirmer radius + 0.03).
    """
    c = jnp.asarray(center, dtype=points.dtype)
    d = jnp.linalg.norm(points - c, axis=1)
    return jnp.where(d <= radius, 1, status).astype(status.dtype)


# ---------------------------------------------------------------------------
# Mixing diagnostics
# ---------------------------------------------------------------------------


def mixing_index(c: jnp.ndarray, mass: jnp.ndarray, mask: jnp.ndarray | None = None):
    """Danckwerts intensity of segregation I = Var_w(c) / (μ(1−μ)).

    Cf. ``code/StokesColor.py:391-403``.  ``mask`` may be a boolean (N,)
    array (weights of excluded nodes are zeroed — shape-static, unlike the
    reference's fancy indexing, but numerically identical).
    """
    if mask is not None:
        mass = jnp.where(mask, mass, 0.0)
    W = jnp.sum(mass)
    mu = jnp.sum(mass * c) / W
    var = jnp.sum(mass * (c - mu) ** 2) / W
    I = var / (mu * (1.0 - mu) + 1e-16)
    return I, mu, var
