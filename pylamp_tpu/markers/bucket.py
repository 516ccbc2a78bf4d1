"""Dense bucketed marker engine — the production marker representation.

The flat marker pipeline (markers/interp.py, markers/advect.py) needs ~40
scatter/gather operations over all markers per step.  This module implements
the capacity/padding strategy prescribed in SURVEY.md §7.3 item 2: markers
live in a dense (ny, nx, K) layout bucketed by their owning grid cell, and
EVERY marker operation — marker->grid transfer, grid->marker interpolation,
RK4 advection, re-bucketing after advection, reseeding — is expressed as
dense shifted-slice arithmetic over the K axis.  No scatter, no gather, no
sort anywhere in the hot loop.

Key facts the design rests on:
- a marker in grid cell (j, i) interacts with nodes of any staggered
  sub-lattice that lie within cell offsets {-1..+1} (and {-1..+2} for RK4
  stage positions displaced by up to one Courant number), so transfers are
  sums over a small static set of neighbor shifts with per-marker masks;
- with Courant <= 1 a marker moves at most one cell per step, so
  re-bucketing only exchanges with the 3x3 cell neighborhood: one
  sequential pass over the 9K candidate slots re-packs every bucket with
  one-hot inserts (dense fma over K lanes).  A sort-compaction rebucket
  (per-slab lax.sort + take_along_axis merge) is bit-identical; which of
  the two is faster on the GPU has not been measured;
- empty slots are masked by `valid`; per-cell capacity overflow drops the
  latest arrivals deterministically and is reported in diagnostics.

Stretched (non-uniform) grids are supported with the same dense-shift
structure: the position -> (node interval, local coord) map becomes a
WINDOWED locate (`_axis_locate`) — the containing interval is within a
small static offset window of the marker's bucket cell, so it resolves
with a handful of comparisons/selects against host-shifted per-cell node
coordinate rows.  Still no gather, no sort.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid

ARITHMETIC = "arithmetic"
GEOMETRIC = "geometric"
HARMONIC = "harmonic"


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BucketedMarkers:
    """Markers bucketed by owning grid cell: all arrays (ny, nx, K)."""

    x: jnp.ndarray
    y: jnp.ndarray
    mat: jnp.ndarray  # int32
    T: jnp.ndarray
    valid: jnp.ndarray  # bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self):
        return jnp.sum(self.valid, axis=-1)

    def total(self):
        return jnp.sum(self.valid)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# -- construction ---------------------------------------------------------------

def bucket_from_flat(x, y, mat, T, grid: StaggeredGrid, capacity: int):
    """One-time setup conversion (uses XLA scatter; not in the hot loop)."""
    ny, nx = grid.ny, grid.nx
    if grid.uniform:
        i = jnp.clip((x / grid.dx).astype(jnp.int32), 0, nx - 1)
        j = jnp.clip((y / grid.dy).astype(jnp.int32), 0, ny - 1)
    else:
        xe = jnp.asarray(grid.x_corner, x.dtype)
        ye = jnp.asarray(grid.y_corner, y.dtype)
        i = jnp.clip(
            jnp.searchsorted(xe, x, side="right").astype(jnp.int32) - 1,
            0, nx - 1,
        )
        j = jnp.clip(
            jnp.searchsorted(ye, y, side="right").astype(jnp.int32) - 1,
            0, ny - 1,
        )
    cid = j * nx + i
    order = jnp.argsort(cid)
    cid_s = cid[order]
    # rank within cell
    seg_start = jnp.searchsorted(cid_s, jnp.arange(nx * ny))
    rank = jnp.arange(x.shape[0]) - seg_start[cid_s]
    keep = rank < capacity
    flat_idx = cid_s * capacity + jnp.minimum(rank, capacity - 1)

    def fill(vals, init, dtype):
        out = jnp.full((ny * nx * capacity,), init, dtype)
        v = vals[order]
        out = out.at[flat_idx].set(jnp.where(keep, v, out[flat_idx]))
        return out.reshape(ny, nx, capacity)

    bx = fill(x, 0.0, x.dtype)
    by = fill(y, 0.0, y.dtype)
    bm = fill(mat, 0, jnp.int32)
    bT = fill(T, 0.0, T.dtype)
    vflat = jnp.zeros((ny * nx * capacity,), bool).at[flat_idx].set(keep)
    return BucketedMarkers(x=bx, y=by, mat=bm, T=bT, valid=vflat.reshape(ny, nx, capacity))


def flatten(bm: BucketedMarkers):
    """(x, y, mat, T, valid) as flat arrays (for IO/diagnostics)."""
    return (
        bm.x.reshape(-1),
        bm.y.reshape(-1),
        bm.mat.reshape(-1),
        bm.T.reshape(-1),
        bm.valid.reshape(-1),
    )


# -- local coordinates on a target sub-lattice -----------------------------------

def _node_rows(nodes, ncells: int, rlo: int, rhi: int):
    """Host-side shifted node-coordinate rows for the windowed locate:
    ``rows[r][i] = nodes[i + r]`` per cell index i, with -inf below / +inf
    above the array so out-of-range comparisons resolve the right way."""
    import numpy as np

    nodes = np.asarray(nodes, np.float64)
    m = nodes.shape[0]
    rows = {}
    for r in range(rlo, rhi + 2):
        idx = np.arange(ncells) + r
        rows[r] = np.where(
            idx < 0,
            -np.inf,
            np.where(idx > m - 1, np.inf, nodes[np.clip(idx, 0, m - 1)]),
        )
    return rows


def _axis_locate(pos, nodes, rlo: int, rhi: int, axis: int):
    """Windowed gather-free locate on a stretched axis.

    For positions (ny, nx, K) whose containing node interval ``i0``
    (``nodes[i0] <= pos < nodes[i0+1]``) is known to satisfy
    ``i0 - cell_idx in [rlo, rhi]`` (``cell_idx`` = the bucket index along
    ``axis``), return (i0 clipped to [0, len(nodes)-2], local coord t in
    [0,1]).  Pure comparisons/selects against host-shifted per-cell node
    rows — no gather, matching the dense-shift engine's constraints."""
    ncells = pos.shape[axis]
    m = len(nodes)
    rows = _node_rows(nodes, ncells, rlo, rhi)

    def bc(v):
        shp = [1, 1, 1]
        shp[axis] = ncells
        return jnp.asarray(v, pos.dtype).reshape(shp)

    base = lax.broadcasted_iota(jnp.int32, pos.shape, axis)
    i0 = base + rlo
    for r in range(rlo + 1, rhi + 1):
        i0 = i0 + (pos >= bc(rows[r])).astype(jnp.int32)
    i0 = jnp.clip(i0, 0, m - 2)
    o = i0 - base
    lo = jnp.zeros(pos.shape, pos.dtype)
    hi = jnp.zeros(pos.shape, pos.dtype)
    for r in range(rlo, rhi + 1):
        sel = o == r
        lo = jnp.where(sel, bc(rows[r]), lo)
        hi = jnp.where(sel, bc(rows[r + 1]), hi)
    t = jnp.clip((pos - lo) / (hi - lo), 0.0, 1.0)
    return i0, t


def _lattice_local(bm_x, bm_y, grid: StaggeredGrid, loc: str,
                   periodic_x: bool = False, window: int = 1):
    """Per-marker (o_j, o_i, ty, tx) relative to the marker's OWN grid cell:
    the target-lattice cell containing the marker starts at bucket-cell
    offset (o_j, o_i); (ty, tx) in [0,1] are the local coordinates.  Clamped
    exactly like the flat path's _locate (interp.py).

    ``periodic_x``: no x clamp — markers near the seam keep their natural
    i0 (can be -1 on the half-offset lattices); the wrap happens where the
    cell sums land on node columns (mod nx).

    ``window``: positions may be displaced up to ``window - 1`` cells from
    their bucket cell (RK4 stage positions); only consulted on stretched
    grids, where the locate is windowed rather than global."""
    oy, ox = grid.origin(loc) if grid.uniform else (None, None)
    ny_n, nx_n = grid.shape(loc)
    if not grid.uniform:
        if periodic_x:
            raise ValueError("periodic side walls need a uniform grid")
        ys, xs = grid.coords(loc)
        # nodes at cell edges -> an in-cell marker's interval IS its cell;
        # nodes at centers -> offset -1 or 0. Widen by the displacement.
        w = window
        xlo, xhi = (-(w - 1), w - 1) if loc in ("corner", "vx") else (-w, w - 1)
        ylo, yhi = (-(w - 1), w - 1) if loc in ("corner", "vy") else (-w, w - 1)
        i0, tx = _axis_locate(bm_x, xs, xlo, xhi, axis=1)
        j0, ty = _axis_locate(bm_y, ys, ylo, yhi, axis=0)
        ci = lax.broadcasted_iota(jnp.int32, bm_x.shape, 1)
        cj = lax.broadcasted_iota(jnp.int32, bm_x.shape, 0)
        return j0 - cj, i0 - ci, ty, tx
    fx = (bm_x - ox) / grid.dx
    fy = (bm_y - oy) / grid.dy
    if periodic_x:
        i0 = jnp.floor(fx).astype(jnp.int32)
    else:
        i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx_n - 2)
    j0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny_n - 2)
    tx = jnp.clip(fx - i0, 0.0, 1.0)
    ty = jnp.clip(fy - j0, 0.0, 1.0)
    # bucket cell indices (broadcast over K)
    ci = lax.broadcasted_iota(jnp.int32, bm_x.shape, 1)
    cj = lax.broadcasted_iota(jnp.int32, bm_x.shape, 0)
    return j0 - cj, i0 - ci, ty, tx


def _weights(ty, tx):
    return (
        (1.0 - ty) * (1.0 - tx),
        (1.0 - ty) * tx,
        ty * (1.0 - tx),
        ty * tx,
    )


def _shift2d(f, a, b):
    """f[j+a, i+b] with zero padding out of range; f is (ny_n, nx_n)."""
    ny, nx = f.shape
    return jnp.pad(f, ((max(-a, 0), max(a, 0)), (max(-b, 0), max(b, 0))))[
        max(a, 0) : max(a, 0) + ny, max(b, 0) : max(b, 0) + nx
    ]


def _shift2d_px(f, a, b):
    """f[j+a, (i+b) mod nx]: zero-padded in y, wrap-around in x."""
    ny, _ = f.shape
    t = jnp.roll(f, -b, axis=1)
    return jnp.pad(t, ((max(-a, 0), max(a, 0)), (0, 0)))[
        max(a, 0) : max(a, 0) + ny, :
    ]


def _cells_to_nodes_px(s, a, b, ny_n):
    """Periodic-x scatter of cell-indexed partial sums (ny, nx) onto the
    unique node columns: node (j+a, (i+b) mod nx) += s[j, i].  Returns the
    (ny_n, nx) unique-column node array for this (a, b) offset."""
    ny, nx = s.shape
    rolled = jnp.roll(s, b, axis=1)  # node col m <- cell col (m - b) mod nx
    r0 = max(a, 0)
    j0 = max(-a, 0)
    n = min(ny - j0, ny_n - r0)
    out = jnp.zeros((ny_n, nx), s.dtype)
    return out.at[r0 : r0 + n, :].set(rolled[j0 : j0 + n, :])


def _wrap_x(px, lx):
    """Wrap x positions into [0, lx)."""
    return px - lx * jnp.floor(px / lx)


# -- marker -> grid ---------------------------------------------------------------

def bucket_markers_to_grid(
    bm: BucketedMarkers,
    values,  # (ny, nx, K)
    grid: StaggeredGrid,
    loc: str,
    mode: str = ARITHMETIC,
    periodic_x: bool = False,
):
    """Weighted mean of marker values on the ``loc`` sub-lattice.
    Returns (field, wsum) like markers_to_grid.

    ``periodic_x``: accumulation wraps in x (period nx); lattices with a
    duplicated seam column return EQUAL full values in columns 0 and nx."""
    ny_n, nx_n = grid.shape(loc)
    o_j, o_i, ty, tx = _lattice_local(bm.x, bm.y, grid, loc, periodic_x)
    ws = _weights(ty, tx)

    vmask = bm.valid
    # Sanitize empty slots BEFORE the nonlinear transform: they hold zeros,
    # and log(0)/-inf or 1/0 would turn the masked 0-weight products into
    # NaN (0 * inf).
    safe = jnp.where(vmask, values, 1.0)
    if mode == ARITHMETIC:
        v = jnp.where(vmask, values, 0.0)
    elif mode == GEOMETRIC:
        v = jnp.log(safe)
    elif mode == HARMONIC:
        v = 1.0 / safe
    else:
        raise ValueError(f"unknown averaging mode {mode!r}")
    # Accumulate per-cell partial sums S_ab for node offset (a, b) relative
    # to the bucket cell; node (j+a, i+b) receives weight w[dj,di] from
    # markers with o_j + dj == a and o_i + di == b.
    corners = ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]), (1, 1, ws[3]))
    nxu = grid.nx if periodic_x else nx_n  # unique node columns
    field_wv = jnp.zeros((ny_n, nxu), v.dtype)
    field_w = jnp.zeros((ny_n, nxu), v.dtype)
    # o in {-1, 0, +1} covers every sub-lattice (clamping keeps it there)
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            # One K-reduction per sum and offset, of the four corner weights
            # added first: XLA:GPU fuses these small reductions into the
            # shifting consumers, and with one reduction per corner the
            # fused kernels spilled registers and took minutes to compile.
            wsel = 0.0
            for dj, di, w in corners:
                sel = (o_j + dj == a) & (o_i + di == b) & vmask
                wsel = wsel + jnp.where(sel, w, 0.0)
            s_wv = jnp.sum(wsel * v, axis=-1)
            s_w = jnp.sum(wsel, axis=-1)
            if periodic_x:
                field_wv = field_wv + _cells_to_nodes_px(s_wv, a, b, ny_n)
                field_w = field_w + _cells_to_nodes_px(s_w, a, b, ny_n)
                continue
            # cell (j,i) contributes to node (j+a, i+b): node array gets the
            # cell array shifted by (-a, -b)
            pad_wv = jnp.zeros((ny_n, nx_n), v.dtype)
            pad_wv = pad_wv.at[: grid.ny, : grid.nx].set(s_wv)
            pad_w = jnp.zeros((ny_n, nx_n), v.dtype)
            pad_w = pad_w.at[: grid.ny, : grid.nx].set(s_w)
            field_wv = field_wv + _shift2d(pad_wv, -a, -b)
            field_w = field_w + _shift2d(pad_w, -a, -b)

    if periodic_x and nx_n == grid.nx + 1:
        # duplicate the seam column (full equal values, solution-like)
        field_wv = jnp.concatenate([field_wv, field_wv[:, :1]], axis=1)
        field_w = jnp.concatenate([field_w, field_w[:, :1]], axis=1)

    mean = field_wv / jnp.where(field_w == 0, 1.0, field_w)
    if mode == GEOMETRIC:
        mean = jnp.exp(mean)
    elif mode == HARMONIC:
        mean = 1.0 / jnp.where(mean == 0, 1.0, mean)
    return mean, field_w


# -- grid -> marker ---------------------------------------------------------------

def bucket_grid_to_markers(
    field,  # (ny_n, nx_n) on sub-lattice `loc`
    px,
    py,  # (ny, nx, K) positions (may be RK4 stage positions)
    valid,
    grid: StaggeredGrid,
    loc: str,
    reach: int = 1,
    periodic_x: bool = False,
):
    """Bilinear gather replaced by masked dense shifts.  ``reach`` bounds
    |o + d|: 1 for in-cell markers, 2 for RK4 stage positions displaced by
    up to one cell.  ``periodic_x``: node columns wrap with period nx."""
    o_j, o_i, ty, tx = _lattice_local(px, py, grid, loc, periodic_x,
                                      window=reach)
    ws = _weights(ty, tx)
    corners = ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]), (1, 1, ws[3]))

    out = jnp.zeros(px.shape, field.dtype)
    pad = reach + 2
    if periodic_x:
        core = field[:, : grid.nx]  # unique columns (period nx)
        ext = jnp.concatenate([core[:, -pad:], core, core[:, :pad]], axis=1)
        fp = jnp.pad(ext, ((pad, pad), (0, 0)))
    else:
        fp = jnp.pad(field, pad)
    for a in range(-reach, reach + 2):
        for b in range(-reach, reach + 2):
            # lattice node (j+a, i+b) for every cell (j, i), zero outside
            # (wrapped in x for periodic)
            fab = fp[pad + a : pad + a + grid.ny, pad + b : pad + b + grid.nx]
            contrib = jnp.zeros(px.shape, field.dtype)
            for dj, di, w in corners:
                sel = (o_j + dj == a) & (o_i + di == b)
                contrib = contrib + jnp.where(sel & valid, w, 0.0)
            out = out + contrib * fab[:, :, None]
    return out


# -- velocity sampling + RK4 advection --------------------------------------------

def _bucket_velocity_at(px, py, valid, vx_p, vy_p, grid: StaggeredGrid, reach: int,
                        periodic_x: bool = False):
    """Velocity at positions from ghost-padded staggered grids.

    vx_p: (ny+2, nx+1) with origin (-dy/2, 0); vy_p: (ny+1, nx+2) with
    origin (0, -dx/2) (see markers/advect.py).  With ``periodic_x`` the
    lattices wrap (period nx in array columns: vx_p column offset 0, vy_p
    column offset 1) so UNWRAPPED stage positions just past the seam sample
    the other side — positions themselves must not be wrapped mid-step or
    the dense-shift locality (o relative to the bucket cell) breaks."""
    if not grid.uniform:
        import numpy as np

        # Stretched: physical-coordinate windowed locate against the padded
        # lattices' node coordinates (ghost rows/cols mirror at one cell
        # width — identical to markers/advect.py velocity_at).
        yc, xc = grid.y_center, grid.x_center
        ys_vx = np.concatenate(
            [[yc[0] - grid.dys[0]], yc, [yc[-1] + grid.dys[-1]]]
        )
        xs_vy = np.concatenate(
            [[xc[0] - grid.dxs[0]], xc, [xc[-1] + grid.dxs[-1]]]
        )
        ux = _sample_coords(vx_p, px, py, valid, grid, reach,
                            ys=ys_vx, xs=grid.x_corner,
                            y_center_like=True, x_center_like=False)
        uy = _sample_coords(vy_p, px, py, valid, grid, reach,
                            ys=grid.y_corner, xs=xs_vy,
                            y_center_like=False, x_center_like=True)
        return ux, uy
    dx, dy = grid.dx, grid.dy

    # fx, fy below are ARRAY coordinates of the padded lattices: node at
    # array index (r, c) has (fy, fx) == (r, c).
    ux = _sample_padded(vx_p, px / dx, py / dy + 0.5, valid, grid, reach,
                        periodic_x=periodic_x, col_offset=0)
    uy = _sample_padded(vy_p, px / dx + 0.5, py / dy, valid, grid, reach,
                        periodic_x=periodic_x, col_offset=1)
    return ux, uy


def _sample_coords(f, px, py, valid, grid: StaggeredGrid, reach,
                   ys, xs, y_center_like: bool, x_center_like: bool):
    """Stretched-grid twin of _sample_padded: bilinear sample of a lattice
    given its explicit (monotone, possibly ghost-extended) node coordinate
    arrays.  Axes whose nodes sit at cell edges have in-cell node-interval
    offsets {0} (window [-reach, reach] under displacement); center-like
    axes (nodes at cell centers, incl. one ghost each side) have in-cell
    offsets {0, 1} (window [-reach, reach+1]) — both exactly the offsets the
    dense-shift loop enumerates."""
    ylo, yhi = (-reach, reach + 1) if y_center_like else (-reach, reach)
    xlo, xhi = (-reach, reach + 1) if x_center_like else (-reach, reach)
    j0, ty = _axis_locate(py, ys, ylo, yhi, axis=0)
    i0, tx = _axis_locate(px, xs, xlo, xhi, axis=1)
    ci = lax.broadcasted_iota(jnp.int32, px.shape, 1)
    cj = lax.broadcasted_iota(jnp.int32, px.shape, 0)
    o_j = j0 - cj
    o_i = i0 - ci
    ws = _weights(ty, tx)
    corners = ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]), (1, 1, ws[3]))

    out = jnp.zeros(px.shape, f.dtype)
    pad = reach + 2
    fp = jnp.pad(f, pad)
    for a in range(-reach, reach + 2):
        for b in range(-reach, reach + 2):
            fab = fp[pad + a : pad + a + grid.ny, pad + b : pad + b + grid.nx]
            contrib = jnp.zeros(px.shape, f.dtype)
            for dj, di, w in corners:
                sel = (o_j + dj == a) & (o_i + di == b)
                contrib = contrib + jnp.where(sel & valid, w, 0.0)
            out = out + contrib * fab[:, :, None]
    return out


def _sample_padded(f, fx, fy, valid, grid: StaggeredGrid, reach,
                   periodic_x: bool = False, col_offset: int = 0):
    """Bilinear sample of a lattice in array coordinates (node (r, c) at
    (fy, fx) = (r, c)) -- dense-shift implementation.

    For both padded velocity lattices an in-cell marker has array offsets
    o = (node_index - cell_index) in {0, 1}; RK4 stage positions displaced
    by up to one cell widen this to {-1, .., 2}, hence the (o + d) loop
    range {-reach, .., reach+1}.

    ``periodic_x``: array column c samples f_core[(c - col_offset) mod nx]
    where f_core = f[:, col_offset : col_offset + nx] (the unique period)."""
    nr, nc = f.shape
    if periodic_x:
        i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), -reach, nc - 2 + reach)
    else:
        i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nc - 2)
    j0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, nr - 2)
    tx = jnp.clip(fx - i0, 0.0, 1.0)
    ty = jnp.clip(fy - j0, 0.0, 1.0)
    ci = lax.broadcasted_iota(jnp.int32, fx.shape, 1)
    cj = lax.broadcasted_iota(jnp.int32, fx.shape, 0)
    o_i = i0 - ci
    o_j = j0 - cj
    ws = _weights(ty, tx)
    corners = ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]), (1, 1, ws[3]))

    out = jnp.zeros(fx.shape, f.dtype)
    pad = reach + 2
    if periodic_x:
        import numpy as _np

        core = f[:, col_offset : col_offset + grid.nx]
        idx = (_np.arange(-pad, grid.nx + pad) - col_offset) % grid.nx
        ext = core[:, idx]  # ext col (pad + c) == array col c, wrapped
        fp = jnp.pad(ext, ((pad, pad), (0, 0)))
    else:
        fp = jnp.pad(f, pad)
    for a in range(-reach, reach + 2):
        for b in range(-reach, reach + 2):
            # array node (j + a, i + b) for every cell (j, i)
            fab = fp[pad + a : pad + a + grid.ny, pad + b : pad + b + grid.nx]
            contrib = jnp.zeros(fx.shape, f.dtype)
            for dj, di, w in corners:
                sel = (o_j + dj == a) & (o_i + di == b)
                contrib = contrib + jnp.where(sel & valid, w, 0.0)
            out = out + contrib * fab[:, :, None]
    return out


def bucket_advect_rk4(
    bm: BucketedMarkers, vx, vy, dt, grid: StaggeredGrid, bcs: VelocityBCs,
    stage_reach: int = 2,
):
    """RK4 advection in bucket layout (positions only; call rebucket after).

    ``stage_reach``: shift reach for the displaced RK stage positions.
    2 covers displacements up to one full cell; callers whose dt guarantees
    <= half a cell (Courant <= 0.5, no moving walls) may pass 1, roughly
    halving the advection cost (16 vs 36 shifted slabs per stage).

    Periodic side walls: velocity sampling wraps in x and final positions
    wrap into [0, lx) (rebucket handles the seam-crossing cell change)."""
    periodic = bcs.periodic_x
    top = bcs.s_top * vx[:1] + (1.0 - bcs.s_top) * bcs.vt_top
    bot = bcs.s_bottom * vx[-1:] + (1.0 - bcs.s_bottom) * bcs.vt_bottom
    vx_p = jnp.concatenate([top, vx, bot], axis=0)
    if periodic:
        left = vy[:, -1:]
        right = vy[:, :1]
    else:
        left = bcs.s_left * vy[:, :1] + (1.0 - bcs.s_left) * bcs.vt_left
        right = bcs.s_right * vy[:, -1:] + (1.0 - bcs.s_right) * bcs.vt_right
    vy_p = jnp.concatenate([left, vy, right], axis=1)

    def vel(px, py, reach):
        return _bucket_velocity_at(px, py, bm.valid, vx_p, vy_p, grid, reach,
                                   periodic_x=periodic)

    x, y = bm.x, bm.y
    k1x, k1y = vel(x, y, 1)
    k2x, k2y = vel(x + 0.5 * dt * k1x, y + 0.5 * dt * k1y, stage_reach)
    k3x, k3y = vel(x + 0.5 * dt * k2x, y + 0.5 * dt * k2y, stage_reach)
    k4x, k4y = vel(x + dt * k3x, y + dt * k3y, stage_reach)

    nx_new = x + dt / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
    ny_new = y + dt / 6.0 * (k1y + 2 * k2y + 2 * k3y + k4y)
    eps_x = 1e-6 * grid.dx_min
    eps_y = 1e-6 * grid.dy_min
    if periodic:
        new_x = _wrap_x(nx_new, grid.lx)
    else:
        new_x = jnp.clip(nx_new, eps_x, grid.lx - eps_x)
    return bm.replace(
        x=new_x,
        y=jnp.clip(ny_new, eps_y, grid.ly - eps_y),
    )


# -- re-bucketing ------------------------------------------------------------------

def rebucket(bm: BucketedMarkers, grid: StaggeredGrid,
             periodic_x: bool = False):
    """Re-pack every bucket from its 3x3 neighborhood (markers move at most
    one cell per step under Courant <= 1).  One sequential pass over the 9K
    candidate slots; each insert is a one-hot fma over the K lanes.

    ``periodic_x``: the 3x3 neighborhood wraps in x — a marker crossing the
    seam (wrapped position) re-packs into the opposite edge column.

    Returns (new_bm, dropped): `dropped` counts capacity overflows."""
    ny, nx, K = bm.x.shape

    ci = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 1)
    cj = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 0)
    if grid.uniform:
        ti = jnp.clip((bm.x / grid.dx).astype(jnp.int32), 0, nx - 1)
        tj = jnp.clip((bm.y / grid.dy).astype(jnp.int32), 0, ny - 1)
    else:
        if periodic_x:
            raise ValueError("periodic side walls need a uniform grid")
        # markers move at most one cell: windowed locate on the cell edges
        ti, _ = _axis_locate(bm.x, grid.x_corner, -1, 1, axis=1)
        tj, _ = _axis_locate(bm.y, grid.y_corner, -1, 1, axis=0)
    if periodic_x:
        # wrapped cell offset in {-1, 0, 1} (needs nx >= 3)
        stays_di = (ti - ci + 1) % nx - 1
    else:
        stays_di = ti - ci  # in {-1, 0, 1}
    stays_dj = tj - cj

    slot_ids = lax.broadcasted_iota(jnp.int32, (K,), 0)

    carry = (
        jnp.zeros_like(bm.x),
        jnp.zeros_like(bm.y),
        jnp.zeros_like(bm.T),
        jnp.zeros_like(bm.mat),
        jnp.zeros_like(bm.valid),
        jnp.zeros((ny, nx), jnp.int32),
        jnp.zeros((ny, nx), jnp.int32),
    )

    def _shift3(arr, a, b):
        """(ny, nx, K) array shifted by (a, b) in the cell dims (x wraps
        when periodic)."""
        if periodic_x:
            t = jnp.roll(arr, -b, axis=1)
            return jnp.pad(t, ((max(-a, 0), max(a, 0)), (0, 0), (0, 0)))[
                max(a, 0) : max(a, 0) + ny, :, :
            ]
        return jnp.pad(
            arr, ((max(-a, 0), max(a, 0)), (max(-b, 0), max(b, 0)), (0, 0))
        )[max(a, 0) : max(a, 0) + ny, max(b, 0) : max(b, 0) + nx, :]

    # Static loop over the 9 neighbor offsets; traced loop over the K slots.
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            # candidate slabs: cand[j, i, s] = bm.*[j+a, i+b, s]; a marker in
            # cell (j+a, i+b) belongs HERE iff its target-cell offset equals
            # -(a, b) relative to its current cell.
            sx = _shift3(bm.x, a, b)
            sy = _shift3(bm.y, a, b)
            sT = _shift3(bm.T, a, b)
            sm = _shift3(bm.mat, a, b)
            sv = _shift3(bm.valid.astype(jnp.int32), a, b) > 0
            sdi = _shift3(stays_di, a, b)
            sdj = _shift3(stays_dj, a, b)
            take_all = sv & (sdj == -a) & (sdi == -b)  # (ny, nx, K)

            def body(s, cr, sx=sx, sy=sy, sT=sT, sm=sm, take_all=take_all):
                out_x, out_y, out_T, out_mat, out_valid, count, arrivals = cr
                take = lax.dynamic_index_in_dim(take_all, s, 2, keepdims=False)
                cx = lax.dynamic_index_in_dim(sx, s, 2, keepdims=False)
                cy = lax.dynamic_index_in_dim(sy, s, 2, keepdims=False)
                cT = lax.dynamic_index_in_dim(sT, s, 2, keepdims=False)
                cm = lax.dynamic_index_in_dim(sm, s, 2, keepdims=False)
                arrivals = arrivals + take.astype(jnp.int32)
                can = take & (count < K)
                onehot = (slot_ids[None, None, :] == count[:, :, None]) & can[
                    :, :, None
                ]
                out_x = jnp.where(onehot, cx[:, :, None], out_x)
                out_y = jnp.where(onehot, cy[:, :, None], out_y)
                out_T = jnp.where(onehot, cT[:, :, None], out_T)
                out_mat = jnp.where(onehot, cm[:, :, None], out_mat)
                out_valid = out_valid | onehot
                count = count + can.astype(jnp.int32)
                return out_x, out_y, out_T, out_mat, out_valid, count, arrivals

            carry = lax.fori_loop(0, K, body, carry)

    out_x, out_y, out_T, out_mat, out_valid, count, arrivals = carry
    dropped = jnp.sum(jnp.maximum(arrivals - K, 0))
    new = BucketedMarkers(x=out_x, y=out_y, mat=out_mat, T=out_T, valid=out_valid)
    return new, dropped


# -- reseeding ---------------------------------------------------------------------

def bucket_reseed(
    bm: BucketedMarkers,
    T_grid,
    grid: StaggeredGrid,
    min_per_cell: int,
    n_materials: int = 8,
    periodic_x: bool = False,
):
    """Fill cells below ``min_per_cell`` up from empty slots: new markers at
    deterministic sub-cell positions, T from the grid, material = 3x3
    neighborhood majority (dense one-hot histogram over the config's
    ``n_materials`` material ids; the neighborhood wraps in x when
    ``periodic_x``)."""
    ny, nx, K = bm.x.shape
    count = bm.count()
    deficit = jnp.maximum(min_per_cell - count, 0)

    shift = _shift2d_px if periodic_x else _shift2d
    NMAT = n_materials
    hist = jnp.zeros((ny, nx, NMAT), jnp.int32)
    for m in range(NMAT):
        hist = hist.at[:, :, m].set(
            jnp.sum(bm.valid & (bm.mat == m), axis=-1, dtype=jnp.int32)
        )
    acc = jnp.zeros_like(hist)
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            acc = acc + jnp.stack(
                [shift(hist[:, :, m], a, b) for m in range(NMAT)], axis=-1
            )
    majority = jnp.argmax(acc, axis=-1).astype(jnp.int32)

    slot_ids = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 2)
    # free slots get rank: position among invalid slots
    free_rank = jnp.cumsum((~bm.valid).astype(jnp.int32), axis=-1) - 1
    spawn = (~bm.valid) & (free_rank < deficit[:, :, None])

    ci = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 1)
    cj = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 0)
    off_x = ((slot_ids * 0.381966) % 1.0 - 0.5) * 0.5
    off_y = ((slot_ids * 0.618034) % 1.0 - 0.5) * 0.5
    if grid.uniform:
        sx = (ci + 0.5 + off_x) * grid.dx
        sy = (cj + 0.5 + off_y) * grid.dy
    else:
        import numpy as np

        xe0 = jnp.asarray(grid.x_corner[:-1], bm.x.dtype).reshape(1, nx, 1)
        ye0 = jnp.asarray(grid.y_corner[:-1], bm.y.dtype).reshape(ny, 1, 1)
        dxc = jnp.asarray(np.asarray(grid.dxs), bm.x.dtype).reshape(1, nx, 1)
        dyc = jnp.asarray(np.asarray(grid.dys), bm.y.dtype).reshape(ny, 1, 1)
        sx = xe0 + (0.5 + off_x) * dxc
        sy = ye0 + (0.5 + off_y) * dyc

    new_x = jnp.where(spawn, sx.astype(bm.x.dtype), bm.x)
    new_y = jnp.where(spawn, sy.astype(bm.y.dtype), bm.y)
    T_at = bucket_grid_to_markers(T_grid, new_x, new_y, spawn, grid, "corner",
                                  periodic_x=periodic_x)
    new_T = jnp.where(spawn, T_at.astype(bm.T.dtype), bm.T)
    new_mat = jnp.where(spawn, majority[:, :, None], bm.mat)
    return bm.replace(
        x=new_x, y=new_y, T=new_T, mat=new_mat, valid=bm.valid | spawn
    )
