"""Marker <-> grid transfer (the trac2grid / grid2trac primitives,
SURVEY.md §3.3).

marker -> grid: bilinear (distance) weights to the 4 surrounding nodes of
the target sub-grid, accumulated with scatter-add and normalized — a
weighted arithmetic mean, with geometric / harmonic options for viscosity
(SURVEY.md §2.1).  The scatter uses flat node indices + ``.at[].add`` (XLA
scatter-add; deterministic on the CPU, while a GPU scatter-add may sum in
a run-dependent order).  This flat engine is the reference the tests
compare the bucket engine (markers/bucket.py) against.

grid -> marker: bilinear gather from the (ghost-padded where relevant)
sub-grid.
"""
from __future__ import annotations

import jax.numpy as jnp

from pylamp_tpu.core.grid import StaggeredGrid

ARITHMETIC = "arithmetic"
GEOMETRIC = "geometric"
HARMONIC = "harmonic"


def _locate(px, py, grid: StaggeredGrid, loc: str, periodic_x: bool = False):
    """Cell index (j0, i0) within the target sub-grid's node lattice and
    local coords (ty, tx) in [0, 1], clamped so boundary markers use the
    outermost cell (constant-slope extrapolation is avoided by clamping —
    matches nearest-cell weighting at the walls).

    ``periodic_x``: no x clamp; i0 may be -1 on the half-offset lattices and
    callers wrap node column indices with period nx.

    Stretched grids locate by binary search over the node coordinate
    arrays (periodic wrap requires a uniform grid)."""
    ny_n, nx_n = grid.shape(loc)
    if not grid.uniform:
        if periodic_x:
            raise ValueError("periodic side walls need a uniform grid")
        ys, xs = grid.coords(loc)
        xs = jnp.asarray(xs, px.dtype)
        ys = jnp.asarray(ys, py.dtype)
        i0 = jnp.clip(
            jnp.searchsorted(xs, px, side="right").astype(jnp.int32) - 1,
            0, nx_n - 2,
        )
        j0 = jnp.clip(
            jnp.searchsorted(ys, py, side="right").astype(jnp.int32) - 1,
            0, ny_n - 2,
        )
        tx = jnp.clip((px - xs[i0]) / (xs[i0 + 1] - xs[i0]), 0.0, 1.0)
        ty = jnp.clip((py - ys[j0]) / (ys[j0 + 1] - ys[j0]), 0.0, 1.0)
        return j0, i0, ty, tx
    oy, ox = grid.origin(loc)
    fx = (px - ox) / grid.dx
    fy = (py - oy) / grid.dy
    if periodic_x:
        i0 = jnp.floor(fx).astype(jnp.int32)
    else:
        i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx_n - 2)
    j0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny_n - 2)
    tx = jnp.clip(fx - i0, 0.0, 1.0)
    ty = jnp.clip(fy - j0, 0.0, 1.0)
    return j0, i0, ty, tx


def _weights(ty, tx):
    w00 = (1.0 - ty) * (1.0 - tx)
    w01 = (1.0 - ty) * tx
    w10 = ty * (1.0 - tx)
    w11 = ty * tx
    return w00, w01, w10, w11


def markers_to_grid(
    px,
    py,
    values,
    grid: StaggeredGrid,
    loc: str,
    mode: str = ARITHMETIC,
    weight_power: float = 1.0,
    periodic_x: bool = False,
):
    """Weighted mean of marker ``values`` on the ``loc`` sub-grid.

    Returns (field, wsum): the interpolated field and the per-node weight
    sum (wsum == 0 marks marker-starved nodes; callers decide the fallback —
    see models/step.py).

    ``periodic_x``: scatter columns wrap with period nx; lattices with a
    duplicated seam column return equal values in columns 0 and nx.
    """
    ny_n, nx_n = grid.shape(loc)
    j0, i0, ty, tx = _locate(px, py, grid, loc, periodic_x)
    ws = _weights(ty, tx)
    if weight_power != 1.0:
        ws = tuple(w**weight_power for w in ws)

    if mode == ARITHMETIC:
        v = values
    elif mode == GEOMETRIC:
        v = jnp.log(values)
    elif mode == HARMONIC:
        v = 1.0 / values
    else:
        raise ValueError(f"unknown averaging mode {mode!r}")

    nxu = grid.nx if periodic_x else nx_n  # unique node columns
    flat_wv = jnp.zeros(ny_n * nxu, dtype=values.dtype)
    flat_w = jnp.zeros(ny_n * nxu, dtype=values.dtype)
    for dj, di, w in ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]), (1, 1, ws[3])):
        col = (i0 + di) % nxu if periodic_x else (i0 + di)
        idx = (j0 + dj) * nxu + col
        flat_wv = flat_wv.at[idx].add(w * v)
        flat_w = flat_w.at[idx].add(w)

    wsum = flat_w.reshape(ny_n, nxu)
    mean = (flat_wv / jnp.where(flat_w == 0, 1.0, flat_w)).reshape(ny_n, nxu)
    if periodic_x and nx_n == grid.nx + 1:
        mean = jnp.concatenate([mean, mean[:, :1]], axis=1)
        wsum = jnp.concatenate([wsum, wsum[:, :1]], axis=1)
    if mode == GEOMETRIC:
        mean = jnp.exp(mean)
    elif mode == HARMONIC:
        mean = 1.0 / jnp.where(mean == 0, 1.0, mean)
    return mean, wsum


def grid_to_markers(field, px, py, grid: StaggeredGrid, loc: str,
                    periodic_x: bool = False):
    """Bilinear gather of a ``loc`` sub-grid field onto markers."""
    ny_n, nx_n = grid.shape(loc)
    j0, i0, ty, tx = _locate(px, py, grid, loc, periodic_x)
    w00, w01, w10, w11 = _weights(ty, tx)
    if periodic_x:
        f = field[:, : grid.nx]  # unique columns (period nx)
        i0 = i0 % grid.nx
        i1 = (i0 + 1) % grid.nx
    else:
        f = field
        i1 = i0 + 1
    return (
        w00 * f[j0, i0]
        + w01 * f[j0, i1]
        + w10 * f[j0 + 1, i0]
        + w11 * f[j0 + 1, i1]
    )
