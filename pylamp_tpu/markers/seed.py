"""Marker seeding: jittered-regular or regular lattice, ~O(10-30) markers
per cell (SURVEY.md §3.1)."""
from __future__ import annotations

import jax
import jax.numpy as jnp

from pylamp_tpu.core.grid import StaggeredGrid


def seed_markers(
    grid: StaggeredGrid,
    markers_per_cell_dim: int = 3,
    key: jax.Array | None = None,
    jitter: float = 0.5,
    dtype=jnp.float64,
):
    """Seed markers on a regular sub-lattice of each cell, optionally
    jittered (jitter in [0, 1]: fraction of the sub-cell spacing).

    Returns (x, y) arrays of length nx*ny*mpc^2 (static), ordered
    cell-major (markers in the same cell are contiguous)."""
    m = markers_per_cell_dim
    nxm, nym = grid.nx * m, grid.ny * m
    ddx, ddy = grid.lx / nxm, grid.ly / nym
    xs = (jnp.arange(nxm, dtype=dtype) + 0.5) * ddx
    ys = (jnp.arange(nym, dtype=dtype) + 0.5) * ddy
    Y, X = jnp.meshgrid(ys, xs, indexing="ij")
    x = X.ravel()
    y = Y.ravel()
    if key is not None and jitter > 0:
        kx, ky = jax.random.split(key)
        x = x + jax.random.uniform(kx, x.shape, dtype, -0.5, 0.5) * jitter * ddx
        y = y + jax.random.uniform(ky, y.shape, dtype, -0.5, 0.5) * jitter * ddy
    eps_x = 1e-6 * grid.dx_min
    eps_y = 1e-6 * grid.dy_min
    return jnp.clip(x, eps_x, grid.lx - eps_x), jnp.clip(y, eps_y, grid.ly - eps_y)
