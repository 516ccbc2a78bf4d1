"""Model setup: grid + marker seeding + initial state from a ModelConfig
(SURVEY.md §3.1 initialization stack)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.markers.interp import markers_to_grid
from pylamp_tpu.markers.state import MarkerState
from pylamp_tpu.models.config import ModelConfig
from pylamp_tpu.models.state import ModelState, zero_state
from pylamp_tpu.physics.materials import MaterialTable


def build(cfg: ModelConfig, dtype=jnp.float64):
    """Returns (grid, table, initial ModelState).

    The device-side phases (seeding, initial marker->grid interpolation)
    are jitted: eager per-op dispatch on 10M-marker arrays is slow."""
    grid = StaggeredGrid(nx=cfg.nx, ny=cfg.ny, lx=cfg.lx, ly=cfg.ly,
                         x_edges=cfg.x_edges, y_edges=cfg.y_edges)
    table = MaterialTable(cfg.physics.materials)

    # Host-side seeding mirror (numpy) so material/T geometry predicates run
    # on the host; the single jit below does ALL device work.
    m = cfg.markers_per_cell_dim
    nxm, nym = grid.nx * m, grid.ny * m
    rng = np.random.default_rng(cfg.seed)
    if grid.uniform:
        ddx, ddy = grid.lx / nxm, grid.ly / nym
        xs = (np.arange(nxm) + 0.5) * ddx
        ys = (np.arange(nym) + 0.5) * ddy
        Yh, Xh = np.meshgrid(ys, xs, indexing="ij")
        xh = Xh.ravel() + rng.uniform(-0.25, 0.25, nxm * nym) * ddx
        yh = Yh.ravel() + rng.uniform(-0.25, 0.25, nxm * nym) * ddy
    else:
        # stretched: m x m jittered markers PER CELL in the cell's own
        # coordinates (constant markers-per-cell, not per-area)
        frac = (np.arange(m) + 0.5) / m
        jx = rng.uniform(-0.25, 0.25, (grid.ny, grid.nx, m, m)) / m
        jy = rng.uniform(-0.25, 0.25, (grid.ny, grid.nx, m, m)) / m
        fx = frac[None, None, None, :] + jx
        fy = frac[None, None, :, None] + jy
        xe, ye = grid.x_corner, grid.y_corner
        dxc, dyc = grid.dxs, grid.dys
        xh = (xe[:-1][None, :, None, None] + fx * dxc[None, :, None, None]).ravel()
        yh = (ye[:-1][:, None, None, None] + fy * dyc[:, None, None, None]).ravel()
    xh = np.clip(xh, 1e-6 * grid.dx_min, grid.lx - 1e-6 * grid.dx_min)
    yh = np.clip(yh, 1e-6 * grid.dy_min, grid.ly - 1e-6 * grid.dy_min)

    mat = (
        np.asarray(cfg.material_of(xh, yh), dtype=np.int32)
        if cfg.material_of
        else np.zeros(xh.shape, np.int32)
    )
    if mat.min() < 0 or mat.max() >= len(table):
        raise ValueError(
            f"material_of produced ids in [{mat.min()}, {mat.max()}] but the "
            f"config defines {len(table)} materials (valid ids 0..{len(table) - 1})"
        )
    T = (
        np.asarray(cfg.T_of(xh, yh), dtype=np.float64)
        if cfg.T_of
        else np.zeros(xh.shape)
    )

    capacity = cfg.marker_capacity or 2 * cfg.markers_per_cell_dim**2

    # Chebyshev-MG Stokes configs carry per-level lambda_max estimates in the
    # state (warm-started across steps — solvers/mg.py estimate_mg_lambdas);
    # the level count is static per (grid, solver config)
    n_mg_levels = 0
    if cfg.solver.preconditioner == "mg" and cfg.solver.mg_smoother == "chebyshev":
        from pylamp_tpu.solvers.mg import coarsening_plan

        n_mg_levels = len(coarsening_plan(
            grid, cfg.solver.mg_levels,
            semi_threshold=cfg.solver.mg_semicoarsen,
        )) + 1

    @jax.jit
    def _make_state(xd, yd, matd, Td):
        if cfg.marker_engine == "bucket":
            from pylamp_tpu.markers.bucket import bucket_from_flat

            markers = bucket_from_flat(
                xd.astype(dtype), yd.astype(dtype), matd, Td.astype(dtype),
                grid, capacity,
            )
        elif cfg.marker_engine == "flat":
            markers = MarkerState(
                x=xd.astype(dtype), y=yd.astype(dtype), mat=matd, T=Td.astype(dtype)
            )
        else:
            raise ValueError(f"unknown marker engine {cfg.marker_engine!r}")
        state = zero_state(grid, markers, dtype, n_mg_levels=n_mg_levels)
        # Pre-fill grid mirrors (fallback values for starved nodes at step 1).
        eta_m = jnp.clip(
            table.viscosity_of(markers.mat, markers.T),
            cfg.physics.eta_min,
            cfg.physics.eta_max,
        )
        periodic = cfg.physics.velocity_bcs.periodic_x
        if cfg.marker_engine == "bucket":
            from pylamp_tpu.markers.bucket import bucket_markers_to_grid

            eta_s, _ = bucket_markers_to_grid(
                markers, eta_m, grid, "corner", cfg.physics.eta_avg,
                periodic_x=periodic,
            )
            eta_n, _ = bucket_markers_to_grid(
                markers, eta_m, grid, "center", cfg.physics.eta_avg,
                periodic_x=periodic,
            )
            T_g, _ = bucket_markers_to_grid(
                markers, markers.T, grid, "corner", "arithmetic",
                periodic_x=periodic,
            )
        else:
            eta_s, _ = markers_to_grid(
                markers.x, markers.y, eta_m, grid, "corner", cfg.physics.eta_avg,
                periodic_x=periodic,
            )
            eta_n, _ = markers_to_grid(
                markers.x, markers.y, eta_m, grid, "center", cfg.physics.eta_avg,
                periodic_x=periodic,
            )
            T_g, _ = markers_to_grid(
                markers.x, markers.y, markers.T, grid, "corner", "arithmetic",
                periodic_x=periodic,
            )
        return state.replace(eta_s=eta_s, eta_n=eta_n, T=T_g)

    state = _make_state(
        jax.device_put(xh), jax.device_put(yh), jax.device_put(mat),
        jax.device_put(T),
    )
    return grid, table, state
