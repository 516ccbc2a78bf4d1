"""Matrix-free variable-viscosity Stokes saddle-point operator.

This replaces the reference's scipy sparse matrix assembly of the staggered
finite-difference Stokes momentum + continuity system (SURVEY.md §3.4) with a
stencil *application* — the same discrete equations, evaluated directly on
the field arrays so XLA can fuse them, they can be differentiated,
and be domain-decomposed by GSPMD without ever materializing a matrix.

Discrete system (Gerya-style fully staggered, uniform grid; see
core/grid.py for node layout):

  x-momentum at interior vx nodes (i = 1..nx-1):
      -( d(sxx)/dx + d(sxy)/dy ) + dp/dx = rho_vx * gx
  y-momentum at interior vy nodes (j = 1..ny-1):
      -( d(sxy)/dx + d(syy)/dy ) + dp/dy = rho_vy * gy
  continuity at cell centers:
      kcont * ( dvx/dx + dvy/dy ) = 0

with deviatoric stresses
      sxx = 2 eta_n dvx/dx,  syy = 2 eta_n dvy/dy        (cell centers)
      sxy = eta_s (dvx/dy + dvy/dx)                       (corner nodes)

Boundary rows: normal velocities on walls are Dirichlet (row = kbnd * v);
tangential BCs enter through ghost nodes (free slip: ghost = +v_interior,
no slip: ghost = -v_interior).  ``kcont``/``kbnd`` are scaling factors that
balance row magnitudes for the Krylov solver (the reference scales its
assembled rows the same way; see solvers/scaling.py).

Sign convention: the operator is  A(v, p) = ( -div(2 eta e(v)) + grad p ,
kcont div v ), so the velocity block is positive (semi)definite and the rhs
is ( rho*g , 0 ).
"""
from __future__ import annotations

import jax.numpy as jnp

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid


def _ghost_vx(vx, bcs: VelocityBCs):
    """Pad vx with ghost rows above/below the top/bottom walls."""
    top = bcs.s_top * vx[:1, :]
    bot = bcs.s_bottom * vx[-1:, :]
    return jnp.concatenate([top, vx, bot], axis=0)  # (ny+2, nx+1)


def _ghost_vy(vy, bcs: VelocityBCs):
    """Pad vy with ghost columns left/right of the side walls.

    Periodic sides wrap: the ghost left of column 0 is the last physical
    column (period nx; vy has no duplicated seam column)."""
    if bcs.periodic_x:
        left = vy[:, -1:]
        right = vy[:, :1]
    else:
        left = bcs.s_left * vy[:, :1]
        right = bcs.s_right * vy[:, -1:]
    return jnp.concatenate([left, vy, right], axis=1)  # (ny+1, nx+2)


def shear_stress_xy(vx, vy, eta_s, grid: StaggeredGrid, bcs: VelocityBCs):
    """sxy = eta_s (dvx/dy + dvy/dx) at all corner nodes, (ny+1, nx+1)."""
    vx_g = _ghost_vx(vx, bcs)
    vy_g = _ghost_vy(vy, bcs)
    dvxdy = (vx_g[1:, :] - vx_g[:-1, :]) / grid.dy
    dvydx = (vy_g[:, 1:] - vy_g[:, :-1]) / grid.dx
    return eta_s * (dvxdy + dvydx)


def stokes_operator(
    vx,
    vy,
    p,
    eta_s,
    eta_n,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    kcont: float = 1.0,
    kbnd: float = 1.0,
    halo_mesh=None,
):
    """Apply the Stokes operator.  Returns (rx, ry, rc) with the shapes of
    (vx, vy, p).

    ``halo_mesh``: a jax.sharding.Mesh — route the application through the
    explicit shard_map + ppermute halo-exchange path (parallel/halo_ops.py)
    instead of letting GSPMD partition this stencil.  Falls back to the
    GSPMD path on grids that don't decompose evenly over the mesh."""
    if not grid.uniform:
        from pylamp_tpu.ops.stretched import stokes_operator_stretched

        return stokes_operator_stretched(
            vx, vy, p, eta_s, eta_n, grid, bcs, kcont=kcont, kbnd=kbnd
        )
    if halo_mesh is not None:
        from pylamp_tpu.parallel.halo_ops import halo_eligible, stokes_operator_halo

        if halo_eligible(grid, halo_mesh):
            return stokes_operator_halo(
                vx, vy, p, eta_s, eta_n, grid, bcs, halo_mesh,
                kcont=kcont, kbnd=kbnd,
            )
    dx, dy = grid.dx, grid.dy

    sxy = shear_stress_xy(vx, vy, eta_s, grid, bcs)  # (ny+1, nx+1)

    dvxdx = (vx[:, 1:] - vx[:, :-1]) / dx  # (ny, nx)
    dvydy = (vy[1:, :] - vy[:-1, :]) / dy  # (ny, nx)
    sxx = 2.0 * eta_n * dvxdx
    syy = 2.0 * eta_n * dvydy

    # x-momentum on interior vx nodes i=1..nx-1 -> (ny, nx-1)
    rx_int = (
        -(sxx[:, 1:] - sxx[:, :-1]) / dx
        - (sxy[1:, 1:-1] - sxy[:-1, 1:-1]) / dy
        + (p[:, 1:] - p[:, :-1]) / dx
    )
    if bcs.periodic_x:
        # Seam momentum row (vx columns 0 and nx are the same physical
        # node): wrapped stencil, emitted under the HALF-ROW convention —
        # each duplicate column carries half the physical equation, which
        # keeps the embedded operator symmetric (core/bc.py docstring).
        rx_seam = 0.5 * (
            -(sxx[:, :1] - sxx[:, -1:]) / dx
            - (sxy[1:, :1] - sxy[:-1, :1]) / dy
            + (p[:, :1] - p[:, -1:]) / dx
        )
        rx = jnp.concatenate([rx_seam, rx_int, rx_seam], axis=1)
    else:
        rx = jnp.concatenate(
            [kbnd * vx[:, :1], rx_int, kbnd * vx[:, -1:]], axis=1
        )

    # y-momentum on interior vy nodes j=1..ny-1 -> (ny-1, nx)
    ry_int = (
        -(syy[1:, :] - syy[:-1, :]) / dy
        - (sxy[1:-1, 1:] - sxy[1:-1, :-1]) / dx
        + (p[1:, :] - p[:-1, :]) / dy
    )
    ry = jnp.concatenate([kbnd * vy[:1, :], ry_int, kbnd * vy[-1:, :]], axis=0)

    rc = kcont * (dvxdx + dvydy)
    return rx, ry, rc


def stokes_rhs(
    rho_vx,
    rho_vy,
    gx,
    gy,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    kbnd: float = 1.0,
    dtype=jnp.float32,
    eta_s=None,
):
    """Right-hand side (bx, by, bc) matching ``stokes_operator``.

    ``rho_vx``/``rho_vy`` are densities interpolated to the vx / vy node
    grids (the reference interpolates marker density straight to velocity
    nodes for the buoyancy term; SURVEY.md §3.4).  ``eta_s`` is required
    when a moving-wall tangential velocity is prescribed.
    """
    moving = (
        (bcs.top == "no_slip" and bcs.vt_top != 0.0)
        or (bcs.bottom == "no_slip" and bcs.vt_bottom != 0.0)
        or (bcs.left == "no_slip" and bcs.vt_left != 0.0)
        or (bcs.right == "no_slip" and bcs.vt_right != 0.0)
    )
    if moving and eta_s is None:
        raise ValueError("stokes_rhs needs eta_s for moving-wall BCs")
    bx = (rho_vx * gx).astype(dtype)
    by = (rho_vy * gy).astype(dtype)

    # Moving no-slip walls: the ghost is s*v + (1-s)*vt; the operator keeps
    # the homogeneous part (s*v), the affine part 2*vt (no slip: s = -1)
    # folds into the boundary-adjacent momentum rows as
    # +2*eta_s*vt/h^2 on the RHS (same elimination as the oracle's;
    # stretched grids: h is the wall cell's width/height).
    dy2_top = grid.dys[0] ** 2
    dy2_bot = grid.dys[-1] ** 2
    dx2_left = grid.dxs[0] ** 2
    dx2_right = grid.dxs[-1] ** 2
    if bcs.top == "no_slip" and bcs.vt_top != 0.0:
        bx = bx.at[0, 1:-1].add(2.0 * eta_s[0, 1:-1] * bcs.vt_top / dy2_top)
    if bcs.bottom == "no_slip" and bcs.vt_bottom != 0.0:
        bx = bx.at[-1, 1:-1].add(2.0 * eta_s[-1, 1:-1] * bcs.vt_bottom / dy2_bot)
    if bcs.left == "no_slip" and bcs.vt_left != 0.0:
        by = by.at[1:-1, 0].add(2.0 * eta_s[1:-1, 0] * bcs.vt_left / dx2_left)
    if bcs.right == "no_slip" and bcs.vt_right != 0.0:
        by = by.at[1:-1, -1].add(2.0 * eta_s[1:-1, -1] * bcs.vt_right / dx2_right)

    # Dirichlet rows: prescribed normal velocities.  Periodic sides: the
    # seam buoyancy row follows the half-row convention (rho_vx must be
    # seam-consistent, i.e. equal in columns 0 and nx).
    if bcs.periodic_x:
        bx = bx.at[:, 0].mul(0.5)
        bx = bx.at[:, -1].mul(0.5)
    else:
        bx = bx.at[:, 0].set(kbnd * bcs.vn_left)
        bx = bx.at[:, -1].set(kbnd * bcs.vn_right)
    by = by.at[0, :].set(kbnd * bcs.vn_top)
    by = by.at[-1, :].set(kbnd * bcs.vn_bottom)
    bc = jnp.zeros(grid.shape_center, dtype=dtype)
    return bx, by, bc


def strain_rate_ii(vx, vy, grid: StaggeredGrid, bcs: VelocityBCs):
    """Second invariant of the strain rate at cell centers (for rheology,
    shear heating, and diagnostics)."""
    if grid.uniform:
        dvxdx = (vx[:, 1:] - vx[:, :-1]) / grid.dx
        dvydy = (vy[1:, :] - vy[:-1, :]) / grid.dy
        sxy = shear_stress_xy(
            vx, vy, jnp.ones(grid.shape_corner, vx.dtype), grid, bcs
        )
    else:
        from pylamp_tpu.ops.stretched import shear_stress_xy_stretched

        dvxdx = (vx[:, 1:] - vx[:, :-1]) / grid.dxs[None, :]
        dvydy = (vy[1:, :] - vy[:-1, :]) / grid.dys[:, None]
        sxy = shear_stress_xy_stretched(
            vx, vy, jnp.ones(grid.shape_corner, vx.dtype), grid, bcs
        )
    exx = 0.5 * (dvxdx - dvydy)  # deviatoric (incompressible: exx = -eyy)
    exy_corner = 0.5 * sxy
    exy = 0.25 * (
        exy_corner[:-1, :-1] + exy_corner[:-1, 1:] + exy_corner[1:, :-1] + exy_corner[1:, 1:]
    )
    return jnp.sqrt(exx**2 + exy**2)
