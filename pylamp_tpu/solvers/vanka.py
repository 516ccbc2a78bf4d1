"""Coupled geometric multigrid for extreme-viscosity-contrast Stokes.

The block-triangular MG in solvers/mg.py (velocity V-cycles + diagonal Schur
surrogate) degrades under extreme sharp-interface viscosity contrast — the
sticky-air benchmark (BASELINE config 5, SURVEY.md §7.3 risk #1) costs
~1000 Krylov iterations/step with it.  This module implements the classic
fix (SURVEY.md §7.3 item 1 names the coupled-smoother family): multigrid on
the FULL (vx, vy, p) saddle-point system, so pressure and velocity relax
together where viscosity jumps by decades across one cell.

Two ingredients, both load-bearing (each was isolated by measurement):

1. **Symmetric Jacobi equilibration per level.**  Momentum rows scale with
   the local viscosity, so at a sharp interface any pressure correction dp
   leaves momentum residuals of size O(eta * r_c) that alias through the
   transfer operators into contrast-scale coarse corrections.  Measured:
   residual AND error grow ~ contrast x 0.1 per V-cycle for every unscaled
   coupled smoother tried (exact-box Vanka, pointwise Uzawa, unscaled
   Braess-Sarazin).  Scaling velocities by sqrt(momentum diagonal) and
   pressure by sqrt(|Schur diagonal|) makes the scaled system's rows and
   columns O(1): smoother updates, residuals, and transfer quantities stay
   bounded at ANY viscosity contrast (the classic diagonal-scaling remedy
   for jumping-coefficient multigrid).

2. **Braess-Sarazin smoothing.**  Each sweep approximately solves the
   damped-diagonal saddle system [[alpha*I, G_hat], [B_hat, 0]] du = r_hat
   globally: a few damped Jacobi iterations on the scaled pressure
   Laplacian B_hat (alpha)^-1 G_hat (unit diagonal by construction), then
   the consistent velocity update dv = (r_v - G_hat dp)/alpha.  Pressure
   and velocity move through one consistent global approximate saddle
   solve — unlike per-cell updates, whose contrast-scale local pressure
   compensations destabilize simultaneous sweeps.  Braess & Sarazin (1997)
   prove the smoothing property for alpha >~ 1.

Design: everything is dense static-shaped stencil arithmetic
(no scatter/gather, no matrix assembly), jit/GSPMD-shardable, with rolled
`lax.fori_loop` sweep loops to keep compile time bounded.

Used as the FGMRES preconditioner via make_vanka_mg_preconditioner
(selected with SolverConfig.preconditioner = "vanka"; the historical name
— the first implementation used a red-black exact-box Vanka smoother,
which measurement replaced with the equilibrated Braess-Sarazin above).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.ops.stokes import stokes_operator
from pylamp_tpu.solvers.mg import (
    coarsen_eta,
    num_levels,
    prolong_vx,
    prolong_vy,
    restrict_vx,
    restrict_vy,
)

# -- pressure (cell-centered) transfers ----------------------------------------


def restrict_p(f):
    """(2NY, 2NX) -> (NY, NX): 4-child average (P^T/4 of injection)."""
    return 0.25 * (f[0::2, 0::2] + f[0::2, 1::2] + f[1::2, 0::2] + f[1::2, 1::2])


def prolong_p(c):
    """(NY, NX) -> (2NY, 2NX): piecewise-constant injection."""
    ny, nx = c.shape
    return jnp.broadcast_to(c[:, None, :, None], (ny, 2, nx, 2)).reshape(2 * ny, 2 * nx)


# -- BC-aware momentum diagonals -------------------------------------------------


def momentum_diagonals_bc(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs, kbnd):
    """BC-aware full momentum diagonals on the (vx, vy) face lattices (the
    ghost elimination drops the wall eta_s term under free slip and doubles
    it under no slip); Dirichlet faces carry kbnd."""
    ny, nx = grid.ny, grid.nx
    dtype = eta_n.dtype
    dx2, dy2 = grid.dx**2, grid.dy**2
    wt = jnp.ones((ny, 1), dtype).at[0, 0].set(1.0 - bcs.s_top)
    wb = jnp.ones((ny, 1), dtype).at[-1, 0].set(1.0 - bcs.s_bottom)
    dvx_int = (
        2.0 * (eta_n[:, 1:] + eta_n[:, :-1]) / dx2
        + (wt * eta_s[:-1, 1:-1] + wb * eta_s[1:, 1:-1]) / dy2
    )
    wl = jnp.ones((1, nx), dtype).at[0, 0].set(1.0 - bcs.s_left)
    wr = jnp.ones((1, nx), dtype).at[0, -1].set(1.0 - bcs.s_right)
    dvy_int = (
        2.0 * (eta_n[1:, :] + eta_n[:-1, :]) / dy2
        + (wl * eta_s[1:-1, :-1] + wr * eta_s[1:-1, 1:]) / dx2
    )
    kb = jnp.full((ny, 1), kbnd, dtype)
    dvx = jnp.concatenate([kb, dvx_int, kb], axis=1)
    kb = jnp.full((1, nx), kbnd, dtype)
    dvy = jnp.concatenate([kb, dvy_int, kb], axis=0)
    return dvx, dvy


# -- one equilibrated level ------------------------------------------------------


class _ScaledLevel:
    """One level of the equilibrated coupled MG: the symmetric Jacobi
    scaling of the saddle system plus the Braess-Sarazin smoother data."""

    def __init__(self, eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                 kcont, kbnd, alpha: float):
        self.eta_s, self.eta_n = eta_s, eta_n
        self.grid, self.bcs = grid, bcs
        self.kcont, self.kbnd = kcont, kbnd
        self.alpha = alpha
        dx, dy = grid.dx, grid.dy

        dvx, dvy = momentum_diagonals_bc(eta_s, eta_n, grid, bcs, kbnd)
        adx, ady = alpha * dvx, alpha * dvy
        # Face transmissibilities of M_p = B (alpha D)^-1 G: zero on
        # Dirichlet faces (their momentum rows carry no pressure gradient
        # -> natural Neumann closure for the pressure stencil).
        tL = ((kcont / dx**2) / adx[:, :-1]).at[:, 0].set(0.0)
        tR = ((kcont / dx**2) / adx[:, 1:]).at[:, -1].set(0.0)
        tT = ((kcont / dy**2) / ady[:-1, :]).at[0, :].set(0.0)
        tB = ((kcont / dy**2) / ady[1:, :]).at[-1, :].set(0.0)
        self.t = (tL, tR, tT, tB)
        diag_p = tL + tR + tT + tB  # |Schur diagonal| (M_p = links - diag)
        self.sx = jnp.sqrt(dvx)
        self.sy = jnp.sqrt(dvy)
        self.sp = jnp.sqrt(diag_p)

    # -- scaled-space linear algebra ------------------------------------

    def scale_r(self, r):
        """PDE residual -> scaled residual (D^-1 r)."""
        return (r[0] / self.sx, r[1] / self.sy, r[2] / self.sp)

    def unscale_r(self, rh):
        """Scaled residual -> PDE residual (D r_hat)."""
        return (rh[0] * self.sx, rh[1] * self.sy, rh[2] * self.sp)

    def unscale_x(self, xh):
        """Scaled solution -> PDE solution (x = D^-1 x_hat)."""
        return (xh[0] / self.sx, xh[1] / self.sy, xh[2] / self.sp)

    def scale_x(self, x):
        """PDE solution -> scaled solution (x_hat = D x)."""
        return (x[0] * self.sx, x[1] * self.sy, x[2] * self.sp)

    def zeros(self):
        g, dt = self.grid, self.sx.dtype
        return (
            jnp.zeros(g.shape_vx, dt),
            jnp.zeros(g.shape_vy, dt),
            jnp.zeros(g.shape_center, dt),
        )

    def apply_scaled(self, xh):
        """A_hat x_hat = D^-1 A (D^-1 x_hat): unit momentum diagonal."""
        vx, vy, p = self.unscale_x(xh)
        r = stokes_operator(
            vx, vy, p, self.eta_s, self.eta_n, self.grid, self.bcs,
            kcont=self.kcont, kbnd=self.kbnd,
        )
        return self.scale_r(r)

    def _apply_Mp_hat(self, ph):
        """Scaled pressure stencil D_p^-1 M_p D_p^-1; diagonal is -1."""
        tL, tR, tT, tB = self.t
        p = ph / self.sp
        pL = jnp.pad(p, ((0, 0), (1, 0)))[:, :-1]
        pR = jnp.pad(p, ((0, 0), (0, 1)))[:, 1:]
        pT = jnp.pad(p, ((1, 0), (0, 0)))[:-1, :]
        pB = jnp.pad(p, ((0, 1), (0, 0)))[1:, :]
        out = tL * (pL - p) + tR * (pR - p) + tT * (pT - p) + tB * (pB - p)
        return out / self.sp

    def smooth(self, uh, rhs_h, sweeps: int, pressure_jacobi: int = 4,
               omega_j: float = 0.8):
        """Braess-Sarazin sweeps on the scaled system (see module doc)."""
        grid, kcont, alpha = self.grid, self.kcont, self.alpha
        dx, dy = grid.dx, grid.dy

        def sweep(uh):
            rx, ry, rc = jax.tree.map(
                lambda b, a: b - a, rhs_h, self.apply_scaled(uh)
            )
            # rhs of the scaled pressure system: B_hat (alpha)^-1 r_v - r_c
            qx = rx / (alpha * self.sx)
            qy = ry / (alpha * self.sy)
            rhs_p = (
                kcont
                * ((qx[:, 1:] - qx[:, :-1]) / dx + (qy[1:, :] - qy[:-1, :]) / dy)
                / self.sp
                - rc
            )
            dp = jnp.zeros_like(rc)
            for _ in range(pressure_jacobi):
                # Jacobi with diag(M_p_hat) = -1
                dp = dp - omega_j * (rhs_p - self._apply_Mp_hat(dp))
            # consistent velocity update dv = (r_v - G_hat dp)/alpha
            dpp = dp / self.sp
            gpx = jnp.pad(dpp[:, 1:] - dpp[:, :-1], ((0, 0), (1, 1))) / dx
            gpy = jnp.pad(dpp[1:, :] - dpp[:-1, :], ((1, 1), (0, 0))) / dy
            dvx_h = (rx - gpx / self.sx) / alpha
            dvy_h = (ry - gpy / self.sy) / alpha
            return (uh[0] + dvx_h, uh[1] + dvy_h, uh[2] + dp)

        # rolled loop: V-cycles contain O(40) sweeps across levels — fully
        # unrolling them explodes XLA compile time (minutes on CPU)
        return jax.lax.fori_loop(0, sweeps, lambda _, u: sweep(u), uh)


# -- the coupled V-cycle ---------------------------------------------------------


def make_coupled_vanka_mg(
    eta_s,
    eta_n,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    kcont,
    kbnd,
    levels: int = 0,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    coarse_sweeps: int = 24,
    alpha: float = 1.5,
):
    """Returns mg(rhs) -> u: one equilibrated coupled V-cycle on the full
    (vx, vy, p) system from a zero initial guess.  ``rhs`` and the returned
    correction are in PDE units; the scaling is internal."""
    nlev = num_levels(grid, levels)

    # Dirichlet-row scaling follows the stencil's h^-2 growth per level;
    # the continuity scaling kcont is h-independent row scaling and must
    # stay the same on every level so restricted residuals stay consistent.
    lv = [_ScaledLevel(eta_s, eta_n, grid, bcs, kcont, kbnd, alpha)]
    for _ in range(nlev - 1):
        g = lv[-1].grid
        cg = StaggeredGrid(nx=g.nx // 2, ny=g.ny // 2, lx=g.lx, ly=g.ly)
        es, en = coarsen_eta(lv[-1].eta_s, lv[-1].eta_n)
        ckbnd = kbnd * (grid.dx / cg.dx) ** 2
        lv.append(_ScaledLevel(es, en, cg, bcs, kcont, ckbnd, alpha))

    def vcycle(l, rhs_h):
        L = lv[l]
        if l == nlev - 1:
            return L.smooth(L.zeros(), rhs_h, coarse_sweeps)
        uh = L.smooth(L.zeros(), rhs_h, pre_smooth)
        rh = jax.tree.map(lambda b, a: b - a, rhs_h, L.apply_scaled(uh))
        # transfers act on PDE-unit quantities; rescale per level
        r = L.unscale_r(rh)
        C = lv[l + 1]
        rc_h = C.scale_r(
            (restrict_vx(r[0], bcs), restrict_vy(r[1], bcs), restrict_p(r[2]))
        )
        ec_h = vcycle(l + 1, rc_h)
        e = C.unscale_x(ec_h)
        ef_h = L.scale_x(
            (prolong_vx(e[0], bcs), prolong_vy(e[1], bcs), prolong_p(e[2]))
        )
        uh = jax.tree.map(lambda a, b: a + b, uh, ef_h)
        return L.smooth(uh, rhs_h, post_smooth)

    fine = lv[0]

    def mg(rhs):
        uh = vcycle(0, fine.scale_r(rhs))
        return fine.unscale_x(uh)

    return mg


def make_vanka_mg_preconditioner(
    eta_s,
    eta_n,
    grid: StaggeredGrid,
    kcont,
    kbnd,
    bcs: VelocityBCs = None,
    levels: int = 0,
    cycles: int = 1,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    coarse_sweeps: int = 24,
    alpha: float = 1.5,
):
    """FGMRES preconditioner: equilibrated coupled-MG V-cycle(s) on the full
    residual; pressure returned in the mean-zero gauge (the constant-
    pressure nullspace is projected once per application)."""
    if not grid.uniform:
        raise ValueError(
            "the Vanka preconditioner has no stretched-grid path yet; use "
            "preconditioner='mg' on stretched grids"
        )
    if bcs is None:
        bcs = VelocityBCs()
    mg = make_coupled_vanka_mg(
        eta_s, eta_n, grid, bcs, kcont, kbnd,
        levels=levels, pre_smooth=pre_smooth, post_smooth=post_smooth,
        coarse_sweeps=coarse_sweeps, alpha=alpha,
    )

    def M(r):
        z = mg(r)
        for _ in range(cycles - 1):
            ax, ay, ac = stokes_operator(
                z[0], z[1], z[2], eta_s, eta_n, grid, bcs, kcont=kcont, kbnd=kbnd
            )
            d = mg((r[0] - ax, r[1] - ay, r[2] - ac))
            z = (z[0] + d[0], z[1] + d[1], z[2] + d[2])
        zp = z[2] - jnp.mean(z[2])
        return (z[0], z[1], zp)

    return M
