"""Geometric multigrid preconditioner for the Stokes velocity block.

Replaces the role of the reference's SuperLU factorization with an
O(N)-work, HBM-resident hierarchy (SURVEY.md §7.2 step 6; PAPERS.md
matrix-free GMG for variable-viscosity Stokes).  Used inside FGMRES as a
block upper-triangular preconditioner:

    z_p = -(eta_n / kcont) * r_p          (Schur complement surrogate)
    z_v = MG(r_v - G z_p)                 (V-cycles on the momentum block)

Design:
- rediscretized coarse operators: the same matrix-free momentum stencil with
  level-coarsened viscosities (eta_n: 2x2 geometric mean; eta_s: injection
  at coincident corners) — geometric-mean coarsening is the robust choice
  under large viscosity contrast (SURVEY.md §7.3 item 1)
- Chebyshev smoothing (default) on the coupled (vx, vy) system, targeting
  the upper part of the spectrum of D^-1 A with a per-level lambda_max from
  a few power iterations — robust under strong viscosity jumps where plain
  damped Jacobi diverges; damped Jacobi remains available
- staggered-lattice transfers: bilinear prolongation on each velocity
  lattice with homogeneous-BC ghost handling (free slip mirrors, no slip
  anti-mirrors), restriction = P^T / 4; Dirichlet (wall-normal) entries are
  zeroed on both transfers and left to the smoother
- everything is slicing/reshape on static shapes: XLA fuses each level's
  smoother into a handful of HBM passes, and GSPMD can shard every level
  of the hierarchy over the device mesh
"""
from __future__ import annotations

import jax.numpy as jnp

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.ops.stokes import stokes_operator
from pylamp_tpu.solvers.krylov import vdot as _vdot
from pylamp_tpu.solvers.stokes_solver import velocity_diagonals


# -- viscosity coarsening ------------------------------------------------------

def coarsen_eta(eta_s, eta_n, cx: bool = True, cy: bool = True):
    """Level-coarsened viscosities: eta_n by geometric mean over the merged
    cells (2x2, or 2x1/1x2 under semi-coarsening), eta_s by injection at the
    coincident corner nodes of the surviving edges."""
    if cx and cy:
        eta_n_c = jnp.exp(
            0.25
            * (
                jnp.log(eta_n[0::2, 0::2])
                + jnp.log(eta_n[0::2, 1::2])
                + jnp.log(eta_n[1::2, 0::2])
                + jnp.log(eta_n[1::2, 1::2])
            )
        )
        eta_s_c = eta_s[0::2, 0::2]  # coincident corner nodes
    elif cx:
        eta_n_c = jnp.exp(
            0.5 * (jnp.log(eta_n[:, 0::2]) + jnp.log(eta_n[:, 1::2]))
        )
        eta_s_c = eta_s[:, 0::2]
    elif cy:
        eta_n_c = jnp.exp(
            0.5 * (jnp.log(eta_n[0::2, :]) + jnp.log(eta_n[1::2, :]))
        )
        eta_s_c = eta_s[0::2, :]
    else:
        raise ValueError("coarsen_eta needs at least one axis")
    return eta_s_c, eta_n_c


# -- interleave helpers --------------------------------------------------------

def _interleave_rows(a, b):
    """rows [a0, b0, a1, b1, ...]; a, b: (n, m) -> (2n, m)"""
    n, m = a.shape
    return jnp.stack([a, b], axis=1).reshape(2 * n, m)


def _interleave_cols(a, b):
    n, m = a.shape
    return jnp.stack([a, b], axis=2).reshape(n, 2 * m)


# -- vx-lattice transfers (shape (ny, nx+1)) -----------------------------------

def prolong_vx(c, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    """Bilinear prolongation on the vx lattice (coarse (NY, NX+1) -> fine
    (2NY, 2NX+1)).  Fine even columns coincide with coarse columns; fine
    rows sit 1/4 and 3/4 of the way between coarse rows (ghost rows supply
    the wall behaviour of the correction).

    ``cx``/``cy`` select the coarsened axes (semi-coarsening skips the
    interpolation along the axis the two levels share).

    Periodic sides: the seam columns are real DOFs (solution-like arrays
    carry equal values in cols 0 and NX), so they are interpolated like
    interior columns — the x-interleave already wraps correctly through the
    duplicated column."""
    if not bcs.periodic_x:
        c = c.at[:, 0].set(0.0).at[:, -1].set(0.0)  # Dirichlet subspace excluded
    if cy:
        cg = jnp.concatenate([bcs.s_top * c[:1], c, bcs.s_bottom * c[-1:]], axis=0)
        a0 = 0.25 * cg[:-2] + 0.75 * cg[1:-1]
        a1 = 0.75 * cg[1:-1] + 0.25 * cg[2:]
        e = _interleave_rows(a0, a1)  # (2NY, NX+1)
    else:
        e = c
    if cx:
        odd = 0.5 * (e[:, :-1] + e[:, 1:])
        f = jnp.concatenate([_interleave_cols(e[:, :-1], odd), e[:, -1:]], axis=1)
    else:
        f = e
    if not bcs.periodic_x:
        # wall-normal Dirichlet columns belong to the smoother
        f = f.at[:, 0].set(0.0).at[:, -1].set(0.0)
    return f


def restrict_vx(f, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    """P^T/4 on the vx lattice (fine (2NY, 2NX+1) -> coarse (NY, NX+1));
    P^T/2 along the single coarsened axis under semi-coarsening.

    Periodic sides: the fine seam columns each carry HALF the physical
    residual (ops/stokes.py half-row convention); fold them into one
    unique-column array, restrict with x wrap-around, and re-emit the
    coarse seam as equal halves."""
    if bcs.periodic_x:
        if cy:
            fg = jnp.concatenate(
                [bcs.s_top * f[:1], f, bcs.s_bottom * f[-1:]], axis=0
            )
            g = (
                0.25 * fg[0:-3:2]
                + 0.75 * fg[1:-2:2]
                + 0.75 * fg[2:-1:2]
                + 0.25 * fg[3::2]
            ) / 2.0  # (NY, 2NX+1), still half-valued at the seam columns
        else:
            g = f
        if not cx:
            return g
        gu = g[:, :-1].at[:, 0].add(g[:, -1])  # unique columns, physical seam
        gz = jnp.concatenate([gu[:, -1:], gu], axis=1)  # left wrap ghost
        cu = (0.5 * gz[:, 0:-2:2] + 1.0 * gz[:, 1:-1:2] + 0.5 * gz[:, 2::2]) / 2.0
        seam = 0.5 * cu[:, :1]
        return jnp.concatenate([seam, cu[:, 1:], seam], axis=1)
    f = f.at[:, 0].set(0.0).at[:, -1].set(0.0)
    if cy:
        fg = jnp.concatenate([bcs.s_top * f[:1], f, bcs.s_bottom * f[-1:]], axis=0)
        # y: coarse row J <- 0.25 f[2J-1] + 0.75 f[2J] + 0.75 f[2J+1] + 0.25 f[2J+2]
        g = (
            0.25 * fg[0:-3:2]
            + 0.75 * fg[1:-2:2]
            + 0.75 * fg[2:-1:2]
            + 0.25 * fg[3::2]
        ) / 2.0  # (NY, 2NX+1)
    else:
        g = f
    if cx:
        # x: coarse col I <- 0.5 f[2I-1] + 1 f[2I] + 0.5 f[2I+1] (zero beyond walls)
        gz = jnp.pad(g, ((0, 0), (1, 1)))
        c = 0.5 * gz[:, 0:-2:2] + 1.0 * gz[:, 1:-1:2] + 0.5 * gz[:, 2::2]
        c = c / 2.0
    else:
        c = g
    c = c.at[:, 0].set(0.0).at[:, -1].set(0.0)
    return c


# -- vy-lattice transfers (shape (ny+1, nx)) -----------------------------------

def prolong_vy(c, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    c = c.at[0, :].set(0.0).at[-1, :].set(0.0)
    if cx:
        if bcs.periodic_x:
            cg = jnp.concatenate([c[:, -1:], c, c[:, :1]], axis=1)
        else:
            cg = jnp.concatenate(
                [bcs.s_left * c[:, :1], c, bcs.s_right * c[:, -1:]], axis=1
            )
        a0 = 0.25 * cg[:, :-2] + 0.75 * cg[:, 1:-1]
        a1 = 0.75 * cg[:, 1:-1] + 0.25 * cg[:, 2:]
        e = _interleave_cols(a0, a1)  # (NY+1, 2NX)
    else:
        e = c
    if cy:
        odd = 0.5 * (e[:-1, :] + e[1:, :])
        f = jnp.concatenate([_interleave_rows(e[:-1, :], odd), e[-1:, :]], axis=0)
    else:
        f = e
    f = f.at[0, :].set(0.0).at[-1, :].set(0.0)
    return f


def restrict_vy(f, bcs: VelocityBCs, cx: bool = True, cy: bool = True):
    f = f.at[0, :].set(0.0).at[-1, :].set(0.0)
    if cx:
        if bcs.periodic_x:
            fg = jnp.concatenate([f[:, -1:], f, f[:, :1]], axis=1)
        else:
            fg = jnp.concatenate(
                [bcs.s_left * f[:, :1], f, bcs.s_right * f[:, -1:]], axis=1
            )
        g = (
            0.25 * fg[:, 0:-3:2]
            + 0.75 * fg[:, 1:-2:2]
            + 0.75 * fg[:, 2:-1:2]
            + 0.25 * fg[:, 3::2]
        ) / 2.0
    else:
        g = f
    if cy:
        gz = jnp.pad(g, ((1, 1), (0, 0)))
        c = 0.5 * gz[0:-2:2, :] + 1.0 * gz[1:-1:2, :] + 0.5 * gz[2::2, :]
        c = c / 2.0
    else:
        c = g
    c = c.at[0, :].set(0.0).at[-1, :].set(0.0)
    return c


# -- level structure -----------------------------------------------------------

def momentum_apply(vx, vy, eta_s, eta_n, grid, bcs, kbnd, halo_mesh=None):
    """Momentum-block application (the saddle operator at p = 0).
    ``halo_mesh`` routes the apply through the explicit shard_map halo path
    (parallel/halo_ops.py)."""
    rx, ry, _ = stokes_operator(
        vx, vy, jnp.zeros(grid.shape_center, vx.dtype), eta_s, eta_n, grid, bcs,
        kcont=1.0, kbnd=kbnd, halo_mesh=halo_mesh,
    )
    return rx, ry


def chebyshev_smooth(ex, ey, rx, ry, eta_s, eta_n, grid, bcs, kbnd, lam_max,
                     iters, zero_init=False, emit_residual=False, diags=None,
                     halo_mesh=None):
    """``iters`` steps of the Chebyshev semi-iteration on D^-1 A e = D^-1 r
    over [lam_max/4, lam_max] (hypre/ML-style smoothing interval), from
    (ex, ey).  ``zero_init`` promises e = 0 on entry and skips the first
    apply.  Returns (ex, ey), or with ``emit_residual`` also
    (rx - A ex, ry - A ey).  ``diags``: the Jacobi diagonals D (default
    ``velocity_diagonals``)."""
    import jax.lax as _lax

    dvx, dvy = diags if diags is not None else velocity_diagonals(
        eta_s, eta_n, grid, kbnd, bcs=bcs)

    def apply(ex, ey):
        return momentum_apply(ex, ey, eta_s, eta_n, grid, bcs, kbnd,
                              halo_mesh=halo_mesh)

    lmin = lam_max / 4.0
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)
    sigma1 = theta / delta

    if zero_init:
        # A(0) = 0 exactly (kbnd rows included): skip the apply
        dx_ = rx / dvx / theta
        dy_ = ry / dvy / theta
    else:
        ax, ay = apply(ex, ey)
        dx_ = (rx - ax) / dvx / theta
        dy_ = (ry - ay) / dvy / theta
    ex = ex + dx_
    ey = ey + dy_

    def cbody(_, st):
        ex, ey, dx_, dy_, ro = st
        rho = 1.0 / (2.0 * sigma1 - ro)
        ax, ay = apply(ex, ey)
        dx_n = rho * ro * dx_ + (2.0 * rho / delta) * (rx - ax) / dvx
        dy_n = rho * ro * dy_ + (2.0 * rho / delta) * (ry - ay) / dvy
        return ex + dx_n, ey + dy_n, dx_n, dy_n, rho

    # fori_loop keeps the traced graph one apply deep (unrolled coarse-level
    # applies made solver compiles minutes-long)
    ex, ey, _, _, _ = _lax.fori_loop(
        0, iters - 1, cbody, (ex, ey, dx_, dy_, 1.0 / sigma1)
    )
    if not emit_residual:
        return ex, ey
    ax, ay = apply(ex, ey)
    return ex, ey, rx - ax, ry - ay


def _pressure_gradient(zp, grid, dtype, bcs: VelocityBCs | None = None):
    """G z_p: the +grad p part of the momentum rows (zero on Dirichlet
    rows; periodic sides: wrapped seam gradient under the half-row
    convention)."""
    if not grid.uniform:
        from pylamp_tpu.ops.stretched import pressure_gradient_stretched

        return pressure_gradient_stretched(zp, grid, dtype)
    gx_int = (zp[:, 1:] - zp[:, :-1]) / grid.dx
    if bcs is not None and bcs.periodic_x:
        seam = 0.5 * (zp[:, :1] - zp[:, -1:]) / grid.dx
        gx = jnp.concatenate([seam, gx_int, seam], axis=1)
    else:
        zeros_x = jnp.zeros((grid.ny, 1), dtype)
        gx = jnp.concatenate([zeros_x, gx_int, zeros_x], axis=1)
    gy_int = (zp[1:, :] - zp[:-1, :]) / grid.dy
    zeros_y = jnp.zeros((1, grid.nx), dtype)
    gy = jnp.concatenate([zeros_y, gy_int, zeros_y], axis=0)
    return gx, gy


def num_levels(grid: StaggeredGrid, requested: int = 0, min_cells: int = 4) -> int:
    n = 1
    nx, ny = grid.nx, grid.ny
    while nx % 2 == 0 and ny % 2 == 0 and min(nx, ny) > min_cells:
        nx //= 2
        ny //= 2
        n += 1
    if requested > 0:
        n = min(n, requested)
    return n


def coarsening_plan(
    grid: StaggeredGrid,
    requested: int = 0,
    min_cells: int = 4,
    semi_threshold: float = 0.0,
) -> list:
    """Per-level coarsening directions: a list of ``(cx, cy)`` steps, step l
    taking level l to level l+1 (``nlev = len(plan) + 1``).

    ``semi_threshold`` <= 0 reproduces full coarsening (``num_levels``
    exactly).  > 0 enables SEMI-COARSENING for anisotropic cells: when one
    axis's minimum spacing is at least ``semi_threshold`` times smaller than
    the other's, only that (finer) axis is coarsened — the axis along which
    point smoothers already damp errors well via the strong 1/h^2 coupling.
    Each semi step halves the anisotropy, so the plan converges to balanced
    cells and then full-coarsens; min-spacing ratios (rather than means)
    capture refined-band stretched grids, whose tightest cells set the
    smoother's difficulty."""
    plan = []
    g = grid
    while requested <= 0 or len(plan) < requested - 1:
        can_x = g.nx % 2 == 0 and g.nx > min_cells
        can_y = g.ny % 2 == 0 and g.ny > min_cells
        if semi_threshold <= 0:
            if not (can_x and can_y):
                break
            step = (True, True)
        elif g.dy_min >= semi_threshold * g.dx_min and can_x:
            step = (True, False)  # cells tall: x is the finer axis
        elif g.dx_min >= semi_threshold * g.dy_min and can_y:
            step = (False, True)
        elif can_x and can_y:
            step = (True, True)
        else:
            break
        plan.append(step)
        g = g.coarsen(*step)
    return plan


def _power_lambda_max(apply_Binv_A, shape_x, shape_y, dtype, iters=12):
    """Estimate lambda_max of D^-1 A on the coupled velocity space with
    power iteration (deterministic start vector; jittable).  ``iters`` may
    be a traced scalar (the warm-start path runs fewer refresh iterations)."""
    # deterministic pseudo-random start: cheap LCG-ish pattern, no host RNG
    def seed(shape):
        n = shape[0] * shape[1]
        v = (jnp.arange(n, dtype=dtype) * 0.754877666 + 0.1) % 1.0 - 0.5
        return v.reshape(shape)

    import jax.lax as _lax

    def body(_, st):
        vx, vy, _ = st
        nrm = jnp.sqrt(_vdot(vx, vx) + _vdot(vy, vy))
        vx, vy = vx / nrm, vy / nrm
        wx, wy = apply_Binv_A(vx, vy)
        lam = _vdot(vx, wx) + _vdot(vy, wy)
        return wx, wy, lam

    # fori_loop keeps the traced graph one-apply deep (12 unrolled applies
    # per level made solver compiles minutes-long)
    _, _, lam = _lax.fori_loop(
        0, iters, body, (seed(shape_x), seed(shape_y), jnp.asarray(1.0, dtype))
    )
    return lam


def gershgorin_lambda(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                      kbnd):
    """Rigorous Chebyshev upper bound on lambda_max(D^-1 A) for the coupled
    momentum operator on a UNIFORM grid, from Gershgorin row sums — NO
    operator applications.

    For the interior vx row the |off-diagonal| sum is the diagonal itself
    (the vx-vx couplings) plus the vx-vy cross couplings through sxy,
    2(eta_s[J+1] + eta_s[J])/(dx dy); so the row bound is
    2 + cross/diag <= 3, and analogously for vy.  Dirichlet rows contribute
    exactly 1.  BC ghost folding only merges coefficients (|a+b| <=
    |a|+|b|), so the interior formula upper-bounds every wall row too.
    Measured tightness: ~1.05x the power-iteration lambda on smooth
    viscosity (2.67 vs 2.55 at uniform eta), <= 3 always."""
    dvx, dvy = velocity_diagonals(eta_s, eta_n, grid, kbnd, bcs=bcs)
    dx, dy = grid.dx, grid.dy
    cross_vx = 2.0 * (eta_s[1:, 1:-1] + eta_s[:-1, 1:-1]) / (dx * dy)
    bx = jnp.max(cross_vx / dvx[:, 1:-1])
    cross_vy = 2.0 * (eta_s[1:-1, 1:] + eta_s[1:-1, :-1]) / (dx * dy)
    by = jnp.max(cross_vy / dvy[1:-1, :])
    return 2.0 + jnp.maximum(bx, by)


def estimate_mg_lambdas(
    eta_s,
    eta_n,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    kbnd,
    levels: int = 0,
    semicoarsen: float = 0.0,
    hint=None,
    fresh_iters: int = 12,
    refresh_iters: int = 2,
    mode: str = "power",
):
    """Per-level Chebyshev lambda_max bounds for the velocity MG hierarchy.

    Returns a (nlev,) array (including the safety margin) suitable for both
    ``make_velocity_mg(lam_max=...)`` and the next step's ``hint``.

    ``mode="gershgorin"`` (uniform grids): the analytic row-sum bound
    (``gershgorin_lambda``) — a few elementwise passes per level, no
    operator applies at all; rigorous, so Chebyshev can never amplify.
    Non-uniform levels fall back to power iteration.

    ``mode="power"``: per-level power iteration.  ``hint`` (the previous
    solve's estimates, e.g. ``ModelState.mg_lam``) switches levels with a
    positive entry from ``fresh_iters`` iterations to ``refresh_iters``
    and floors the result at 0.995x the hint — the viscosity field moves
    at most half a cell per step (Courant bound), so lambda_max drifts
    slowly; the floor keeps the Chebyshev interval safe through the short
    refresh.  Its cost is per-level dispatch of many small applies, which
    is why the production step refreshes on a cadence
    (SolverConfig.mg_lam_refresh_every) instead of every step."""
    plan = coarsening_plan(grid, levels, semi_threshold=semicoarsen)
    nlev = len(plan) + 1
    dtype = eta_n.dtype

    grids = [grid]
    etas = [(eta_s, eta_n)]
    for cx, cy in plan:
        grids.append(grids[-1].coarsen(cx, cy))
        etas.append(coarsen_eta(*etas[-1], cx=cx, cy=cy))
    kbnds = [
        kbnd * (grids[0].dx_min * grids[0].dy_min) / (g.dx_min * g.dy_min)
        for g in grids
    ]

    lams = []
    for l in range(nlev):
        es, en = etas[l]

        if mode == "gershgorin" and grids[l].uniform:
            lams.append(gershgorin_lambda(es, en, grids[l], bcs, kbnds[l]))
            continue

        dvx, dvy = velocity_diagonals(es, en, grids[l], kbnds[l], bcs=bcs)

        def binv_a(vx, vy, l=l, es=es, en=en, dvx=dvx, dvy=dvy):
            ax, ay = momentum_apply(vx, vy, es, en, grids[l], bcs, kbnds[l])
            return ax / dvx, ay / dvy

        if hint is None:
            iters = fresh_iters
        else:
            h = hint[l].astype(dtype)
            iters = jnp.where(h > 0, refresh_iters, fresh_iters)
        lam = _power_lambda_max(
            binv_a, grids[l].shape_vx, grids[l].shape_vy, dtype, iters=iters
        )
        lam = 1.1 * lam
        if hint is not None:
            lam = jnp.maximum(lam, 0.995 * hint[l].astype(dtype))
        lams.append(lam)
    return jnp.stack(lams)


def make_velocity_mg(
    eta_s,
    eta_n,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    kbnd,
    levels: int = 0,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega: float = 0.6,
    coarse_iters: int = 32,
    smoother: str = "chebyshev",
    scaled_transfers: bool = False,
    ls_damp: bool = False,
    mesh=None,
    coarse_replicate: int = 0,
    halo_mesh=None,
    semicoarsen: float = 0.0,
    lam_max=None,
    eta_cap: float = 0.0,
):
    """Returns mg(rx, ry) -> (zx, zy): `cycles` handled by the caller.

    ``lam_max``: optional (nlev,) per-level Chebyshev lambda_max bounds
    (from ``estimate_mg_lambdas``, typically warm-started across steps via
    ``ModelState.mg_lam``); None computes them here with 12 power
    iterations per level.

    ``pre_smooth``/``post_smooth`` are the Chebyshev polynomial degrees (or
    Jacobi sweep counts with smoother="jacobi").

    Extreme-contrast stabilizers (both measured on a 1e6-contrast sticky-air
    viscosity field, where the plain V-cycle amplifies the residual ~5e3x per
    cycle through the coarse correction):

    - ``scaled_transfers``: diagonally-scaled (operator-dependent) transfers
      R' = D_c^(1/2) R D_f^(-1/2), P' = D_f^(-1/2) P D_c^(1/2).  Prolonged
      corrections landing on faces whose fine-level stiffness exceeds the
      coarse level's are locally damped by the stiffness ratio, which stops
      soft-side coarse corrections from injecting contrast-scale momentum
      residuals across a viscosity interface (the classic jumping-
      coefficient remedy; smeared coarse coefficients under- represent the
      stiff side by ~sqrt(contrast)).
    - ``ls_damp``: per-level minimal-residual line search on the prolonged
      correction (x += alpha e with alpha = <r, Ae>/<Ae, Ae>), which makes
      every coarse correction monotone in the level residual norm whatever
      the coarse operator quality.  Costs one extra operator apply per
      level.

    Multi-chip coarse-level strategy (SURVEY.md §5 "long-context" row):
    with ``mesh`` set and ``coarse_replicate`` > 0, every level whose
    smaller extent is <= ``coarse_replicate`` cells is REPLICATED across
    the mesh (one all-gather at the restriction into that level) instead of
    staying domain-decomposed — an 8x8 grid sharded over 8 chips would
    otherwise serialize each smoother sweep on ICI latency.  The levels
    above it stay sharded; GSPMD re-propagates the decomposed layout after
    the prolongation back out of the replicated sub-hierarchy.
    """
    plan = coarsening_plan(grid, levels, semi_threshold=semicoarsen)
    nlev = len(plan) + 1
    dtype = eta_n.dtype

    grids = [grid]
    etas = [(eta_s, eta_n)]
    for cx, cy in plan:
        # stretched grids coarsen by dropping every other edge (along the
        # coarsened axes only under semi-coarsening)
        grids.append(grids[-1].coarsen(cx, cy))
        etas.append(coarsen_eta(*etas[-1], cx=cx, cy=cy))

    if eta_cap > 0.0:
        # eta-capped coarse hierarchy (sharp-interface robustness): clip
        # each COARSE level's viscosity to +-cap around its own geometric
        # mean.  Extreme contrast (sticky air: 1e4+ cell-sharp jumps)
        # makes the coarse-grid corrections locally wrong enough to slow
        # the whole cycle; capping only below the fine level leaves the
        # smoother's operator exact while the corrections come from a
        # milder surrogate.  The fine level is NEVER capped (level 0 must
        # smooth the true operator the inner Krylov iterates against).
        def _cap(a):
            gm = jnp.exp(jnp.mean(jnp.log(a)))
            return jnp.clip(a, gm / eta_cap, gm * eta_cap)

        etas = [etas[0]] + [(_cap(es), _cap(en)) for es, en in etas[1:]]

    # explicit-halo applies per level: skip levels that are replicated
    # across the mesh (coarse_replicate) — resharding a replicated level
    # back into blocks would defeat the replication; ops.stokes falls back
    # by itself on levels whose blocks are too small to halo.
    if halo_mesh is not None:
        hmesh = [
            None
            if (coarse_replicate > 0 and min(g.nx, g.ny) <= coarse_replicate)
            else halo_mesh
            for g in grids
        ]
    else:
        hmesh = [None] * nlev

    # per-level smoother diagonals; kbnd scales with 1/(dx*dy) like the
    # stencil (the per-axis form so semi-coarsened levels scale correctly;
    # identical to (dx0/dx)^2 when both axes coarsen proportionally, e.g.
    # uniform grids — on stretched grids coarse min-spacings are not exactly
    # 2x the fine ones, so the penalty scale differs slightly; benign, the
    # kbnd rows only set the Dirichlet-row magnitude)
    kbnds = [
        kbnd * (grids[0].dx_min * grids[0].dy_min) / (g.dx_min * g.dy_min)
        for g in grids
    ]
    diags = [
        velocity_diagonals(es, en, g, kb, bcs=bcs)
        for (es, en), g, kb in zip(etas, grids, kbnds)
    ]

    scales = (
        [(jnp.sqrt(dx_), jnp.sqrt(dy_)) for dx_, dy_ in diags]
        if scaled_transfers
        else None
    )

    if mesh is not None and coarse_replicate > 0:
        from jax.sharding import NamedSharding, PartitionSpec

        _replicated = NamedSharding(mesh, PartitionSpec())

        def _constrain(l, *arrays):
            """All-gather into the replicated sub-hierarchy at level l."""
            if min(grids[l].nx, grids[l].ny) <= coarse_replicate:
                import jax as _jax

                return tuple(
                    _jax.lax.with_sharding_constraint(a, _replicated)
                    for a in arrays
                )
            return arrays
    else:
        def _constrain(l, *arrays):
            return arrays

    # line smoothers (solvers/lines.py): exact tridiagonal sub/super
    # diagonals of the momentum stencil along each sweep axis, per level
    line_coeffs = None
    if smoother in ("line", "line_y", "line_x"):
        from pylamp_tpu.solvers.lines import line_axes, momentum_line_coeffs

        sweep_axes = line_axes(smoother)
        line_coeffs = [
            {
                ax: momentum_line_coeffs(es, en, g, bcs, ax)
                for ax in sweep_axes
            }
            for (es, en), g in zip(etas, grids)
        ]

    if lam_max is None and smoother == "chebyshev":
        lam_max = []
        for l in range(nlev):
            es, en = etas[l]
            dvx, dvy = diags[l]

            def binv_a(vx, vy, l=l, es=es, en=en, dvx=dvx, dvy=dvy):
                ax, ay = momentum_apply(vx, vy, es, en, grids[l], bcs, kbnds[l],
                                        halo_mesh=hmesh[l])
                return ax / dvx, ay / dvy

            lam = _power_lambda_max(
                binv_a, grids[l].shape_vx, grids[l].shape_vy, dtype
            )
            lam_max.append(1.1 * lam)
    elif lam_max is None:
        lam_max = []

    def smooth(l, ex, ey, rx, ry, iters, zero_init=False, emit_residual=False):
        """Returns (ex, ey), or (ex, ey, rx - A ex, ry - A ey) with
        ``emit_residual``."""
        es, en = etas[l]
        dvx, dvy = diags[l]
        g = grids[l]
        kb = kbnds[l]

        if smoother == "chebyshev":
            return chebyshev_smooth(
                ex, ey, rx, ry, es, en, g, bcs, kb, lam_max[l], iters,
                zero_init=zero_init, emit_residual=emit_residual,
                diags=diags[l], halo_mesh=hmesh[l],
            )

        import jax.lax as _lax

        def apply(ex, ey):
            return momentum_apply(ex, ey, es, en, g, bcs, kb,
                                  halo_mesh=hmesh[l])

        def _finish(ex, ey):
            if not emit_residual:
                return ex, ey
            ax, ay = apply(ex, ey)
            return ex, ey, rx - ax, ry - ay

        if line_coeffs is not None:
            # damped line Jacobi: x += omega * T^-1 (r - A x) with
            # T = D + L_axis + U_axis solved exactly by cyclic reduction,
            # alternating the axis within each iteration ("line" = xy)
            from pylamp_tpu.solvers.lines import tridiag_pcr

            coeffs = line_coeffs[l]

            def lsweep(ex, ey):
                for ax, (svx, pvx, svy, pvy) in coeffs.items():
                    axx, ayy = apply(ex, ey)
                    ex = ex + omega * tridiag_pcr(svx, dvx, pvx, rx - axx,
                                                  axis=ax)
                    ey = ey + omega * tridiag_pcr(svy, dvy, pvy, ry - ayy,
                                                  axis=ax)
                return ex, ey

            def lbody(_, st):
                return lsweep(*st)

            return _finish(*_lax.fori_loop(0, iters, lbody, (ex, ey)))

        # damped Jacobi
        def jbody(_, st):
            ex, ey = st
            ax, ay = apply(ex, ey)
            return ex + omega * (rx - ax) / dvx, ey + omega * (ry - ay) / dvy

        return _finish(*_lax.fori_loop(0, iters, jbody, (ex, ey)))

    def vcycle(l, rx, ry, emit=False):
        """``emit``: also return (rx - A ex, ry - A ey) of the cycle's
        result (for multi-cycle callers)."""
        if l == nlev - 1:
            ex = jnp.zeros_like(rx)
            ey = jnp.zeros_like(ry)
            return smooth(l, ex, ey, rx, ry, coarse_iters, zero_init=True,
                          emit_residual=emit)
        ex = jnp.zeros_like(rx)
        ey = jnp.zeros_like(ry)
        # pre-smooth, emitting the residual the restriction takes
        ex, ey, rfx, rfy = smooth(l, ex, ey, rx, ry, pre_smooth,
                                  zero_init=True, emit_residual=True)
        pcx, pcy = plan[l]
        if scaled_transfers:
            sfx, sfy = scales[l]
            scx, scy = scales[l + 1]
            rcx = scx * restrict_vx(rfx / sfx, bcs, cx=pcx, cy=pcy)
            rcy = scy * restrict_vy(rfy / sfy, bcs, cx=pcx, cy=pcy)
            rcx, rcy = _constrain(l + 1, rcx, rcy)
            ecx, ecy = vcycle(l + 1, rcx, rcy)
            pex = prolong_vx(scx * ecx, bcs, cx=pcx, cy=pcy) / sfx
            pey = prolong_vy(scy * ecy, bcs, cx=pcx, cy=pcy) / sfy
        else:
            rcx = restrict_vx(rfx, bcs, cx=pcx, cy=pcy)
            rcy = restrict_vy(rfy, bcs, cx=pcx, cy=pcy)
            rcx, rcy = _constrain(l + 1, rcx, rcy)
            ecx, ecy = vcycle(l + 1, rcx, rcy)
            pex = prolong_vx(ecx, bcs, cx=pcx, cy=pcy)
            pey = prolong_vy(ecy, bcs, cx=pcx, cy=pcy)
        if ls_damp:
            aex, aey = momentum_apply(pex, pey, *etas[l], grids[l], bcs,
                                      kbnds[l], halo_mesh=hmesh[l])
            # alpha = <r, Ae>/<Ae, Ae>, computed on Ae/s with
            # s = max|Ae| so the squared sums cannot overflow f32 (momentum
            # entries reach ~1e15 at mantle viscosities; their squares do
            # not fit in f32).
            s = jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(aex)), jnp.max(jnp.abs(aey))),
                jnp.finfo(rx.dtype).tiny,
            )
            uex, uey = aex / s, aey / s
            num = _vdot(rfx, uex) + _vdot(rfy, uey)
            den = s * (_vdot(uex, uex) + _vdot(uey, uey))
            alpha = num / jnp.maximum(den, jnp.finfo(rx.dtype).tiny)
            ex = ex + alpha * pex
            ey = ey + alpha * pey
        else:
            ex = ex + pex
            ey = ey + pey
        return smooth(l, ex, ey, rx, ry, post_smooth, emit_residual=emit)

    def mg(rx, ry, emit=False):
        return vcycle(0, rx, ry, emit=emit)

    return mg


def make_mg_preconditioner(
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
    omega: float = 0.6,
    smoother: str = "chebyshev",
    scaled_transfers: bool = False,
    ls_damp: bool = False,
    mesh=None,
    coarse_replicate: int = 0,
    halo_mesh=None,
    semicoarsen: float = 0.0,
    lam_max=None,
    schur: str = "mass",
    schur_poisson_iters: int = 3,
    velocity_inner_iters: int = 0,
    velocity_inner_tol: float = 3e-2,
    velocity_inner_method: str = "fgmres",
    eta_cap: float = 0.0,
    al_gamma: float = 0.0,
):
    """Block upper-triangular preconditioner for the full Stokes system.

    ``lam_max``: optional warm-started per-level Chebyshev bounds (see
    make_velocity_mg / estimate_mg_lambdas).

    ``schur``: the pressure Schur complement surrogate —
    - "mass": local inverse-viscosity mass scaling -(eta_n/kcont) r_c
      (cheap; degrades badly on sharp-interface extreme contrast);
    - "wbfbt": weighted BFBT (solvers/bfbt.py) — contrast-robust, costs
      two pressure-Poisson V-cycle solves (``schur_poisson_iters``
      flexible-CG iterations each) plus one momentum apply per
      application.

    ``velocity_inner_iters`` > 0 replaces the single V-cycle on the
    velocity block with a loose inner FGMRES solve (V-cycle-preconditioned,
    ``velocity_inner_tol`` relative, at most that many iterations).  At
    extreme sharp-interface contrast one V-cycle reduces the momentum
    residual only marginally, and the outer saddle iteration count is set
    by that velocity quality (measured: sticky-air 128x32 needs 1488 outer
    iterations with one V-cycle but only 34 with the velocity block solved
    exactly) — a handful of inner iterations buys most of that back for a
    small multiple of the per-application cost.
    """
    if bcs is None:
        bcs = VelocityBCs()
    mg = make_velocity_mg(
        eta_s, eta_n, grid, bcs, kbnd,
        levels=levels, pre_smooth=pre_smooth, post_smooth=post_smooth, omega=omega,
        smoother=smoother,
        scaled_transfers=scaled_transfers, ls_damp=ls_damp,
        mesh=mesh, coarse_replicate=coarse_replicate, halo_mesh=halo_mesh,
        semicoarsen=semicoarsen, lam_max=lam_max, eta_cap=eta_cap,
    )
    dtype = eta_n.dtype

    if schur == "wbfbt" and bcs.periodic_x:
        raise ValueError(
            "schur='wbfbt' has no periodic-wrap pressure-Poisson path yet; "
            "use schur='mass' with periodic side walls"
        )
    if schur == "wbfbt":
        from pylamp_tpu.solvers.bfbt import make_bfbt_schur
        from pylamp_tpu.solvers.scaling import characteristic_viscosity

        S_inv = make_bfbt_schur(
            eta_s, eta_n, grid, bcs, kcont, kbnd,
            characteristic_viscosity(eta_n),
            poisson_iters=schur_poisson_iters,
        )
    elif schur == "mass":
        # with the augmented-Lagrangian row op (solvers/al.py) the Schur
        # surrogate gains the grad-div contribution: S_gamma^-1 ~
        # -(1 + gamma) eta_n / kcont (contrast-robust for moderate gamma)
        _sschur = 1.0 + al_gamma

        def S_inv(rc):
            return -_sschur * (eta_n / kcont) * rc
    else:
        raise ValueError(f"unknown schur surrogate {schur!r}")

    gd = None
    if al_gamma > 0.0:
        from pylamp_tpu.solvers.al import make_grad_div

        gd = make_grad_div(eta_n, grid, bcs, al_gamma, dtype)

    if velocity_inner_iters > 0:
        from pylamp_tpu.solvers.krylov import fcg as _fcg
        from pylamp_tpu.solvers.krylov import fgmres as _fgmres

        def vel_solve(rvx, rvy):
            def vop(u):
                ax, ay = momentum_apply(u[0], u[1], eta_s, eta_n, grid, bcs,
                                        kbnd, halo_mesh=halo_mesh)
                if gd is not None:
                    # inner Krylov targets the AUGMENTED velocity block
                    # A + gamma D^T(eta_n D), preconditioned by the
                    # un-augmented V-cycle (robust for moderate gamma)
                    tx, ty = gd(u[0], u[1])
                    ax = ax + tx
                    ay = ay + ty
                return ax, ay

            if velocity_inner_method == "fcg":
                # the momentum block is SPD and the V-cycle approximately
                # so: flexible CG needs no stored basis / orthogonalization
                # sweep — each iteration is one apply + one V-cycle + two
                # dots (vs the growing CGS pass of FGMRES)
                z, _ = _fcg(
                    vop, (rvx, rvy),
                    (jnp.zeros_like(rvx), jnp.zeros_like(rvy)),
                    M=lambda r: mg(r[0], r[1]),
                    tol=velocity_inner_tol,
                    maxiter=velocity_inner_iters,
                )
            else:
                z, _ = _fgmres(
                    vop, (rvx, rvy),
                    (jnp.zeros_like(rvx), jnp.zeros_like(rvy)),
                    M=lambda r: mg(r[0], r[1]),
                    tol=velocity_inner_tol,
                    restart=velocity_inner_iters,
                    maxiter=velocity_inner_iters,
                    cgs_passes=1,
                )
            return z
    else:
        def vel_solve(rvx, rvy):
            # first cycle starts from zero: its residual IS (rvx, rvy).
            # Multi-cycle: each non-final cycle's post-smooth emits the
            # running residual for the next cycle.
            if cycles == 1:
                return mg(rvx, rvy)
            zx, zy, rfx, rfy = mg(rvx, rvy, emit=True)
            for c in range(cycles - 1):
                if c == cycles - 2:
                    dx_, dy_ = mg(rfx, rfy)
                else:
                    dx_, dy_, rfx, rfy = mg(rfx, rfy, emit=True)
                zx = zx + dx_
                zy = zy + dy_
            return zx, zy

    from pylamp_tpu.solvers.stokes_solver import project_vx_mean, vx_nullspace

    project = vx_nullspace(bcs)

    def M(r):
        rx, ry, rc = r
        zp = S_inv(rc)
        zp = zp - jnp.mean(zp)
        gx, gy = _pressure_gradient(zp, grid, dtype, bcs=bcs)
        zx, zy = vel_solve(rx - gx, ry - gy)
        if project:
            zx = project_vx_mean(zx)
        return (zx, zy, zp)

    return M
