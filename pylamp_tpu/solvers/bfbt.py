"""Weighted-BFBT Schur complement preconditioner for extreme viscosity
contrast.

Round-2 measurement (VALIDATION.md, sticky-air): with the velocity block
solved EXACTLY, the diag-Schur-preconditioned saddle solve still needs
>600 Krylov iterations at sharp 1e4 viscosity contrast — the pressure
Schur surrogate ``z_p = -(eta_n/kcont) r_c`` (a local inverse-viscosity
mass matrix) is the sticky-air bottleneck, not the velocity multigrid.
The known contrast-robust replacement is the *weighted BFBT* approximation
(Elman's BFBt with viscosity-dependent diagonal weighting; Rudi, Stadler &
Ghattas, SISC 2017, use it for 1e6+ contrast mantle flow):

    S^-1  ~=  K^-1 (B C^-1 A C^-1 G) K^-1 ,     K = B C^-1 G

with C = diag(w) on the velocity faces and w = sqrt(eta_face / eta_char)
(the normalization by the characteristic viscosity keeps every f32
intermediate O(1)-ranged; BFBT is invariant under C -> s*C).  In our
conventions (ops/stokes.py: momentum rows carry +grad p, continuity rows
carry kcont*div v) this becomes

    S^-1 r  =  (1/kcont) * Khat^-1 [ div( C^-1 A C^-1 grad (Khat^-1 r) ) ]

where Khat = -div( (1/w) grad ) is an SPSD variable-coefficient pressure
Poisson operator on the cell-center lattice (pure-Neumann: wall faces
carry zero coefficient because the discrete gradient is zero on Dirichlet
velocity rows), with the constant nullspace handled by mean projection.
In the isoviscous limit the formula reduces analytically to the mass
surrogate -(eta/kcont) r — same sign and scale, so it drops into the
block-triangular preconditioner unchanged.

Khat^-1 is applied approximately: a cell-centered geometric-multigrid
V-cycle (bilinear transfers with Neumann ghosts, rediscretized coarse
coefficients from geometric-mean-coarsened viscosity — the same hierarchy
rule as the velocity MG), optionally wrapped in a few flexible-CG
iterations.  Everything is static-shaped slicing: XLA fuses each level,
GSPMD shards it like any other center field.

MEASURED STATUS (round 3, tests/test_bfbt.py): on marker-smoothed
interface fields wbfbt converges and agrees with the mass surrogate; on
CELL-SHARP step coefficients it stagnates at ~0.6 relative residual in
any precision (the known BFBT boundary/commutator degradation near
Dirichlet walls).  The production fix for sticky-air-class contrast is
NOT a better Schur surrogate but a better velocity block: with the
velocity block solved exactly, even the mass surrogate needs only ~34
outer iterations on sticky air (vs 1488 with one V-cycle), so
``SolverConfig.mg_velocity_inner_iters`` (a loose inner FGMRES around the
V-cycle, solvers/mg.py) is the default production path — divergence-free
at 512x128 where wbfbt stagnates.  wbfbt remains available
(``schur="wbfbt"``) for smooth-coefficient problems.
"""
from __future__ import annotations

import jax.numpy as jnp

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.solvers.krylov import vdot


# -- the weighted pressure Poisson operator  Khat = -div((1/w) grad) ----------

def face_coeffs(eta_n, eta_char):
    """Interior-face coefficients c = 1/w = 1/sqrt(eta_face/eta_char), with
    eta_face the geometric mean of the two adjacent cell viscosities.
    Returns (cx (ny, nx-1), cy (ny-1, nx))."""
    ln = jnp.log(eta_n) - jnp.log(eta_char)
    cx = jnp.exp(-0.25 * (ln[:, 1:] + ln[:, :-1]))
    cy = jnp.exp(-0.25 * (ln[1:, :] + ln[:-1, :]))
    return cx, cy


def poisson_apply(z, cx, cy, grid: StaggeredGrid):
    """Khat z = -div(c grad z) on the center lattice; wall faces carry zero
    flux (pure Neumann; SPSD with constant nullspace)."""
    dx, dy = grid.dx, grid.dy
    fx = cx * (z[:, 1:] - z[:, :-1]) / dx  # interior x-face fluxes
    fy = cy * (z[1:, :] - z[:-1, :]) / dy
    zx = jnp.zeros_like(z[:, :1])
    zy = jnp.zeros_like(z[:1, :])
    fxp = jnp.concatenate([zx, fx, zx], axis=1)  # (ny, nx+1)
    fyp = jnp.concatenate([zy, fy, zy], axis=0)  # (ny+1, nx)
    return -((fxp[:, 1:] - fxp[:, :-1]) / dx + (fyp[1:, :] - fyp[:-1, :]) / dy)


def poisson_diag(cx, cy, grid: StaggeredGrid):
    dx2, dy2 = grid.dx ** 2, grid.dy ** 2
    zx = jnp.zeros_like(cx[:, :1])
    zy = jnp.zeros_like(cy[:1, :])
    cxp = jnp.concatenate([zx, cx, zx], axis=1)
    cyp = jnp.concatenate([zy, cy, zy], axis=0)
    return (cxp[:, 1:] + cxp[:, :-1]) / dx2 + (cyp[1:, :] + cyp[:-1, :]) / dy2


# -- cell-centered transfers ---------------------------------------------------

def prolong_center(c):
    """Bilinear cell-centered prolongation with Neumann (copy) ghosts:
    coarse (NY, NX) -> fine (2NY, 2NX); fine centers sit at +-1/4 of the
    coarse spacing, weights (9, 3, 3, 1)/16."""
    g = jnp.pad(c, 1, mode="edge")
    # x first: each coarse column I spawns fine columns (left, right)
    left = 0.75 * g[:, 1:-1] + 0.25 * g[:, :-2]
    right = 0.75 * g[:, 1:-1] + 0.25 * g[:, 2:]
    e = jnp.stack([left, right], axis=2).reshape(g.shape[0], -1)  # (NY+2, 2NX)
    up = 0.75 * e[1:-1, :] + 0.25 * e[:-2, :]
    dn = 0.75 * e[1:-1, :] + 0.25 * e[2:, :]
    return jnp.stack([up, dn], axis=1).reshape(-1, e.shape[1])  # (2NY, 2NX)


def restrict_center(f):
    """Adjoint of prolong_center / 4 (the Neumann ghosts fold the boundary
    weights back into the edge cells)."""
    ny2, nx2 = f.shape
    # y: coarse row J gathers fine rows 2J, 2J+1 with weight 3/4 and the
    # outer neighbours 2J-1, 2J+2 with 1/4 (folded at the walls)
    a = 0.75 * f[0::2, :] + 0.75 * f[1::2, :]
    outer_up = jnp.concatenate([f[:1, :] * 0, f[1:-1:2, :] * 0.25], axis=0)
    outer_dn = jnp.concatenate([f[2::2, :] * 0.25, f[:1, :] * 0], axis=0)
    fold_up = jnp.concatenate([f[:1, :] * 0.25, jnp.zeros_like(f[1:-1:2, :])], axis=0)
    fold_dn = jnp.concatenate([jnp.zeros_like(f[2::2, :]), f[-1:, :] * 0.25], axis=0)
    g = a + outer_up + outer_dn + fold_up + fold_dn  # (NY, nx2)
    b = 0.75 * g[:, 0::2] + 0.75 * g[:, 1::2]
    outer_l = jnp.concatenate([g[:, :1] * 0, g[:, 1:-1:2] * 0.25], axis=1)
    outer_r = jnp.concatenate([g[:, 2::2] * 0.25, g[:, :1] * 0], axis=1)
    fold_l = jnp.concatenate([g[:, :1] * 0.25, jnp.zeros_like(g[:, 1:-1:2])], axis=1)
    fold_r = jnp.concatenate([jnp.zeros_like(g[:, 2::2]), g[:, -1:] * 0.25], axis=1)
    return (b + outer_l + outer_r + fold_l + fold_r) / 4.0


# -- pressure Poisson multigrid ------------------------------------------------

def _num_levels(grid: StaggeredGrid, requested: int = 0, min_cells: int = 4) -> int:
    n = 1
    nx, ny = grid.nx, grid.ny
    while nx % 2 == 0 and ny % 2 == 0 and min(nx, ny) > min_cells:
        nx //= 2
        ny //= 2
        n += 1
    if requested > 0:
        n = min(n, requested)
    return n


def _power_lambda_max(apply_binv_a, shape, dtype, iters: int = 12):
    from jax import lax

    n = shape[0] * shape[1]
    v0 = ((jnp.arange(n, dtype=dtype) * 0.754877666 + 0.1) % 1.0 - 0.5).reshape(shape)
    v0 = v0 - jnp.mean(v0)  # stay orthogonal to the nullspace

    def body(_, st):
        v, _ = st
        v = v / jnp.sqrt(vdot(v, v))
        w = apply_binv_a(v)
        return w - jnp.mean(w), vdot(v, w)

    _, lam = lax.fori_loop(0, iters, body, (v0, jnp.asarray(1.0, dtype)))
    return jnp.abs(lam)


def make_pressure_poisson_mg(
    eta_n,
    grid: StaggeredGrid,
    eta_char,
    levels: int = 0,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    coarse_iters: int = 24,
):
    """V-cycle preconditioner for Khat (mean-projected in and out)."""
    nlev = _num_levels(grid, levels)
    dtype = eta_n.dtype

    grids = [grid]
    etas = [eta_n]
    for _ in range(nlev - 1):
        g = grids[-1]
        grids.append(StaggeredGrid(nx=g.nx // 2, ny=g.ny // 2, lx=g.lx, ly=g.ly))
        e = etas[-1]
        etas.append(
            jnp.exp(
                0.25
                * (
                    jnp.log(e[0::2, 0::2])
                    + jnp.log(e[0::2, 1::2])
                    + jnp.log(e[1::2, 0::2])
                    + jnp.log(e[1::2, 1::2])
                )
            )
        )
    coeffs = [face_coeffs(e, eta_char) for e in etas]
    diags = [
        jnp.maximum(poisson_diag(cx, cy, g), jnp.finfo(dtype).tiny)
        for (cx, cy), g in zip(coeffs, grids)
    ]

    def apply_l(l, z):
        cx, cy = coeffs[l]
        return poisson_apply(z, cx, cy, grids[l])

    lam = [
        1.1
        * _power_lambda_max(
            (lambda v, l=l: apply_l(l, v) / diags[l]), grids[l].shape_center, dtype
        )
        for l in range(nlev)
    ]

    def smooth(l, x, b, iters):
        from jax import lax

        d = diags[l]
        lmax = lam[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        s1 = theta / delta
        dx_ = (b - apply_l(l, x)) / d / theta
        x = x + dx_
        ro = 1.0 / s1

        def body(_, st):
            x, dx_, ro = st
            rho = 1.0 / (2.0 * s1 - ro)
            dx_n = rho * ro * dx_ + (2.0 * rho / delta) * (b - apply_l(l, x)) / d
            return x + dx_n, dx_n, rho

        x, _, _ = lax.fori_loop(0, iters - 1, body, (x, dx_, ro))
        return x

    def vcycle(l, b):
        if l == nlev - 1:
            return smooth(l, jnp.zeros_like(b), b, coarse_iters)
        x = smooth(l, jnp.zeros_like(b), b, pre_smooth)
        r = b - apply_l(l, x)
        ec = vcycle(l + 1, restrict_center(r))
        x = x + prolong_center(ec)
        return smooth(l, x, b, post_smooth)

    def M(r):
        z = vcycle(0, r - jnp.mean(r))
        return z - jnp.mean(z)

    return M


# -- the weighted-BFBT Schur application --------------------------------------

def make_bfbt_schur(
    eta_s,
    eta_n,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    kcont,
    kbnd,
    eta_char,
    poisson_iters: int = 3,
    poisson_tol: float = 1e-2,
    mg_levels: int = 0,
):
    """Returns S_inv(r_c) -> z_p implementing the weighted-BFBT formula.

    ``poisson_iters``: flexible-CG iterations per Khat solve (each
    preconditioned by one V-cycle); 0 = a single V-cycle, no Krylov wrap.
    """
    if not grid.uniform:
        raise ValueError(
            "the w-BFBT Schur surrogate has no stretched-grid path yet; use "
            "schur='mass' on stretched grids"
        )
    from pylamp_tpu.solvers.krylov import fcg
    from pylamp_tpu.solvers.mg import _pressure_gradient, momentum_apply

    dtype = eta_n.dtype
    ln_char = jnp.log(eta_char)

    # C^-1 on the velocity faces: 1/w with w = sqrt(eta_face/eta_char).
    # Boundary faces never see a nonzero input (grad is zero on Dirichlet
    # rows) — pad with 1s.
    lnn = jnp.log(eta_n) - ln_char
    winv_x_int = jnp.exp(-0.25 * (lnn[:, 1:] + lnn[:, :-1]))  # (ny, nx-1)
    one_x = jnp.ones_like(winv_x_int[:, :1])
    winv_x = jnp.concatenate([one_x, winv_x_int, one_x], axis=1)  # (ny, nx+1)
    winv_y_int = jnp.exp(-0.25 * (lnn[1:, :] + lnn[:-1, :]))
    one_y = jnp.ones_like(winv_y_int[:1, :])
    winv_y = jnp.concatenate([one_y, winv_y_int, one_y], axis=0)  # (ny+1, nx)

    cx, cy = face_coeffs(eta_n, eta_char)
    Mpp = make_pressure_poisson_mg(eta_n, grid, eta_char, levels=mg_levels)

    def khat(z):
        return poisson_apply(z, cx, cy, grid)

    # f32 safety: the raw composition spans ~40 orders of magnitude
    # (pressure residuals ~1e14, Poisson solutions ~h^2 larger, momentum
    # outputs ~eta/h^2 larger still), so Krylov dot products inside the
    # K solves overflow f32 (measured: pAp -> inf -> alpha -> 0 -> the
    # solve silently returns 0 and the preconditioner collapses).  Each
    # K solve therefore normalizes its input to O(1) and the middle
    # momentum apply runs as A/eta_char; everything is linear, so the
    # scales recombine exactly in the final factor.
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    if poisson_iters > 0:
        def ksolve(r):
            r = r - jnp.mean(r)
            s = jnp.maximum(jnp.max(jnp.abs(r)), tiny)
            z, _ = fcg(khat, r / s, jnp.zeros_like(r), M=Mpp,
                       tol=poisson_tol, maxiter=poisson_iters)
            return (z - jnp.mean(z)), s
    else:
        def ksolve(r):
            r = r - jnp.mean(r)
            s = jnp.maximum(jnp.max(jnp.abs(r)), tiny)
            return Mpp(r / s), s

    def div(vx, vy):
        return (vx[:, 1:] - vx[:, :-1]) / grid.dx + (vy[1:, :] - vy[:-1, :]) / grid.dy

    inv_echar = (1.0 / eta_char).astype(dtype)
    # eta_char/kcont = (dx+dy)/2 by construction (solvers/scaling.py) — an
    # O(h) factor, but keep it symbolic so custom kcont values stay correct
    out_scale = (eta_char / kcont).astype(dtype)

    def S_inv(rc):
        z1, s1 = ksolve(rc)
        gx, gy = _pressure_gradient(z1, grid, dtype)
        ux, uy = gx * winv_x, gy * winv_y
        ax, ay = momentum_apply(ux, uy, eta_s, eta_n, grid, bcs, kbnd)
        mid = div(ax * inv_echar * winv_x, ay * inv_echar * winv_y)
        z2, s2 = ksolve(mid)
        return z2 * (s1 * s2 * out_scale)

    return S_inv
