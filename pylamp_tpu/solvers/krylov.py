"""Matrix-free Krylov solvers on pytrees.

These replace the reference's direct sparse solve (`scipy...spsolve`,
SURVEY.md §3.2 "HOT: SuperLU factorization") with iterative methods that run
entirely on-device: the operator is a fused stencil application, vectors are
pytrees of grid arrays (so GSPMD shardings are preserved across iterations,
and the only cross-chip syncs are the dot-product `psum`s).

- ``cg``     preconditioned conjugate gradients (SPD systems: energy solve)
- ``fgmres`` flexible right-preconditioned GMRES(m) for the Stokes saddle
  point.  Orthogonalization is classical Gram-Schmidt with
  reorthogonalization (CGS2): two batched reductions per iteration instead
  of a sequential MGS sweep, with MGS-level stability.

All loops are ``lax.while_loop``s so the solvers jit once with static shapes
and run without host round-trips.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class SolveInfo(NamedTuple):
    iterations: jnp.ndarray  # total operator applications
    residual: jnp.ndarray  # final (preconditioned-system) residual norm
    converged: jnp.ndarray  # bool
    bnorm: jnp.ndarray = None  # ||b||: residual/bnorm is the relative residual


# -- pytree vector helpers --------------------------------------------------

# Every solver dot product asks for full precision: on a GPU, XLA may
# otherwise run f32 dots/tensordots in TF32 (~3 decimal digits), which
# would quietly break the orthogonality of the CGS2 Krylov basis and the
# Chebyshev/CG scalars.
_HIGHEST = lax.Precision.HIGHEST


def vdot(a, b):
    """Full-precision dot product of two arrays."""
    return jnp.vdot(a, b, precision=_HIGHEST)


def tdot(a, b):
    """Global dot product over a pytree (real)."""
    return sum(jax.tree.leaves(jax.tree.map(vdot, a, b)))


def tnorm(a):
    return jnp.sqrt(tdot(a, a))


def taxpy(alpha, x, y):
    """alpha * x + y"""
    return jax.tree.map(lambda xl, yl: alpha * xl + yl, x, y)


def tscale(alpha, x):
    return jax.tree.map(lambda xl: alpha * xl, x)

def tsub(x, y):
    return jax.tree.map(lambda a, b: a - b, x, y)


def _identity(x):
    return x


# -- CG ----------------------------------------------------------------------

def cg(
    op: Callable,
    b: Any,
    x0: Any,
    M: Callable | None = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
):
    """Preconditioned conjugate gradients. Returns (x, SolveInfo)."""
    M = M or _identity
    bnorm = tnorm(b)
    target = jnp.maximum(tol * bnorm, atol)

    r0 = tsub(b, op(x0))
    z0 = M(r0)
    rz0 = tdot(r0, z0)

    def cond(state):
        _, r, _, _, _, k = state
        return jnp.logical_and(tnorm(r) > target, k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = op(p)
        pAp = tdot(p, Ap)
        # Breakdown guard: a (near-)singular or indefinite direction
        # (p'Ap <= 0) or rz == 0 would turn alpha/beta into inf/NaN and
        # silently fill the state with NaNs; exit with the current iterate
        # instead (k -> maxiter makes cond false).
        ok = jnp.logical_and(pAp > 0, jnp.abs(rz) > 0)
        safe = jnp.where(pAp == 0, 1.0, pAp)
        alpha = jnp.where(ok, rz / safe, 0.0)
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, Ap, r)
        z = M(r)
        rz_new = tdot(r, z)
        beta = jnp.where(ok, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p = taxpy(beta, p, z)
        return x, r, z, p, rz_new, jnp.where(ok, k + 1, maxiter)

    x, r, _, _, _, k = lax.while_loop(cond, body, (x0, r0, z0, z0, rz0, jnp.array(0)))
    res = tnorm(r)
    return x, SolveInfo(k, res, res <= target, bnorm)


def fcg(
    op: Callable,
    b,
    x0,
    M: Callable | None = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
):
    """Flexible preconditioned CG (Polak-Ribiere beta; Notay 2000).

    Use instead of ``cg`` when the preconditioner is only approximately
    SPD — e.g. a multigrid V-cycle, whose Chebyshev smoothing + masked
    Dirichlet transfers are not an exact ell2-symmetric operator.  Standard
    CG's Fletcher-Reeves beta silently loses conjugacy against such an M
    (measured on the energy MG: 735 iterations where this method needs
    ~15); the flexible beta re-orthogonalizes against the previous
    direction only, which is robust to the asymmetry at the cost of one
    extra stored pytree."""
    M = M or _identity
    bnorm = tnorm(b)
    target = jnp.maximum(tol * bnorm, atol)

    r0 = tsub(b, op(x0))
    z0 = M(r0)
    rz0 = tdot(r0, z0)

    def cond(state):
        _, r, *_, k = state
        return jnp.logical_and(tnorm(r) > target, k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = op(p)
        pAp = tdot(p, Ap)
        # Breakdown guard (see cg): the approximately-SPD V-cycle
        # preconditioner can produce rz == 0 or an indefinite direction;
        # exit with the current iterate rather than NaN-filling the state.
        ok = jnp.logical_and(pAp > 0, jnp.abs(rz) > 0)
        safe_pAp = jnp.where(pAp == 0, 1.0, pAp)
        safe_rz = jnp.where(rz == 0, 1.0, rz)
        alpha = jnp.where(ok, rz / safe_pAp, 0.0)
        x = taxpy(alpha, p, x)
        r_new = taxpy(-alpha, Ap, r)
        z_new = M(r_new)
        # Polak-Ribiere: beta = <r_new, z_new - z> / <r, z>
        beta = jnp.where(ok, (tdot(r_new, z_new) - tdot(r_new, z)) / safe_rz, 0.0)
        rz_new = tdot(r_new, z_new)
        p = taxpy(beta, p, z_new)
        return x, r_new, z_new, p, rz_new, jnp.where(ok, k + 1, maxiter)

    x, r, _, _, _, k = lax.while_loop(cond, body, (x0, r0, z0, z0, rz0, jnp.array(0)))
    res = tnorm(r)
    return x, SolveInfo(k, res, res <= target, bnorm)


# -- FGMRES(m) ----------------------------------------------------------------

def _stack_like(x, m):
    return jax.tree.map(lambda l: jnp.zeros((m,) + l.shape, l.dtype), x)


def _basis_set(V, k, v):
    return jax.tree.map(lambda Vl, vl: Vl.at[k].set(vl), V, v)


def _basis_dots(V, w):
    """h[j] = <V[j], w> for all j, batched (one fused reduction per leaf)."""
    def leaf(Vl, wl):
        return jnp.tensordot(Vl, wl, axes=(tuple(range(1, Vl.ndim)), tuple(range(wl.ndim))),
                             precision=_HIGHEST)
    parts = jax.tree.leaves(jax.tree.map(leaf, V, w))
    return sum(parts)


def _basis_comb(V, y):
    """sum_j y[j] * V[j]"""
    return jax.tree.map(
        lambda Vl: jnp.tensordot(y, Vl, axes=(0, 0), precision=_HIGHEST), V)


def fgmres(
    op: Callable,
    b: Any,
    x0: Any,
    M: Callable | None = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 1000,
    stagnation: float = 0.95,
    cgs_passes: int = 2,
):
    """Flexible right-preconditioned GMRES(m).

    ``M`` may itself be an (inner) iterative procedure — the flexible
    variant stores the preconditioned basis Z so M need not be a fixed
    linear operator.  Returns (x, SolveInfo); iterations counts operator
    applications.

    ``stagnation``: stop early when a whole restart cycle reduces the true
    residual by less than this factor — in particular when the working
    precision's roundoff floor is reached (f32; the mixed-precision
    wrapper in solvers/refine.py then takes over).
    """
    M = M or _identity
    m = restart
    bnorm = tnorm(b)
    target = jnp.maximum(tol * bnorm, atol)
    dtype = jnp.result_type(*jax.tree.leaves(b))

    def inner_cycle(x):
        r = tsub(b, op(x))
        beta = tnorm(r)

        V = _stack_like(b, m + 1)
        Z = _stack_like(b, m)
        V = _basis_set(V, 0, tscale(jnp.where(beta > 0, 1.0 / beta, 0.0), r))
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)

        def cond(st):
            k, _, _, _, _, _, _, res = st
            return jnp.logical_and(k < m, res > target)

        def body(st):
            k, V, Z, H, cs, sn, g, _ = st
            vk = jax.tree.map(lambda Vl: Vl[k], V)
            z = M(vk)
            Z = _basis_set(Z, k, z)
            w = op(z)

            # CGS(1|2): orthogonalize against V[0..k] in batched passes.
            # One pass suffices for loose inner tolerances (the flexible
            # outer iteration absorbs mild orthogonality loss); two passes
            # give MGS-level stability for tight solves.
            idx = jnp.arange(m + 1)
            mask = (idx <= k).astype(dtype)
            h = jnp.zeros((m + 1,), dtype)
            for _ in range(max(1, cgs_passes)):
                hp = _basis_dots(V, w) * mask
                w = tsub(w, _basis_comb(V, hp))
                h = h + hp

            hk1 = tnorm(w)
            V = _basis_set(V, k + 1, tscale(jnp.where(hk1 > 0, 1.0 / hk1, 0.0), w))

            # New Hessenberg column (entries j<=k plus subdiagonal).
            col = h.at[k + 1].set(hk1)

            # Apply previous Givens rotations to the new column.
            def rot(j, c):
                cj, sj = cs[j], sn[j]
                active = j < k
                a0, a1 = c[j], c[j + 1]
                b0 = jnp.where(active, cj * a0 + sj * a1, a0)
                b1 = jnp.where(active, -sj * a0 + cj * a1, a1)
                return c.at[j].set(b0).at[j + 1].set(b1)

            col = lax.fori_loop(0, m, rot, col)

            # Form the new rotation annihilating col[k+1].
            a0, a1 = col[k], col[k + 1]
            denom = jnp.sqrt(a0 * a0 + a1 * a1)
            ck = jnp.where(denom > 0, a0 / denom, 1.0)
            sk = jnp.where(denom > 0, a1 / denom, 0.0)
            col = col.at[k].set(denom).at[k + 1].set(0.0)
            cs = cs.at[k].set(ck)
            sn = sn.at[k].set(sk)
            gk = g[k]
            g = g.at[k].set(ck * gk).at[k + 1].set(-sk * gk)

            H = H.at[:, k].set(col)
            res = jnp.abs(g[k + 1])
            return k + 1, V, Z, H, cs, sn, g, res

        k0 = jnp.array(0)
        k, V, Z, H, cs, sn, g, res = lax.while_loop(
            cond, body, (k0, V, Z, H, cs, sn, g, beta)
        )

        # Solve the (masked) upper-triangular system for the update.
        idx = jnp.arange(m)
        active = idx < k
        Hm = H[:m, :m] * (active[:, None] & active[None, :])
        Hm = Hm + jnp.diag(jnp.where(active, 0.0, 1.0).astype(dtype))
        gm = jnp.where(active, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, gm, lower=False)
        x = taxpy(1.0, _basis_comb(Z, y), x)
        return x, k, res

    def cond(st):
        _, it, res, prev = st
        progressing = res < stagnation * prev
        return jnp.logical_and(res > target, jnp.logical_and(it < maxiter, progressing))

    def body(st):
        x, it, res, _ = st
        x, k, _ = inner_cycle(x)
        new_res = tnorm(tsub(b, op(x)))  # true residual at restart boundary
        return x, it + k, new_res, res

    r0 = tnorm(tsub(b, op(x0)))
    inf = jnp.asarray(jnp.inf, r0.dtype)
    x, it, res, _ = lax.while_loop(cond, body, (x0, jnp.array(0), r0, inf))
    return x, SolveInfo(it, res, res <= target, bnorm)
