"""Mixed-precision iterative refinement.

The accuracy bar is 1e-8 *relative residual* (BASELINE.json), which is
below the float32 roundoff floor at 1024^2 (measured floor ~2e-4
relative).  The classic fix (SURVEY.md §7.3 item 5): keep the hot
Krylov/multigrid path in f32 and wrap it in float64 refinement —

    repeat:  r = b - A x      (one f64 operator application)
             solve A dx ~= r  (full f32 inner solve, tol ~ its floor)
             x <- x + dx      (f64 accumulate)

Each refinement multiplies the residual by ~the inner solve's relative
accuracy (1e-3..1e-4), so 2-4 refinements reach 1e-8.  The f64 operator is
the SAME matrix-free stencil code, just applied to f64-cast inputs, once
per refinement.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from pylamp_tpu.solvers.krylov import SolveInfo, tsub, vdot


def _cast(tree, dtype):
    return jax.tree.map(lambda l: l.astype(dtype), tree)


def _norm_f32(tree):
    """||tree|| accumulated in f32 with overflow-safe pre-scaling.

    The norm only GATES the refinement loop — 1e-7-relative accuracy is
    ample for comparing against tol*||b||.  Momentum entries can reach
    ~1e15 (squares overflow f32), so each leaf is scaled by its own max
    first."""
    f32 = jnp.float32
    leaves = jax.tree.leaves(tree)
    sqs = []
    for l in leaves:
        amax = jnp.max(jnp.abs(l))
        s = jnp.where(amax > 0, amax, 1.0)
        ln = (l * (1.0 / s)).astype(f32)
        sqs.append((vdot(ln, ln).astype(jnp.float64), s))
    total = sum(sq * s * s for sq, s in sqs)
    return jnp.sqrt(total)


def refine(
    op64: Callable,
    inner_solve32: Callable,
    b64: Any,
    x0_64: Any,
    tol: float = 1e-8,
    max_refinements: int = 6,
    inner_tol: float = 1e-4,
):
    """Generic pytree iterative refinement.

    op64: f64 operator; inner_solve32(r32, tol32) -> (dx32, SolveInfo)
    solves A dx = r in f32 from a zero initial guess to the requested
    relative tolerance.  Returns (x64, SolveInfo) where iterations
    accumulates the inner iteration counts.

    The requested inner tolerance is ADAPTIVE: each pass multiplies the
    outer residual by roughly the inner solve's achieved relative
    accuracy, so the last pass only needs to be as tight as
    target/res_current — solving it to the fixed floor instead lands ~3
    orders below target (measured 1e-11 on a 1e-8 sticky-air solve: one
    whole wasted full-depth pass).  ``inner_tol`` is the tightest
    tolerance ever requested (the f32 floor)."""
    bnorm = _norm_f32(b64)
    target = tol * bnorm

    # One f64 operator application per refinement: the residual computed
    # at the top of each iteration doubles as the convergence check for
    # the previous one.  Norms accumulate in f32 (_norm_f32): they only
    # gate the loop.

    def cond(st):
        _, _, res, k, _ = st
        return jnp.logical_and(res > target, k < max_refinements)

    def body(st):
        x, r, res, k, it = st
        rel = jnp.clip(0.3 * target / res, inner_tol, 0.3)
        dx32, info = inner_solve32(_cast(r, jnp.float32), rel.astype(jnp.float32))
        x = jax.tree.map(lambda xl, dl: xl + dl.astype(jnp.float64), x, dx32)
        r = tsub(b64, op64(x))
        return x, r, _norm_f32(r), k + 1, it + info.iterations

    r0 = tsub(b64, op64(x0_64))
    x, _, res, k, it = lax.while_loop(
        cond, body, (x0_64, r0, _norm_f32(r0), jnp.array(0), jnp.array(0))
    )
    return x, SolveInfo(it, res, res <= target, bnorm)
