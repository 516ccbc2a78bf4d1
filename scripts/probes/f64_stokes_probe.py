"""Time the f64 saddle apply vs the f32 applies at 1024^2, and count
refinement passes in a production-like solve."""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), "..", ".."))

import time

import jax

jax.config.update("jax_enable_x64", True)
from pylamp_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import jax.numpy as jnp
import numpy as np

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.ops.stokes import stokes_operator
from pylamp_tpu.solvers.scaling import characteristic_viscosity, stokes_scales

nx = ny = 1024
grid = StaggeredGrid(nx, ny, 1.0, 1.0)
bcs = VelocityBCs()
rng = np.random.default_rng(0)

eta_n32 = jnp.asarray(10.0 ** (4.0 * rng.random((ny, nx))), jnp.float32)
eta_s32 = jnp.asarray(10.0 ** (4.0 * rng.random((ny + 1, nx + 1))), jnp.float32)
eta_n64, eta_s64 = eta_n32.astype(jnp.float64), eta_s32.astype(jnp.float64)
eta_char = characteristic_viscosity(eta_n64)
kcont, kbnd = stokes_scales(eta_char, grid)

u32 = (jnp.asarray(rng.standard_normal(grid.shape_vx), jnp.float32),
       jnp.asarray(rng.standard_normal(grid.shape_vy), jnp.float32),
       jnp.asarray(rng.standard_normal(grid.shape_center), jnp.float32))
u64 = jax.tree.map(lambda l: l.astype(jnp.float64), u32)


@jax.jit
def apply64(u):
    return stokes_operator(u[0], u[1], u[2], eta_s64, eta_n64, grid, bcs,
                           kcont=kcont, kbnd=kbnd)


@jax.jit
def apply32(u):
    return stokes_operator(u[0], u[1], u[2], eta_s32, eta_n32, grid, bcs,
                           kcont=kcont.astype(jnp.float32),
                           kbnd=kbnd.astype(jnp.float32))


def bench(fn, u, n=20):
    out = fn(u)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(u)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


t64 = bench(apply64, u64)
t32 = bench(apply32, u32)
print(f"op64 apply: {t64*1e3:.2f} ms   op32 apply: {t32*1e3:.2f} ms   "
      f"ratio {t64/t32:.1f}x")
