"""Device mesh + sharding specs: 2-D domain decomposition.

The reference is strictly serial (SURVEY.md §2.3); the scaling strategy
here is spatial domain decomposition over a jax.sharding.Mesh:

- grid fields (vx, vy, p, T, eta_*) are sharded ("y", "x") — each device
  owns a rectangular subdomain; XLA/GSPMD inserts the halo exchanges for
  the stencils (collective-permutes between devices) and the psums for
  Krylov dot products — this is the stencil-code analogue of TP/SP
- markers are sharded along the marker axis over ALL devices (the DP
  analogue); marker->grid scatters psum partial grids, grid->marker gathers
  all-gather the (small) velocity fields
- scalars (time, dt, Krylov scalars) are replicated

The same jitted step function runs single-chip or sharded: only the
in_shardings differ.
"""
from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor2(n: int):
    """Near-square factorization n = a*b with a >= b."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """2-D ("y", "x") mesh over the first n devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    a, b = _factor2(len(devices))
    dev_grid = np.asarray(devices).reshape(a, b)
    return Mesh(dev_grid, axis_names=("y", "x"))


def state_shardings(mesh: Mesh, state):
    """NamedShardings for a ModelState pytree: 2-D leaves domain-decomposed,
    1-D (marker) leaves sharded over all devices, scalars replicated.

    Staggered sub-grids have node counts like nx+1 that are not divisible
    by the mesh axes; jit/device_put boundaries require divisibility, so a
    dim is only sharded when it divides evenly — GSPMD propagates the full
    (possibly uneven) decomposition to every intermediate inside the jitted
    step, where unevenness IS supported."""
    ysize = mesh.shape["y"]
    xsize = mesh.shape["x"]
    nall = ysize * xsize

    def spec_for(leaf):
        if leaf.ndim == 3:  # bucketed markers: (ny, nx, K)
            sy = "y" if leaf.shape[0] % ysize == 0 else None
            sx = "x" if leaf.shape[1] % xsize == 0 else None
            return NamedSharding(mesh, P(sy, sx, None))
        if leaf.ndim == 2:
            sy = "y" if leaf.shape[0] % ysize == 0 else None
            sx = "x" if leaf.shape[1] % xsize == 0 else None
            return NamedSharding(mesh, P(sy, sx))
        if leaf.ndim == 1:
            if leaf.shape[0] % nall == 0:
                return NamedSharding(mesh, P(("y", "x")))
            return NamedSharding(mesh, P(None))
        return NamedSharding(mesh, P())

    return jax.tree.map(spec_for, state)


def shard_state(state, mesh: Mesh):
    return jax.device_put(state, state_shardings(mesh, state))
