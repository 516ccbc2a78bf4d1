"""DP-analogue batched parameter sweeps (SURVEY.md §2.3 row 1).

The reference is a serial single-model code; the data-parallel
analogue is vmapping the whole model step over a batch of independent
models — e.g. a Rayleigh-number sweep for a convection study.  The grid,
config tree (BCs, solver settings, time control), material COUNT and
viscosity LAWS are shared across the batch; the numeric material
parameters (rho0, alpha, eta0, ...) and the full model state vary per
batch member.

Because batch members are independent, the vmapped step introduces no
cross-member communication: on a device mesh the batch axis can be sharded
(classic data parallelism) by placing the leading axis of the stacked
state/params in a `jax.sharding` spec, on top of the per-model spatial
sharding from parallel/mesh.py.

Note on batched Krylov loops: under vmap a `lax.while_loop` iterates until
EVERY batch member satisfies its convergence test, so already-converged
members keep iterating (their residuals simply keep shrinking).  Batched
results therefore match per-model runs to solver tolerance, not bitwise —
exactly like running each model with a slightly tighter stopping point.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from pylamp_tpu.models.step import make_step
from pylamp_tpu.physics.materials import MaterialTable

# the per-material numeric parameters that may vary across the sweep
NUMERIC_FIELDS = (
    "rho0", "alpha", "T_ref", "eta0", "fk_gamma", "E_act", "k", "cp", "H",
)


def _table_shim(base: MaterialTable, params: dict) -> MaterialTable:
    """A MaterialTable whose numeric fields are (possibly traced) arrays.

    MaterialTable's methods only ever do jnp.asarray(field)[mat_id], so an
    instance with tracer-valued fields works unchanged inside jit/vmap."""
    shim = object.__new__(MaterialTable)
    shim.materials = base.materials
    shim.law = base.law
    shim._uniform_law = base._uniform_law
    for f in NUMERIC_FIELDS:
        setattr(shim, f, params[f])
    return shim


def stack_tables(tables: Sequence[MaterialTable]) -> dict:
    """Stack per-model material tables into a dict of (B, n_materials)
    arrays (the sweep's vmapped parameter pytree)."""
    base = tables[0]
    for t in tables[1:]:
        if len(t) != len(base):
            raise ValueError("all sweep members must have the same number of materials")
        if list(t.law) != list(base.law):
            raise ValueError("all sweep members must share the same viscosity laws")
    return {
        f: jnp.stack([jnp.asarray(getattr(t, f)) for t in tables])
        for f in NUMERIC_FIELDS
    }


def stack_states(states):
    """Stack per-model ModelState pytrees along a new leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def unstack_state(batched, i: int):
    """Extract member i of a batched state."""
    return jax.tree.map(lambda x: x[i], batched)


def make_sweep_step(grid, cfg, tables: Sequence[MaterialTable]):
    """Build (batched_step, stacked_params).

    batched_step(state_batch, params) -> (state_batch, diag_batch) advances
    every sweep member one step; `params` is the stacked pytree returned
    alongside (pass it through unchanged each call, or modify it to steer
    the sweep).  Shapes: every state leaf and diag value gains a leading
    batch axis of size len(tables)."""
    base = tables[0]
    params = stack_tables(tables)

    def one(state, p):
        step = make_step(grid, cfg, _table_shim(base, p))
        return step(state)

    return jax.jit(jax.vmap(one, in_axes=(0, 0))), params
