"""Material tables and marker rheology.

The reference's markers carry material id plus physical properties (density,
viscosity, conductivity, heat capacity, ...; SURVEY.md §2.1 "Marker (tracer)
subsystem").  Here properties are *derived*: markers carry (material id, T)
and a MaterialTable maps id -> parameters; density and viscosity are
evaluated on markers each step (temperature- and material-dependent), then
interpolated to the grid.  This keeps the marker state minimal and the
evaluation a pure vectorized gather -> VPU-friendly.

Viscosity laws (SURVEY.md §2.1 / BASELINE.json configs):
- "constant":            eta = eta0
- "frank_kamenetskii":   eta = eta0 * exp(-fk_gamma * T')   (T' = (T-T0)/dT)
- "arrhenius":           eta = eta0 * exp(E/(R T) - E/(R T_ref))

Density: Boussinesq linear expansion rho = rho0 * (1 - alpha (T - T_ref)).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

R_GAS = 8.314462618  # J / (mol K)

CONSTANT = "constant"
FRANK_KAMENETSKII = "frank_kamenetskii"
ARRHENIUS = "arrhenius"


@dataclasses.dataclass(frozen=True)
class Material:
    """One material's parameters (SI or non-dimensional, caller's choice)."""

    name: str = "mat"
    rho0: float = 3300.0
    alpha: float = 0.0  # thermal expansivity [1/K]
    T_ref: float = 0.0  # reference T for density/viscosity laws
    eta0: float = 1e21
    viscosity: str = CONSTANT
    fk_gamma: float = 0.0  # Frank-Kamenetskii exponent (per unit T)
    E_act: float = 0.0  # Arrhenius activation energy [J/mol]
    k: float = 3.0  # conductivity
    cp: float = 1000.0  # heat capacity
    H: float = 0.0  # internal heating per volume [W/m^3]


class MaterialTable:
    """Stacked per-material parameter arrays for vectorized id->param gather."""

    def __init__(self, materials: Sequence[Material]):
        self.materials = tuple(materials)
        get = lambda f: np.array([getattr(m, f) for m in materials])
        self.rho0 = get("rho0")
        self.alpha = get("alpha")
        self.T_ref = get("T_ref")
        self.eta0 = get("eta0")
        self.fk_gamma = get("fk_gamma")
        self.E_act = get("E_act")
        self.k = get("k")
        self.cp = get("cp")
        self.H = get("H")
        kinds = sorted({m.viscosity for m in materials})
        for kk in kinds:
            if kk not in (CONSTANT, FRANK_KAMENETSKII, ARRHENIUS):
                raise ValueError(f"unknown viscosity law {kk!r}")
        self._uniform_law = kinds[0] if len(kinds) == 1 else None
        # Per-material law flags for mixed-law tables (evaluate all laws,
        # select by id — branch-free, VPU-friendly).
        law_code = {CONSTANT: 0, FRANK_KAMENETSKII: 1, ARRHENIUS: 2}
        self.law = np.array([law_code[m.viscosity] for m in materials])

    def __len__(self):
        return len(self.materials)

    def _select(self, vals, mat_id, dtype):
        """id -> per-material value WITHOUT a gather.

        With a handful of materials a chain of elementwise selects fuses
        into the consumer with no per-marker memory indirection; uniform
        columns (including the 1-material case) collapse to a broadcast
        constant at trace time.

        Falls back to traced-select when ``vals`` is a traced array (the
        parameter-sweep shim, models/sweep.py stacks table columns and
        vmaps over them).
        """
        if isinstance(vals, np.ndarray):
            v = vals
            out = jnp.full(mat_id.shape, float(v[0]), dtype)
            for m in range(1, len(v)):
                if v[m] != v[0]:
                    out = jnp.where(mat_id == m, jnp.asarray(v[m], dtype), out)
            return out
        vals = jnp.asarray(vals, dtype)
        out = jnp.broadcast_to(vals[0], mat_id.shape)
        for m in range(1, vals.shape[0]):
            out = jnp.where(mat_id == m, vals[m], out)
        return out

    # -- vectorized marker property evaluation ---------------------------
    def density(self, mat_id, T):
        rho0 = self._select(self.rho0, mat_id, T.dtype)
        alpha = self._select(self.alpha, mat_id, T.dtype)
        T_ref = self._select(self.T_ref, mat_id, T.dtype)
        return rho0 * (1.0 - alpha * (T - T_ref))

    def viscosity_of(self, mat_id, T):
        eta0 = self._select(self.eta0, mat_id, T.dtype)
        T_ref = self._select(self.T_ref, mat_id, T.dtype)

        # Law codes are always static (laws are not sweepable); evaluate
        # only the law branches that are actually present in the table.
        present = set(int(c) for c in self.law)
        eta = eta0
        if 1 in present:  # Frank-Kamenetskii
            gamma = self._select(self.fk_gamma, mat_id, T.dtype)
            eta_fk = eta0 * jnp.exp(-gamma * (T - T_ref))
            law = self._select(self.law, mat_id, jnp.int32)
            eta = jnp.where(law == 1, eta_fk, eta)
        if 2 in present:  # Arrhenius; guard T<=0 (evaluated everywhere)
            E = self._select(self.E_act, mat_id, T.dtype)
            T_safe = jnp.maximum(T, 1e-30)
            Tr_safe = jnp.maximum(T_ref, 1e-30)
            eta_arr = eta0 * jnp.exp(E / (R_GAS * T_safe) - E / (R_GAS * Tr_safe))
            law = self._select(self.law, mat_id, jnp.int32)
            eta = jnp.where(law == 2, eta_arr, eta)
        return eta

    def conductivity(self, mat_id, dtype):
        return self._select(self.k, mat_id, dtype)

    def rho_cp(self, mat_id, T):
        # Boussinesq: thermal mass uses the reference density rho0 (the
        # T-dependence of rho enters the buoyancy term only).
        rho0 = self._select(self.rho0, mat_id, T.dtype)
        cp = self._select(self.cp, mat_id, T.dtype)
        return rho0 * cp

    def heating(self, mat_id, dtype):
        return self._select(self.H, mat_id, dtype)
