"""pylamp_tpu — a JAX 2-D thermomechanical geodynamics framework.

A from-scratch rebuild of the capabilities of the reference code
``larskaislaniemi/PyLamp`` (a serial numpy/scipy marker-in-cell staggered-grid
Stokes + energy code; see SURVEY.md — the reference mount at /root/reference
was empty this round, so parity targets are the [DRIVER] spec in BASELINE.json
plus community benchmarks: Blankenbach, van Keken RT, Crameri sticky-air).

Architecture (array-first, not a translation):

- ``core``     staggered-grid geometry, boundary conditions, configuration
- ``ops``      matrix-free stencil operators (Stokes saddle-point, energy),
               plain jax.numpy that XLA fuses
- ``solvers``  pytree Krylov (CG/BiCGStab/FGMRES), geometric multigrid,
               pressure-nullspace projection, equation scaling
- ``markers``  marker-in-cell subsystem: seeding, marker<->grid transfer,
               RK4 advection — dense cell-bucketed shifts
               (markers/bucket.py), not random-access loops
- ``physics``  material tables, rheology (isoviscous / Frank-Kamenetskii /
               Arrhenius), buoyancy
- ``parallel`` device-mesh construction and sharding specs: 2-D domain
               decomposition over a jax.sharding.Mesh (XLA inserts the halo
               exchanges / collectives)
- ``models``   the timestep (interp -> Stokes -> dt -> energy -> advect),
               the time-loop driver, and the benchmark model setups
- ``io``       checkpoint/resume, field output, structured metrics logging
"""

__version__ = "0.1.0"

from pylamp_tpu.core.grid import StaggeredGrid  # noqa: F401
