"""Test configuration: run on CPU with 8 virtual devices (so sharding /
halo-exchange logic is testable without several GPUs; SURVEY.md §4) and
float64 enabled (the accuracy bar is 1e-8 relative residual).

The platform is chosen through jax.config, which holds even where JAX was
imported before this file ran.  Nothing here needs a GPU: the run on the
card is `python chip_smoke.py` (README "Running").
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
