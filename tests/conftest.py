"""Test configuration: force CPU with a virtual 8-device mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); multi-device sharding
tests use the standard JAX fake-cluster trick. The platform is forced
through ``jax.config`` so it holds even when JAX was imported before this
file. The GPU is exercised by ``chip_smoke.py``, not by these tests.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
