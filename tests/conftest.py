"""Test harness config: force CPU with 8 virtual devices so sharding tests
exercise a multi-device mesh (standard JAX practice; see SURVEY.md
section 4). The platform is set through jax.config before any backend is
touched, so it holds even where jax was imported earlier in the process."""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
