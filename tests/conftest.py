import os

# Tests run on a virtual 8-device CPU mesh.  The platform is set through
# jax.config before any backend initializes, so it holds even where JAX was
# imported (and JAX_PLATFORMS read) before this file runs.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
