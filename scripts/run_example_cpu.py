"""Run an example script on the local CPU backend (f64, 8 virtual devices).

Usage:  python scripts/run_example_cpu.py examples/1D/poisson.py [args...]

The examples run on whatever backend jax picks by default (the GPU when
there is one); this wrapper forces CPU before jax initializes — handy for
CI and for machines where the GPU is busy.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

path = sys.argv[1]
sys.argv = sys.argv[1:]
glb = {"__name__": "__main__", "__file__": os.path.abspath(path)}
exec(compile(open(path).read(), path, "exec"), glb)
