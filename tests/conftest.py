import hashlib
import os
import platform
import tempfile


def _host_cache_tag():
    """Machine type plus a hash of the CPU feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next(
                (ln for ln in f if ln.startswith(("flags", "Features"))), "")
    except OSError:  # pragma: no cover
        flags = platform.processor()
    return f"{platform.machine()}-{hashlib.sha1(flags.encode()).hexdigest()[:10]}"


# Tests run on the local CPU backend with a virtual 8-device mesh for the
# sharding tests.  jax may already be imported by a pytest plugin, so the
# platform is also set at runtime below.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# The tests' compile cache stays out of the checkout, in a directory per
# host CPU: XLA:CPU AOT executables built for one machine's feature set can
# SIGILL on another (observed as pytest segfaults after a host swap — the
# loader only warns on a feature mismatch).  Set before the package is
# imported, which reads it.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "penguin_jax_cache", _host_cache_tag()))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.default_backend() == "cpu", (
    "tests must run on the local CPU backend; got " + jax.default_backend()
)


# Accumulating ~170 tests of compiled executables in one process makes a
# subsequent XLA:CPU execution segfault (deterministic at the same suite
# position; RSS/threads/fds all healthy — an XLA:CPU executable-arena
# issue, not a resource limit).  Dropping executables between modules
# keeps the live set small; the persistent compile cache makes the
# reloads cheap.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()
