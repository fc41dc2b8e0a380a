"""The one timing path of the benchmarks and the smoke run.

JAX returns before the device finishes, so every timed call here ends in
``jax.block_until_ready``.  The first call of each shape compiles: callers
warm up first and report that time as set-up, never as a step time.
"""

import subprocess
import time

import jax


def timed(fn, *args):
    """(result, wall seconds) of one ``fn(*args)`` that ends on the device."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def best_seconds(fn, *args, warmup=1, reps=5):
    """Least wall seconds of ``fn(*args)`` over ``reps`` calls, after
    ``warmup`` untimed calls (compilation)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    return min(timed(fn, *args)[1] for _ in range(reps))


def card_info():
    """Name and power limit of each GPU as ``nvidia-smi`` reports them, read
    in a child process so that the caller's JAX state is not involved."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(count=1):
    """The device record (platform, kind and count, as JAX reports them) of
    a machine with at least ``count`` GPUs; stops the process otherwise.
    Device numbers come only from a GPU: there is no CPU fallback."""
    try:
        dev = jax.devices()
    except RuntimeError as e:  # a requested backend failed to start
        raise SystemExit(f"no GPU: JAX found no usable backend ({e})")
    if dev[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found only {dev[0].platform!r} "
                         "devices; this measurement runs on a GPU")
    if len(dev) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(dev)}")
    return {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev)}
