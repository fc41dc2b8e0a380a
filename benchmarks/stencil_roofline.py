"""Bandwidth of the heat stepper's stencil matvec against the card's.

Times the (2N+1)-point variable-coefficient matvec of ``FastHeatBE``
(``heat_fast._apply_stencil``, which XLA compiles to one elementwise
fusion) at 4096² and 256³ in f32, and a streaming copy that moves the same
bytes, in the same run.  Each is looped n times inside one jitted program
(``lax.fori_loop``, x <- A x / s so the chain stays bounded) and timed by
the host clock around a call that ends in ``block_until_ready``; the time
per iteration is the best call over n.

Traffic model per matvec: 2N+1 coefficient arrays and x read, one array
written, all f32.  Bandwidth is that traffic over the time per iteration;
it is reported as a share of the copy bandwidth measured here and of the
published peak of the device (table below; any other device is an error).

Run:  python benchmarks/stencil_roofline.py      (needs a GPU)
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from benchmarks._timing import best_seconds, card_info, require_gpu
from penguin_tpu.solvers.heat_fast import _apply_stencil

# Published HBM bandwidth, bytes/s, keyed by jax device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part (3.35 TB/s).
PEAK_HBM = {"NVIDIA H100 80GB HBM3": 3.35e12}


def matvec_seconds(shape, n):
    """Seconds per matvec of the (2N+1)-point stencil on ``shape``."""
    ndim = len(shape)
    ks = jax.random.split(jax.random.PRNGKey(0), 2 * ndim + 2)
    arrs = [jax.random.normal(k, shape, jnp.float32) for k in ks]
    coeffs = (arrs[0] + 4.0 * ndim,) + tuple(arrs[1:-1])
    scale = 1.0 + 4.0 * ndim

    @jax.jit
    def loop(coeffs, x0, n):
        return lax.fori_loop(
            0, n, lambda i, x: _apply_stencil(coeffs, x) / scale, x0)

    return best_seconds(loop, coeffs, arrs[-1], n) / n


def copy_seconds(n_elements, n):
    """Seconds per streaming copy (y = x / s) of ``n_elements`` f32."""
    x0 = jnp.ones((n_elements,), jnp.float32)

    @jax.jit
    def loop(x0, n):
        return lax.fori_loop(0, n, lambda i, x: x / 1.0001, x0)

    return best_seconds(loop, x0, n) / n


def measure(shape, n=200):
    """(matvec GB/s, copy GB/s) for one grid shape, in one process."""
    cells = int(np.prod(shape))
    nbytes = (2 * len(shape) + 3) * cells * 4
    t_mv = matvec_seconds(shape, n)
    t_cp = copy_seconds(nbytes // 8, n)  # 4 bytes read + 4 written each
    return nbytes / t_mv / 1e9, nbytes / t_cp / 1e9


def main():
    device = require_gpu()
    card = card_info()
    if device["kind"] not in PEAK_HBM:
        raise SystemExit(f"no published peak for {device['kind']!r}; "
                         "add it to PEAK_HBM with its source")
    peak = PEAK_HBM[device["kind"]] / 1e9
    print(f"{device['kind']} ({card}); published HBM peak {peak} GB/s")
    for shape in [(4096, 4096), (256, 256, 256)]:
        mv, cp = measure(shape)
        name = "x".join(map(str, shape))
        print(f"{name:12s} matvec {mv!r} GB/s ({mv / cp!r} of copy, "
              f"{mv / peak!r} of peak) | copy {cp!r} GB/s "
              f"({cp / peak!r} of peak)")


if __name__ == "__main__":
    main()
